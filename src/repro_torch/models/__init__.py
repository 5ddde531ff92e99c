"""repro_torch.models — the dense attention LM stack: ``layers`` (norms,
MLPs, RoPE, embeddings), ``attention`` (GQA with sliding windows, KV
caches) and ``model`` (``CausalLM``, prefill and decode)."""
