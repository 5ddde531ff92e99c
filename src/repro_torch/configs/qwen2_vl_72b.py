"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE, dynamic resolution (vision frontend stubbed; the
backbone consumes precomputed patch embeddings).  [arXiv:2409.12191]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    mlp_kind="swiglu",
    norm="rmsnorm",
    vision_tokens=1024,           # stub frontend supplies this many patch embeds
    max_seq_len=32768,
    source="arXiv:2409.12191",
)
