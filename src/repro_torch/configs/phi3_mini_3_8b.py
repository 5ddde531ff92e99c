"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064, RoPE + SwiGLU.  [arXiv:2404.14219]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    attention="gqa",
    rope_theta=10000.0,
    mlp_kind="swiglu",
    norm="rmsnorm",
    max_seq_len=131072,
    source="arXiv:2404.14219",
)
