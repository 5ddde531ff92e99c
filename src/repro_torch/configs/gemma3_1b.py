"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window attention, 128k ctx (local window 512).
[hf:google/gemma-3-1b-pt]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    attention="gqa",
    rope_theta=1_000_000.0,
    sliding_window=1024,
    global_every=6,               # 5 local : 1 global
    mlp_kind="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    max_seq_len=131072,
    source="hf:google/gemma-3-1b-pt",
)
