"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, GQA + QKV bias.  long_500k is served through the sliding-window
variant flag (window 4096) — see DESIGN.md.  [hf:Qwen/Qwen2.5-0.5B]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    norm="rmsnorm",
    max_seq_len=32768,
    source="hf:Qwen/Qwen2.5-0.5B",
)

import dataclasses as _dc

# long_500k opt-in: same arch with a sliding window (block-sparse variant)
SLIDING_VARIANT = _dc.replace(
    CONFIG, name="qwen2.5-3b-swa", sliding_window=4096, global_every=0)
