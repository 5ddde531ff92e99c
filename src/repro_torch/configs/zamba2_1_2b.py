"""zamba2-1.2b [hybrid] — 38L d_model=2048, Mamba2 backbone + shared
attention blocks (32H kv=32), d_ff=8192, ssm_state=64, vocab=32000.
[arXiv:2411.15242]"""

from repro_torch.configs.base import ArchConfig, SSMConfig

# Mamba2 backbone with a (shared-weight) attention block every 6 layers.
_PATTERN = ("mamba2",) * 5 + ("shared_attn",)

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,                    # shared block's MLP width
    vocab_size=32000,
    attention="gqa",
    ssm=SSMConfig(kind="mamba2", state_dim=64, expand=2, conv_width=4,
                  chunk_size=128),
    layer_pattern=_PATTERN,
    shared_attn_every=6,
    norm="rmsnorm",
    max_seq_len=1_048_576,
    source="arXiv:2411.15242",
)
