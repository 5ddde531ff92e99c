"""xlstm-350m [ssm] — 24L d_model=1024 4 heads, sLSTM + mLSTM blocks
(xLSTM[7:1] mix), vocab=50304.  [arXiv:2405.04517]"""

from repro_torch.configs.base import ArchConfig, SSMConfig

# 7 mLSTM : 1 sLSTM per the xLSTM[7:1] recipe
_PATTERN = ("mlstm",) * 7 + ("slstm",)

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                       # blocks carry their own projections
    vocab_size=50304,
    ssm=SSMConfig(kind="mlstm", state_dim=64, expand=2, conv_width=4,
                  num_heads=4, chunk_size=128),
    layer_pattern=_PATTERN,
    norm="layernorm",
    max_seq_len=1_048_576,        # recurrent: unbounded in principle
    source="arXiv:2405.04517",
)
