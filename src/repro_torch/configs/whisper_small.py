"""whisper-small [audio] — enc-dec, 12L each, d_model=768 12H d_ff=3072
vocab=51865.  Conv/mel frontend is the stated stub: input_specs() provides
precomputed frame embeddings (batch, 1500, 768).  [arXiv:2212.04356]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,                # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    attention="gqa",              # MHA (kv == heads)
    rope_theta=0.0,               # whisper uses learned absolute positions
    mlp_kind="gelu",
    norm="layernorm",
    encoder_layers=12,
    encoder_seq=1500,
    cross_attention=True,
    # real whisper caps at 448; the positional table is extended so the
    # assigned train_4k/decode_32k shapes lower (shape exercise — DESIGN.md §4)
    max_seq_len=4096,
    source="arXiv:2212.04356",
)
