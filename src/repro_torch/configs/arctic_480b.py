"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual MLP.  [hf:Snowflake/snowflake-arctic-base]"""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,                    # dense-residual MLP width
    vocab_size=32000,
    attention="gqa",
    rope_theta=10000.0,
    mlp_kind="swiglu",
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        expert_d_ff=4864,
        dense_residual_d_ff=4864,   # arctic's dense + MoE parallel structure
        capacity_factor=1.25,
    ),
    norm="rmsnorm",
    max_seq_len=4096,
    source="hf:Snowflake/snowflake-arctic-base",
)
