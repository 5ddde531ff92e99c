"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA (kv_lora=512),
expert d_ff=1536, 2 shared + 160 routed experts top-6, vocab=102400.
[arXiv:2405.04434]"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,             # MLA: per-head KV decompressed from latent
    head_dim=128,
    d_ff=12288,                   # the dense first layer's MLP width
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    rope_theta=10000.0,
    mlp_kind="swiglu",
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        expert_d_ff=1536,
        num_shared_experts=2,
        shared_d_ff=3072,         # 2 shared experts x 1536
        capacity_factor=1.25,
    ),
    moe_skip_first=1,             # first layer dense (deepseek recipe)
    norm="rmsnorm",
    max_seq_len=131072,
    source="arXiv:2405.04434",
)
