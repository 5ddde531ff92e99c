"""Architecture + input-shape config system (the port's own copy of
``repro/configs/base.py``; the port imports nothing of the reference).

Every assigned architecture is expressed as an ``ArchConfig`` — a frozen
dataclass rich enough to describe dense, MoE, SSM, hybrid, VLM-backbone and
audio enc-dec families.  ``reduced()`` gives a CPU-runnable variant of the
same family for the tests; the port's models also run at full size on
the GPU (``python -m repro_torch.launch.serve --no-reduced``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for a block."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0       # deepseek-style always-on experts
    shared_d_ff: int = 0
    dense_residual_d_ff: int = 0      # arctic-style parallel dense MLP
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention settings."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / xLSTM settings."""

    kind: str = "mamba2"              # "mamba2" | "mlstm" | "slstm"
    state_dim: int = 64               # N (mamba2) / head memory (mlstm)
    expand: int = 2                   # inner = expand * d_model
    conv_width: int = 4
    num_heads: int = 0                # 0 -> derive from inner/64 (mamba2)
    chunk_size: int = 128             # chunked parallel scan block


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # --- attention flavor ---
    attention: str = "gqa"            # gqa | mla | mha
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_kind: str = "standard"       # standard | mrope
    mrope_sections: Sequence[int] = (16, 24, 24)   # t/h/w split of head_dim/2
    sliding_window: int = 0           # 0 -> full attention everywhere
    global_every: int = 0             # gemma3: 1 global layer per N (N=6 -> 5:1)
    # --- ffn ---
    mlp_kind: str = "swiglu"          # swiglu | gelu
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    moe_every: int = 1                # apply MoE to every Nth layer
    moe_skip_first: int = 0           # deepseek: first layer dense
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    # layer_pattern: per-layer block kind; empty -> homogeneous family default.
    # entries: "attn" | "mamba2" | "mlstm" | "slstm" | "shared_attn"
    layer_pattern: Sequence[str] = ()
    shared_attn_every: int = 0        # zamba2: shared attn block period
    # --- enc-dec (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 0              # frames after the (stubbed) conv frontend
    cross_attention: bool = False
    # --- vlm ---
    vision_tokens: int = 0            # patches provided by stubbed frontend
    # --- norms / embeddings ---
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    source: str = ""                  # citation bracket from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def block_kind(self, layer_idx: int) -> str:
        """Which block occupies layer ``layer_idx``."""
        if self.layer_pattern:
            return self.layer_pattern[layer_idx % len(self.layer_pattern)]
        if self.family == "ssm" and self.ssm is not None:
            return self.ssm.kind
        return "attn"

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if layer_idx < self.moe_skip_first:
            return False
        return (layer_idx - self.moe_skip_first) % self.moe_every == 0

    def is_global_attn_layer(self, layer_idx: int) -> bool:
        """For local:global interleave (gemma3): True -> full attention."""
        if self.sliding_window == 0:
            return True
        if self.global_every == 0:
            return False
        return (layer_idx + 1) % self.global_every == 0

    def reduced(self) -> "ArchConfig":
        """CPU-runnable smoke variant of the same family (prompt rules:
        ≤2 layers, d_model ≤ 512, ≤4 experts)."""
        d_model = min(self.d_model, 256)
        num_heads = max(2, min(self.num_heads, 4))
        ratio = max(1, self.num_heads // max(1, self.num_kv_heads))
        num_kv = max(1, num_heads // min(ratio, num_heads))
        head_dim = max(32, d_model // num_heads)
        changes = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=512,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            global_every=min(self.global_every, 2) if self.global_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            vision_tokens=min(self.vision_tokens, 16),
            dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=min(self.moe.expert_d_ff, 256),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                shared_d_ff=min(self.moe.shared_d_ff, 256),
                dense_residual_d_ff=min(self.moe.dense_residual_d_ff, 256),
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm,
                state_dim=min(self.ssm.state_dim, 16),
                chunk_size=32,
            )
        if self.rope_kind == "mrope":
            # rescale t/h/w frequency-slot split to the reduced head_dim
            tot = sum(self.mrope_sections)
            half = head_dim // 2
            secs = [max(1, s * half // tot) for s in self.mrope_sections]
            secs[0] += half - sum(secs)
            changes["mrope_sections"] = tuple(secs)
        if self.attention == "mla":
            changes["mla"] = MLAConfig(
                kv_lora_rank=64, q_lora_rank=96,
                qk_nope_head_dim=head_dim, qk_rope_head_dim=32,
                v_head_dim=head_dim)
        if self.shared_attn_every:
            changes["shared_attn_every"] = 2
        if self.layer_pattern:
            # keep the family mix visible in 2 layers
            changes["layer_pattern"] = tuple(self.layer_pattern[:2]) \
                if len(set(self.layer_pattern[:2])) > 1 \
                else (self.layer_pattern[0], self.layer_pattern[-1])
        return dataclasses.replace(self, **changes)

    mla: Optional[MLAConfig] = None


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                         # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
