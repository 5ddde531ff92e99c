"""Analytic FLOP/byte model per (arch x shape): the roofline's numerator
(the port of ``repro/launch/analytic.py``).

MODEL_FLOPS is 6·N·D for training (2·N·D for a forward pass) plus the
exact attention terms; bytes are the least HBM traffic a step must move.
Parameter counts come from the port's model built on the meta device
(every arch of the registry).  A MoE model's active parameters
leave out, per MoE layer, the routed experts beyond the top k.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import model as M


def param_counts(cfg: ArchConfig):
    """(total_params, active_params) — active excludes non-routed experts."""
    lm = M.init_params(cfg, device="meta")
    total = sum(p.numel() for p in lm.parameters())
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        expert_params = 3 * cfg.d_model * m.expert_d_ff
        n_moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        active = total - n_moe_layers * (m.num_experts - m.top_k) \
            * expert_params
    return total, active


def _attn_layers(cfg: ArchConfig):
    full, windowed = 0, 0
    for spec in M.layer_plan(cfg):
        if spec.kind in ("attn", "mla", "shared_attn"):
            if spec.window:
                windowed += 1
            else:
                full += 1
    return full, windowed


def model_flops(cfg: ArchConfig, shape: InputShape):
    """Returns dict with matmul + attention FLOPs for the shape's mode."""
    B, S = shape.global_batch, shape.seq_len
    total, active = param_counts(cfg)
    full_l, win_l = _attn_layers(cfg)
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    w = cfg.sliding_window or 0

    if shape.mode == "train":
        tokens = B * S
        mat = 6 * active * tokens
        # causal attention: 2 matmuls * (S^2/2) * H * hd, fwd+bwd = x3
        attn = full_l * 3 * 2 * 2 * B * (S * S / 2) * H * hd
        attn += win_l * 3 * 2 * 2 * B * S * min(w, S) * H * hd
    elif shape.mode == "prefill":
        tokens = B * S
        mat = 2 * active * tokens
        attn = full_l * 2 * 2 * B * (S * S / 2) * H * hd
        attn += win_l * 2 * 2 * B * S * min(w, S) * H * hd
    else:  # decode: ONE token against a cache of S
        tokens = B
        mat = 2 * active * tokens
        attn = full_l * 2 * 2 * B * S * H * hd
        attn += win_l * 2 * 2 * B * min(w, S) * H * hd

    return {"params_total": total, "params_active": active,
            "matmul_flops": float(mat), "attention_flops": float(attn),
            "model_flops": float(mat + attn), "tokens": tokens}


def model_bytes(cfg: ArchConfig, shape: InputShape, *, opt_bytes=8,
                param_bytes=2):
    """Minimum HBM traffic per step: params read (+opt state r/w for train)
    + KV cache traffic for decode."""
    total, active = param_counts(cfg)
    if shape.mode == "train":
        # fwd+bwd params read twice + grad write + opt m/v read+write
        b = total * (2 * param_bytes + param_bytes + 2 * opt_bytes)
    elif shape.mode == "prefill":
        b = total * param_bytes
    else:
        b = active * param_bytes
        # KV cache read per decode step (SSM states are not counted); MLA
        # reads its compressed latent and rope key
        for spec in M.layer_plan(cfg):
            if spec.kind in ("attn", "shared_attn"):
                T = min(spec.window or shape.seq_len, shape.seq_len)
                b += (2 * shape.global_batch * T * cfg.num_kv_heads
                      * cfg.resolved_head_dim * param_bytes)
            elif spec.kind == "mla":
                b += (shape.global_batch * shape.seq_len
                      * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
                      * param_bytes)
    return float(b)
