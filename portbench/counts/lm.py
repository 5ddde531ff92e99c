"""Model FLOPs of one training token of the ``lm`` kind
(:mod:`portbench.reference.lm`), term by term, from a configuration
file's sizes.

A matrix product of a (T, k) by a (k, n) costs 2 T k n in the forward pass
and twice that in the backward pass, so each weight matrix applied to a
token costs 6 k n a token; a layer applied at several depths (zamba2's
shared block) is counted at each.  Causal attention costs, per token and
head, 2 hd for the scores and 2 hd for the weighted sum against the S/2
keys it sees on average, forward; Mamba2's sequence sum, in its chunked
form with chunk L, costs per token the causal half of the chunk's C.B
products and of its weighted sum (L N + H L hd), the chunk state and the
inter-chunk output (2 H hd N each); both three times for forward and
backward.  The depthwise convolution is 2 W channels a token, forward.
Not counted: the input embedding (a lookup), norms, activations, the
softmax, and any recomputation (per-layer checkpointing runs the forward
pass twice; model FLOPs count it once).
"""

from __future__ import annotations

from portbench.reference import lm


def terms(cfg, seq: int) -> dict:
    """FLOPs per token by term, forward and backward."""
    d, ff, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], lm.head_dim(cfg)
    kinds = lm.layer_kinds(cfg)
    out = {"lm_head": 6 * d * V}
    attn_proj = 2 * d * H * hd + 2 * d * KV * hd
    attn_core = 2 * 2 * (seq / 2) * H * hd * 3
    mlp = 3 * d * ff
    n_attn = kinds.count("attn")
    n_shared = kinds.count("shared_attn")
    n_mamba = kinds.count("mamba2")
    if n_attn:
        out["attn_proj"] = 6 * attn_proj * n_attn
        out["attention"] = attn_core * n_attn
        out["mlp"] = 6 * mlp * n_attn
    if n_shared:
        out["shared_concat"] = 6 * 2 * d * d * n_shared
        out["shared_attn_proj"] = 6 * attn_proj * n_shared
        out["shared_attention"] = attn_core * n_shared
        out["shared_mlp"] = 6 * mlp * n_shared
        out["shared_down"] = 6 * d * d * n_shared
    if n_mamba:
        inner, Hm, hdm, N, W = lm.mamba_dims(cfg)
        L = cfg["ssm"]["chunk_size"]
        out["mamba_in_proj"] = 6 * d * (2 * inner + 2 * N + Hm) * n_mamba
        out["mamba_out_proj"] = 6 * inner * d * n_mamba
        out["mamba_conv"] = 3 * 2 * W * (inner + 2 * N) * n_mamba
        out["mamba_ssd"] = 3 * (L * N + Hm * L * hdm
                                + 4 * Hm * hdm * N) * n_mamba
    return out
