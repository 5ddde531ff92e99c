"""Mixture-of-Experts block: top-k routing with capacity-factor dispatch,
optional shared experts (DeepSeek-V2) and a parallel dense residual MLP
(Arctic); the port of ``repro/models/moe.py``.

Dispatch bookkeeping (one-hot cumsum -> position in expert) is computed
per batch row, as in the reference.  Rows reach their experts by gather
and come back by gather and a gated sum (bytes, not one-hot products).
Ties between router probabilities go to the lower expert, as
``jax.lax.top_k`` breaks them: a stable descending sort picks the top k.
A dropped assignment writes a sentinel slot ``E * cap`` that is cut off;
only that slot is ever written twice, so no result depends on the order
of duplicate writes.  The router's load-balance loss follows
Switch/GShard; the per-expert dispatch entropy is exported as the
paper's diversity proxy.  Expert products are batched matrix products
over the stacked experts; there is no kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _dense_init, apply_mlp, init_mlp


def init_moe(gen, cfg: ArchConfig, dtype, device):
    m = cfg.moe
    d = cfg.d_model
    stacked = (m.num_experts, d, m.expert_d_ff)
    p = {
        "router": _dense_init(gen, (d, m.num_experts), torch.float32, device),
        # experts stacked on axis 0: (E, d, ff) / (E, ff, d)
        "wi_gate": _dense_init(gen, stacked, dtype, device, stacked=True),
        "wi_up": _dense_init(gen, stacked, dtype, device, stacked=True),
        "wo": _dense_init(gen, (m.num_experts, m.expert_d_ff, d), dtype,
                          device, stacked=True),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d, m.shared_d_ff, "swiglu", dtype, device)
    if m.dense_residual_d_ff:
        p["dense_residual"] = init_mlp(gen, d, m.dense_residual_d_ff,
                                       "swiglu", dtype, device)
    return p


def top_k(probs, k):
    """(values, indices) of the k largest along the last axis, largest
    first, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(p, cfg: ArchConfig, x, dropless=False):
    """x: (B, S, d) -> (y, aux) where aux has load-balance loss + diversity.

    ``dropless=True`` sizes capacity so no token is ever dropped — used for
    decode, where a 1-token batch must not lose its expert assignment.
    """
    m = cfg.moe
    B, S, d = x.shape
    E = m.num_experts
    k = m.top_k

    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)                         # (B,S,E)
    gate_vals, top_idx = top_k(probs, k)                          # (B,S,k)
    gate_vals = gate_vals / (torch.sum(gate_vals, -1, keepdim=True) + 1e-9)

    # --- per-row dispatch bookkeeping --------------------------------------
    cap = (S if dropless
           else max(1, int(m.capacity_factor * S * k / E)))
    flat_e = top_idx.reshape(B, S * k)                            # (B, Sk)
    onehot = F.one_hot(flat_e, E)                                 # (B,Sk,E)
    pos_in_e = torch.sum((torch.cumsum(onehot, dim=1) - 1) * onehot, dim=-1)
    keep = pos_in_e < cap
    gate_vals = gate_vals * keep.reshape(B, S, k)

    dest = torch.where(keep, flat_e * cap + pos_in_e, E * cap)    # (B,Sk)
    tok_ids = torch.arange(S, device=x.device).repeat_interleave(k)
    token_for_slot = torch.zeros((B, E * cap + 1), dtype=torch.int64,
                                 device=x.device).scatter_(
        1, dest, tok_ids.expand(B, S * k))
    filled = torch.zeros((B, E * cap + 1), dtype=torch.bool,
                         device=x.device).scatter_(
        1, dest, torch.ones_like(dest, dtype=torch.bool))

    # --- gather rows -> (B, E, cap, d) expert buffers ----------------------
    xe = torch.gather(x, 1, token_for_slot[:, :E * cap, None].expand(
        B, E * cap, d))
    xe = xe * filled[:, :E * cap, None].to(x.dtype)
    xe = xe.reshape(B, E, cap, d)

    # --- expert compute: one batched product per weight over the experts --
    xe = xe.transpose(0, 1).reshape(E, B * cap, d)
    g = torch.bmm(xe, p["wi_gate"])
    u = torch.bmm(xe, p["wi_up"])
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    ye = torch.bmm(h, p["wo"]).reshape(E, B, cap, d).transpose(0, 1)

    # --- combine: per-row gather back + gated sum ---------------------------
    ye_flat = torch.cat([ye.reshape(B, E * cap, d),
                         torch.zeros((B, 1, d), dtype=ye.dtype,
                                     device=x.device)], dim=1)
    contrib = torch.gather(ye_flat, 1, dest[..., None].expand(B, S * k, d))
    contrib = contrib * gate_vals.reshape(B, S * k, 1).to(ye.dtype)
    y = torch.sum(contrib.reshape(B, S, k, d), dim=2)

    if m.num_shared_experts:
        y = y + apply_mlp(p["shared"], x, "swiglu")
    if m.dense_residual_d_ff:
        y = y + apply_mlp(p["dense_residual"], x, "swiglu")

    # aux: Switch load-balance loss + dispatch entropy (diversity proxy)
    frac_tokens = torch.mean(F.one_hot(top_idx[..., 0], E).to(torch.float32),
                             dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    entropy = -torch.sum(frac_probs * torch.log(frac_probs + 1e-9))
    aux = {"load_balance_loss": lb_loss,
           "dispatch_entropy": entropy,
           "expert_fraction": frac_probs}
    return y, aux
