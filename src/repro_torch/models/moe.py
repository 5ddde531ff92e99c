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
paper's diversity proxy.  On a mesh the experts are split over 'model'
(:func:`_moe_mesh`).  Expert products are batched matrix products
over the stacked experts; there is no kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import local as DL
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
    On a mesh (a DTensor ``x``) see :func:`_moe_mesh`.
    """
    if DL.is_dtensor(x):
        return _moe_mesh(p, cfg, x, dropless)
    y, probs, top_idx = _routed(p, cfg, x, dropless)
    if cfg.moe.num_shared_experts:
        y = y + apply_mlp(p["shared"], x, "swiglu")
    if cfg.moe.dense_residual_d_ff:
        y = y + apply_mlp(p["dense_residual"], x, "swiglu")
    E = cfg.moe.num_experts
    frac_tokens = torch.mean(F.one_hot(top_idx[..., 0], E).to(torch.float32),
                             dim=(0, 1))
    frac_probs = torch.mean(probs, dim=(0, 1))
    return y, _aux(E, frac_tokens, frac_probs)


def _aux(E, frac_tokens, frac_probs):
    """Switch load-balance loss + dispatch entropy (diversity proxy)."""
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    entropy = -torch.sum(frac_probs * torch.log(frac_probs + 1e-9))
    return {"load_balance_loss": lb_loss,
            "dispatch_entropy": entropy,
            "expert_fraction": frac_probs}


def _moe_mesh(p, cfg: ArchConfig, x, dropless):
    """Expert-parallel MoE on a mesh: tokens batch-sharded over the data
    axes and gathered over 'model'; each 'model' rank routes every token
    (the router gathered), runs its own E / model experts (their d
    dimension gathered over the data axes) and contributes a partial sum
    over 'model'.  Everything the region returns is a partial sum over
    'model' (what the ranks compute alike, the router statistics and,
    when E does not split over 'model', the experts' output, comes from
    'model' rank 0 alone), so the gradients of its inputs are partial
    sums over 'model' too.  The router statistics are local means summed
    over the data axes.  Shared and dense-residual MLPs and the aux terms
    are DTensor arithmetic."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, names = x.device_mesh, tuple(x.device_mesh.mesh_dim_names)
    E = cfg.moe.num_experts
    mi = names.index("model") if "model" in names else None
    n_model = mesh.shape[mi] if mi is not None else 1
    ep = n_model > 1 and E % n_model == 0
    lead = 1.0 if mi is None or mesh.get_local_rank(mi) == 0 else 0.0
    act_pl = DL.batch_placements(mesh, x.shape, 0)
    rep = (Replicate(),) * mesh.ndim

    def partial_on_model(pl):
        return tuple(Partial() if i == mi else q for i, q in enumerate(pl))

    e_pl = tuple(Shard(0) if ep and i == mi else Replicate()
                 for i in range(mesh.ndim))
    w = {k: p[k].redistribute(mesh, e_pl).to_local(
        grad_placements=DL.grad_placements(e_pl, act_pl))
        for k in ("wi_gate", "wi_up", "wo")}
    w["router"] = DL.replicate(p["router"]).to_local(
        grad_placements=partial_on_model(DL.grad_placements(rep, act_pl)))
    xl = x.redistribute(mesh, act_pl).to_local(
        grad_placements=partial_on_model(act_pl))
    n_e = w["wi_gate"].shape[0]
    e_lo = mesh.get_local_rank(mi) * n_e if ep else 0
    y, probs, top_idx = _routed(w, cfg, xl, dropless, e_lo, e_lo + n_e)
    y = DTensor.from_local(y if ep else y * lead, mesh,
                           partial_on_model(act_pl), run_check=False)
    if cfg.moe.num_shared_experts:
        y = y + apply_mlp(p["shared"], x, "swiglu")
    if cfg.moe.dense_residual_d_ff:
        y = y + apply_mlp(p["dense_residual"], x, "swiglu")
    n_data = 1
    for i, q in enumerate(act_pl):
        if isinstance(q, Shard):
            n_data *= mesh.shape[i]
    sum_pl = partial_on_model(tuple(
        Partial() if isinstance(q, Shard) else Replicate() for q in act_pl))

    def global_mean(t):
        return DTensor.from_local(torch.mean(t, dim=(0, 1)) * (lead / n_data),
                                  mesh, sum_pl, run_check=False)

    frac_tokens = global_mean(F.one_hot(top_idx[..., 0], E).to(
        torch.float32))
    return y, _aux(E, frac_tokens, global_mean(probs))


def _routed(p, cfg: ArchConfig, x, dropless, e_lo=0, e_hi=None):
    """The routed experts' output (B, S, d), the router probabilities and
    the top-k expert ids.  ``p``'s expert banks hold experts
    ``[e_lo, e_hi)`` (default: all); the others contribute nothing."""
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
    if e_hi is None or (e_lo, e_hi) == (0, E):
        ye = _experts(p, xe, x.dtype)
    else:
        ye = torch.zeros_like(xe)
        ye[:, e_lo:e_hi] = _experts(p, xe[:, e_lo:e_hi], x.dtype)

    # --- combine: per-row gather back + gated sum ---------------------------
    ye_flat = torch.cat([ye.reshape(B, E * cap, d),
                         torch.zeros((B, 1, d), dtype=ye.dtype,
                                     device=x.device)], dim=1)
    contrib = torch.gather(ye_flat, 1, dest[..., None].expand(B, S * k, d))
    contrib = contrib * gate_vals.reshape(B, S * k, 1).to(ye.dtype)
    y = torch.sum(contrib.reshape(B, S, k, d), dim=2)
    return y, probs, top_idx


def _experts(p, xe, dtype):
    """(B, E', cap, d) expert buffers through the E' experts of ``p``'s
    banks."""
    B, n_e, cap, d = xe.shape
    xe = xe.transpose(0, 1).reshape(n_e, B * cap, d)
    g = torch.bmm(xe, p["wi_gate"])
    u = torch.bmm(xe, p["wi_up"])
    h = F.silu(g.to(torch.float32)).to(dtype) * u
    return torch.bmm(h, p["wo"]).reshape(n_e, B, cap, d).transpose(0, 1)
