"""SGD, momentum and AdamW as plain functions over trees of tensors (the
port of ``repro/optim/optimizers.py``; no ``torch.optim``).

Trees are those of :mod:`repro_torch.tree`.  State is a plain dict, as in
the reference:
  adamw: {"m": tree, "v": tree, "count": int32 scalar}
  sgd: {"count": ...};  momentum: {"m": tree, "count": ...}
``m`` and ``v`` are float32 whatever the parameters' type; every update
computes in float32, in the reference's order of operations, and casts
the new parameters back to their own type.  Updates return new tensors
and leave their inputs as they were.  ``count`` stays a tensor on the
parameters' device, so an update never waits for the device.
"""

from __future__ import annotations

import torch

from repro_torch.tree import flatten, tree_map


def _zeros_like_f32(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _count0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=flatten(params)[0][0].device)


def _update(upd, n_out, params, *trees):
    """``upd`` leaf by leaf over ``params`` and ``trees``; its ``n_out``
    results come back as ``n_out`` trees of ``params``' structure."""
    leaves, rebuild = flatten(params)
    out = [upd(*xs) for xs in zip(leaves, *(flatten(t)[0] for t in trees))]
    return tuple(rebuild([o[i] for o in out]) for i in range(n_out))


# --- AdamW ------------------------------------------------------------------

def adamw_init(params):
    return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params),
            "count": _count0(params)}


def adamw_update(params, grads, state, *, lr=1e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    count = state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - b1 ** cf
    bc2 = 1.0 - b2 ** cf

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        mh = m_new / bc1
        vh = v_new / bc2
        step = mh / (torch.sqrt(vh) + eps)
        if p.dim() >= 2:                     # decoupled decay on matrices only
            step = step + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m_new, v_new

    new_p, new_m, new_v = _update(upd, 3, params, grads, state["m"],
                                  state["v"])
    return new_p, {"m": new_m, "v": new_v, "count": count}


# --- SGD / momentum ----------------------------------------------------------

def sgd_init(params):
    return {"count": _count0(params)}


def sgd_update(params, grads, state, *, lr=0.1, weight_decay=0.0):
    def upd(p, g):
        gf = g.to(torch.float32) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * gf).to(p.dtype)

    return tree_map(upd, params, grads), {"count": state["count"] + 1}


def momentum_init(params):
    return {"m": _zeros_like_f32(params), "count": _count0(params)}


def momentum_update(params, grads, state, *, lr=0.1, beta=0.9,
                    weight_decay=0.0):
    def upd(p, g, m):
        gf = g.to(torch.float32) + weight_decay * p.to(torch.float32)
        m_new = beta * m + gf
        return (p.to(torch.float32) - lr * m_new).to(p.dtype), m_new

    new_p, new_m = _update(upd, 2, params, grads, state["m"])
    return new_p, {"m": new_m, "count": state["count"] + 1}
