"""SGD, momentum and AdamW as plain functions over trees of tensors (the
port of ``repro/optim/optimizers.py``; no ``torch.optim``).

Trees are those of :mod:`repro_torch.tree`.  State is a plain dict, as in
the reference:
  adamw: {"m": tree, "v": tree, "count": int32 scalar}
  sgd: {"count": ...};  momentum: {"m": tree, "count": ...}
``m`` and ``v`` are float32 whatever the parameters' type; every update
computes in float32, in the reference's order of operations, and casts
the new parameters back to their own type.  Updates return new tensors
and leave their inputs as they were, except ``adamw_update_``, the train
step's, which writes the same numbers in place.  ``count`` stays a tensor
on the parameters' device, so an update never waits for the device.
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


def _adamw_leaf(p, g, m, v, *, bc1, bc2, lr, b1, b2, eps, weight_decay,
                decay):
    gf = g.to(torch.float32)
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    mh = m_new / bc1
    vh = v_new / bc2
    step = mh / (torch.sqrt(vh) + eps)
    if decay:                                # decoupled decay on matrices only
        step = step + weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * step).to(p.dtype), m_new, v_new


def adamw_update(params, grads, state, *, lr=1e-4, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    count = state["count"] + 1
    cf = count.to(torch.float32)
    hp = dict(bc1=1.0 - b1 ** cf, bc2=1.0 - b2 ** cf, lr=lr, b1=b1, b2=b2,
              eps=eps, weight_decay=weight_decay)

    def upd(p, g, m, v):
        return _adamw_leaf(p, g, m, v, decay=p.dim() >= 2, **hp)

    new_p, new_m, new_v = _update(upd, 3, params, grads, state["m"],
                                  state["v"])
    return new_p, {"m": new_m, "v": new_v, "count": count}


#: elements of one slice of :func:`adamw_update_`: its float32
#: transients are a few times 256 MiB whatever the size of the leaf
ADAMW_SLICE = 2 ** 26


def _local(x):
    """A DTensor's local shard (a view of its storage); a tensor itself."""
    to_local = getattr(x, "to_local", None)
    return x if to_local is None else to_local()


def adamw_update_(params, grads, state, *, lr=1e-4, b1=0.9, b2=0.95,
                  eps=1e-8, weight_decay=0.1):
    """:func:`adamw_update`'s arithmetic written in place into ``params``
    and the moments, leaf by leaf in slices of ``ADAMW_SLICE`` elements,
    so that the update never holds a second copy of the moments or more
    than one slice's transients (at 4.25 B parameters the new moments of
    :func:`adamw_update` alone take 34 GB).  Returns the new state: the
    same ``m`` and ``v``, ``count`` + 1.  ``params``, ``m`` and ``v``
    leaves must be contiguous.  A DTensor leaf is updated shard by shard,
    its gradient first laid out as the parameter (the moments mirror the
    parameters' layout)."""
    count = state["count"] + 1
    cf = _local(count).to(torch.float32)
    hp = dict(bc1=1.0 - b1 ** cf, bc2=1.0 - b2 ** cf, lr=lr, b1=b1, b2=b2,
              eps=eps, weight_decay=weight_decay)
    with torch.no_grad():
        for p, g, m, v in zip(*(flatten(t)[0] for t in (
                params, grads, state["m"], state["v"]))):
            decay = p.dim() >= 2
            placements = getattr(p, "placements", None)
            if placements is not None and g.placements != placements:
                g = g.redistribute(p.device_mesh, placements)
            dst = [_local(x).view(-1) for x in (p, m, v)]
            g = _local(g).reshape(-1)
            for i in range(0, g.numel(), ADAMW_SLICE):
                sl = slice(i, i + ADAMW_SLICE)
                out = _adamw_leaf(*(x[sl] for x in (dst[0], g, dst[1],
                                                    dst[2])),
                                  decay=decay, **hp)
                for x, y in zip(dst, out):
                    x[sl].copy_(y)
    return {"m": state["m"], "v": state["v"], "count": count}


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
