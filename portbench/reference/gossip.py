"""ECD-PSGD's exchange (Tang et al. 2018, Alg. 4) for R replicas stacked on
a leading axis, leaf by leaf in flattening order, as the JAX package's
``local_step`` lays it out:

  keys     k = fold_in(fold_in(key(17), step), r) for replica r;
           leaf j draws its first noise from split(k, n)[j] and its
           second from split(fold_in(k, 1), n)[j]
  C(v)     stochastic rounding of each replica's leaf to ``bits``-bit
           integers at one scale per replica, max|v| / qmax:
           floor(v / scale + u) clipped to [-qmax - 1, qmax], times scale
  x_half   the ring average of C(y): (C(y)_r + C(y)_{r-1} + C(y)_{r+1}) / 3
  x        x_half - lr g                       (g: replica r's gradient)
  z        (1 - t/2) x_old + (t/2) x,   t = step + 2
  y        (1 - 2/t) y + (2/t) C(z)

Weights and ``y`` keep their stored type: C(y) and the ring average are
rounded to it, as are the new x and y; the rest is float32.
"""

from __future__ import annotations

import torch

from . import threefry as TF
from .trees import leaves


def compress(rows, u, bits):
    """C(.) of each row of ``rows`` (r, n) float32 with noise ``u``."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = rows.abs().amax(1).clamp_min(1e-12) / torch.tensor(
        qmax, device=rows.device)
    q = torch.floor(rows / scale[:, None] + u).clamp(-qmax - 1.0, qmax)
    return q * scale[:, None]


def _ring(v):
    tot = v.float() + torch.roll(v, 1, 0).float()
    tot = tot + torch.roll(v, -1, 0).float()
    return (tot / torch.tensor(3.0, device=v.device)).to(v.dtype)


def _keys(step, R, n, dev):
    """Each replica's two keys of each of ``n`` leaves: (R, n, 2) twice."""
    k = TF.fold_in(TF.fold_in(TF.key(17, dev), step),
                   torch.arange(R, device=dev))
    return TF.split(k, n), TF.split(TF.fold_in(k, 1), n)


def pulled(y, j, n, step, traffic, ring=True):
    """x_half of leaf ``j`` of ``n`` at ``step``: the ring average of C(y)
    for ``y`` (R, ...), rounded to y's type."""
    R = y.shape[0]
    ka, _ = _keys(step, R, n, y.device)
    cy = compress(y.float().reshape(R, -1), TF.uniform(ka[:, j], y[0].numel()),
                  traffic["bits"]).reshape(y.shape).to(y.dtype)
    return _ring(cy) if ring else cy


def exchange(xs, ys, grads, step, traffic, ring=True):
    """One exchange in place on ``xs`` and ``ys`` (leaves (R, ...)) with
    ``grads`` (one float32 tree per replica); ``ring=False`` takes each
    replica's own C(y) for the ring average (the exchange left out)."""
    R, bits, lr = traffic["replicas"], traffic["bits"], traffic["lr"]
    x_l, y_l = leaves(xs), leaves(ys)
    _, kb = _keys(step, R, len(x_l), x_l[0][1].device)
    g_l = [leaves(g) for g in grads]
    t = torch.tensor(step + 2.0, dtype=torch.float32,
                     device=x_l[0][1].device)
    with torch.no_grad():
        for j, ((_, x), (_, y)) in enumerate(zip(x_l, y_l)):
            n = x[0].numel()
            g = torch.stack([gl[j][1] for gl in g_l])
            xh = pulled(y, j, len(x_l), step, traffic, ring)
            xn = (xh.float() - lr * g).to(x.dtype)
            z = (1.0 - t / 2.0) * x.float() + (t / 2.0) * xn.float()
            cz = compress(z.reshape(R, n), TF.uniform(kb[:, j], n),
                          bits).reshape(z.shape)
            yn = ((1.0 - 2.0 / t) * y.float() + (2.0 / t) * cz).to(y.dtype)
            x.copy_(xn)
            y.copy_(yn)
