"""ECD-PSGD (Alg 4) — decentralized SGD with extrapolation-compression
(port of ``repro/core/algorithms/ecd_psgd.py``).

m workers on a ring (W = I/3 + ring neighbours/3), each holding its own
model x^(i) and exchanging compressed intermediate variables y^(i).  The
compression C(.) is stochastic quantization with one scale per worker.
After the mixing product and the gradients, the rest of a step — the
x update, the extrapolation z, C(z) on all members' worker rows
``(B * m_pad, d)`` and the y update — is one call of
``kernels.quantize.ecd_compress_rows``: one kernel launch on the card,
its plain version on the CPU.  The noise for
worker w at iteration t is ``uniform(split(fold_in(k_q, t), m_top)[w])``,
the reference's per-(iteration, worker) keys, drawn for the whole run in
``make_draws``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch import random as R
from repro_torch.kernels import quantize as kq
from repro_torch.core.algorithms.base import (Algorithm, SimContext,
                                              register_algorithm)


def ring_matrix(m, m_pad: int):
    """Batched W: for each member's live count m (a (B,) tensor),
    W[i] = (e_i + e_{i-1 mod m} + e_{i+1 mod m}) / 3 for i < m and
    identity rows for padded workers.  Shape (B, m_pad, m_pad)."""
    ids = torch.arange(m_pad, device=m.device)
    eye = torch.eye(m_pad, device=m.device)
    mm = m[:, None]
    W = (eye + eye[(ids - 1) % mm] + eye[(ids + 1) % mm]) / 3.0
    return torch.where((ids[None, :] < mm)[..., None], W, eye)


@register_algorithm
@dataclasses.dataclass(frozen=True)
class EcdPsgd(Algorithm):
    """The ring becomes a masked ``(m_pad, m_pad)`` mixing matrix per
    member (identity rows for padding), built once in ``init_state``."""

    name: ClassVar[str] = "ecd_psgd"
    bucketed_default: ClassVar[bool] = True  # quantization work is O(m_pad)

    gamma: float = 0.1
    compress_bits: int = 8

    def make_draws(self, key, n, iters, m_top, d):
        k_order, k_q = R.split(key)
        order = R.randint(k_order, (iters, m_top), 0, n)
        ts = torch.arange(iters, device=key.device)
        wkeys = R.split(R.fold_in(k_q, ts), m_top)    # (iters, m_top, 2)
        return {"order": order, "u": R.uniform(wkeys, (d,))}

    def init_state(self, problem, data, ctx: SimContext):
        ctx.W = ring_matrix(ctx.m, ctx.m_pad)
        shape = (ctx.m.shape[0], ctx.m_pad, data.X.shape[1])
        return (torch.zeros(shape, device=data.X.device),
                torch.zeros(shape, device=data.X.device))

    def step(self, problem, data, ctx: SimContext, state, batch, t):
        xs, ys = state                       # (B, m_pad, d) models / y-vars
        idx, u = batch["order"], batch["u"]
        x_half = torch.bmm(ctx.W, ys)        # neighbours pull compressed y
        grads = problem.point_grad(xs, data.X[idx], data.y[idx])
        B, m_pad, d = xs.shape
        x_new, y_new = kq.ecd_compress_rows(
            *(a.reshape(B * m_pad, d) for a in (grads, x_half, xs, ys, u)),
            self.gamma, t, self.compress_bits)
        return (x_new.reshape(B, m_pad, d), y_new.reshape(B, m_pad, d))

    def readout(self, ctx: SimContext, state):
        # mean over live workers
        return torch.einsum("bm,bmd->bd", ctx.active, state[0]) \
            / ctx.mf[:, None]
