"""DADM (Alg 3) — Distributed Alternating Dual Maximization, i.e.
mini-batched distributed SDCA (port of ``repro/core/algorithms/dadm.py``).

Each of m workers takes one SDCA coordinate step for each sample of its
local mini-batch; the server all-gathers Delta v = (1/(lambda n)) sum
xi_i Delta alpha_i and broadcasts.  Primal: x = v.  The loss-specific
pieces come from the Problem's dual hooks.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch import random as R
from repro_torch.core.algorithms.base import (Algorithm, SimContext,
                                              register_algorithm)


@register_algorithm
@dataclasses.dataclass(frozen=True)
class Dadm(Algorithm):
    """The dual all-gather is a masked sum over the padded worker axis;
    padded workers' dual increments are zeroed so they neither move
    ``alpha`` nor contribute to ``v``.  ``bucketed_default`` is False: the
    dual state is ``(n,)``-sized per member and m-independent."""

    name: ClassVar[str] = "dadm"
    bucketed_default: ClassVar[bool] = False
    predictor: ClassVar[str] = "dadm"

    local_batch: int = 8

    def make_draws(self, key, n, iters, m_top, d):
        return R.randint(key, (iters, m_top, self.local_batch), 0, n)

    def init_state(self, problem, data, ctx: SimContext):
        X, y = data.X, data.y
        n = X.shape[0]
        ctx.sdca_step = problem.sdca_stepfactor((X * X).sum(dim=1), n)
        B = ctx.m.shape[0]
        alpha0 = torch.full((B, n), problem.dual_init(), device=X.device)
        v0 = (y * alpha0) @ X / (problem.lam * n)
        return (alpha0, v0)

    def step(self, problem, data, ctx: SimContext, state, idx, t):
        X, y = data.X, data.y
        n = X.shape[0]
        alpha, v = state                     # (B, n), (B, d)
        B = idx.shape[0]
        Xi = X[idx]                          # (B, m_pad, lb, d)
        z = torch.einsum("bmld,bd->bml", Xi, v)
        ai = alpha[ctx.rows[:, None, None], idx]
        da = problem.sdca_delta(z, y[idx], ai, ctx.sdca_step[idx])
        dv = torch.einsum("bml,bmld->bmd", y[idx] * da, Xi) \
            / (problem.lam * n)
        # padded workers sit out; unbounded duals damp the concurrent
        # increments (1.0 for the paper's logistic dual)
        damp = problem.sdca_damping(ctx.mf * self.local_batch)
        da = da * (ctx.active * damp[:, None])[..., None]
        dv = dv * damp[:, None, None]
        alpha = alpha.scatter_add(1, idx.reshape(B, -1), da.reshape(B, -1))
        v = v + torch.einsum("bm,bmd->bd", ctx.active, dv)
        return (alpha, v)

    def readout(self, ctx: SimContext, state):
        return state[1]
