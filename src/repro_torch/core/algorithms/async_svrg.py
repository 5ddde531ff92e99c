"""Asynchronous SVRG: Hogwild!'s staleness over semi-stochastic gradients
(port of ``repro/core/algorithms/async_svrg.py``).

The staleness recurrence of `hogwild.py` (the gradient applied at server
iteration j was computed at j - tau, tau cycling over [1, m]), with the
worker evaluating the SVRG semi-stochastic gradient (Zhang et al., arXiv
1508.01633)

    v_j = grad f_i(x_stale) - grad f_i(x_anchor) + mu,
    mu  = full gradient at x_anchor,

the anchor and mu refreshed from the current model every
``anchor_every`` server iterations (a host-side branch: the iteration
index is a host integer).  Theory-side bound: `repro_torch.analysis.fit.
svrg_mmax` (predictor kind ``"svrg"``).  Padding-safe like Hogwild!.
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
class AsyncSvrg(Algorithm):
    """Staleness recurrence over SVRG semi-stochastic gradients with a
    periodic full-gradient anchor; one model per member, so the grid runs
    flat."""

    name: ClassVar[str] = "async_svrg"
    asynchronous: ClassVar[bool] = True      # cost divides iters by m
    bucketed_default: ClassVar[bool] = False
    force_flat: ClassVar[bool] = True        # single-model recurrence
    predictor: ClassVar[str] = "svrg"

    gamma: float = 0.1
    anchor_every: int = 100

    def make_draws(self, key, n, iters, m_top, d):
        # one shared server sample sequence, m-independent (as Hogwild!)
        return R.randint(key, (iters,), 0, n)

    def init_state(self, problem, data, ctx: SimContext):
        B, d = ctx.m.shape[0], data.X.shape[1]
        x0 = torch.zeros(B, d, device=data.X.device)
        mu0 = problem.batch_grad(x0, data.X, data.y)
        # (model, stale-model history, anchor, full gradient at anchor)
        return (x0, torch.zeros(B, ctx.m_pad, d, device=data.X.device),
                x0, mu0)

    def step(self, problem, data, ctx: SimContext, state, i, j):
        x, hist, anchor, mu = state
        tau = j % ctx.m + 1
        x_stale = hist[ctx.rows, (j - tau) % ctx.m]
        Xi, yi = data.X[i], data.y[i]
        v = (problem.point_grad(x_stale, Xi, yi)
             - problem.point_grad(anchor, Xi, yi) + mu)
        x_new = x - self.gamma * v
        hist[ctx.rows, j % ctx.m] = x_new       # in place: hist is ours
        if (j + 1) % self.anchor_every == 0:
            anchor, mu = x_new, problem.batch_grad(x_new, data.X, data.y)
        return (x_new, hist, anchor, mu)

    def readout(self, ctx: SimContext, state):
        return state[0]
