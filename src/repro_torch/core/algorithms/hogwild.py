"""Hogwild! (Alg 1) under the Perfect Computer Assumption (port of
``repro/core/algorithms/hogwild.py``, without the fault axis).

The lock-free race is simulated deterministically: the gradient applied
at server iteration j was computed against the model of iteration
j - tau, with tau = (j % m) + 1 cycling over [1, m] (Thm 1).  Each member
keeps an ``(m_pad, d)`` history of past models and indexes it modulo its
own m, so the read ``hist[(j - tau) % m]`` is a per-member gather and
rows >= m are never read or written.
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
class Hogwild(Algorithm):
    """The staleness recurrence over the padded history.  The sample
    sequence is m-independent and the work is O(d) per step whatever the
    pad width, so the grid always runs flat (``force_flat``)."""

    name: ClassVar[str] = "hogwild"
    asynchronous: ClassVar[bool] = True      # cost divides iters by m
    bucketed_default: ClassVar[bool] = False
    force_flat: ClassVar[bool] = True
    predictor: ClassVar[str] = "hogwild"

    gamma: float = 0.1

    def make_draws(self, key, n, iters, m_top, d):
        return R.randint(key, (iters,), 0, n)

    def init_state(self, problem, data, ctx: SimContext):
        B, d = ctx.m.shape[0], data.X.shape[1]
        dev = data.X.device
        return (torch.zeros(B, d, device=dev),
                torch.zeros(B, ctx.m_pad, d, device=dev))

    def step(self, problem, data, ctx: SimContext, state, i, j):
        x, hist = state
        # stale model: the one from j - tau, tau = (j % m) + 1 (Thm 1)
        tau = j % ctx.m + 1
        x_stale = hist[ctx.rows, (j - tau) % ctx.m]
        g = problem.point_grad(x_stale, data.X[i], data.y[i])
        x_new = x - self.gamma * g
        hist[ctx.rows, j % ctx.m] = x_new       # in place: hist is ours
        return (x_new, hist)

    def readout(self, ctx: SimContext, state):
        return state[0]
