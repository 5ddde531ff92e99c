"""Hogwild! (Alg 1) under the Perfect Computer Assumption (port of
``repro/core/algorithms/hogwild.py``).

The lock-free race is simulated deterministically: the gradient applied
at server iteration j was computed against the model of iteration
j - tau, with tau = (j % m) + 1 cycling over [1, m] (Thm 1).  Each member
keeps an ``(m_pad, d)`` history of past models and indexes it modulo its
own m, so the read ``hist[(j - tau) % m]`` is a per-member gather and
rows >= m are never read or written.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from repro_torch import random as R
from repro_torch.core.algorithms.base import (Algorithm, SimContext,
                                              register_algorithm)
from repro_torch.resilience import faults


@register_algorithm
@dataclasses.dataclass(frozen=True)
class Hogwild(Algorithm):
    """The staleness recurrence over the padded history.  The sample
    sequence is m-independent and the work is O(d) per step whatever the
    pad width, so the grid always runs flat (``force_flat``).

    ``fault`` (a `repro_torch.resilience.faults.FaultSpec` or its dict
    form) injects update-delivery faults: a straggle event deepens the
    staleness (``tau + straggle_rounds``, clamped to the m-deep history),
    drop and duplicate scale the landing gradient by 0 and 2, corruption
    rewrites it, all from an ``(iters,)`` event stream drawn from the
    fault seed.  Zero-rate specs are bit-exact with ``fault=None``."""

    name: ClassVar[str] = "hogwild"
    asynchronous: ClassVar[bool] = True      # cost divides iters by m
    bucketed_default: ClassVar[bool] = False
    force_flat: ClassVar[bool] = True
    predictor: ClassVar[str] = "hogwild"

    gamma: float = 0.1
    fault: Optional[faults.FaultSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "fault", faults.resolve(self.fault))

    def make_draws(self, key, n, iters, m_top, d):
        order = R.randint(key, (iters,), 0, n)
        if self.fault is None:
            return order
        # the fault stream is keyed from the fault seed: every seed
        # replicate faces the same schedule
        return {"i": order, **faults.make_stream(self.fault, (iters,),
                                                 key.device)}

    def init_state(self, problem, data, ctx: SimContext):
        B, d = ctx.m.shape[0], data.X.shape[1]
        dev = data.X.device
        return (torch.zeros(B, d, device=dev),
                torch.zeros(B, ctx.m_pad, d, device=dev))

    def step(self, problem, data, ctx: SimContext, state, batch, j):
        x, hist = state
        i = batch if self.fault is None else batch["i"]
        # stale model: the one from j - tau, tau = (j % m) + 1 (Thm 1)
        tau = j % ctx.m + 1
        if self.fault is not None:
            # a straggler read extra rounds staler, within the m-deep
            # history (no change when the event did not fire)
            tau = torch.minimum(
                tau + faults.extra_staleness(self.fault, batch), ctx.m)
        x_stale = hist[ctx.rows, (j - tau) % ctx.m]
        g = problem.point_grad(x_stale, data.X[i], data.y[i])
        if self.fault is not None:
            g = faults.corrupt(self.fault, g, batch["corrupt"])
            g = faults.delivery_scale(batch)[:, None] * g
        x_new = x - self.gamma * g
        hist[ctx.rows, j % ctx.m] = x_new       # in place: hist is ours
        return (x_new, hist)

    def readout(self, ctx: SimContext, state):
        return state[0]
