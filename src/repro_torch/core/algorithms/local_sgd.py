"""Local SGD / EASGD under the PCA: per-worker models, periodic averaging
(port of ``repro/core/algorithms/local_sgd.py``).

Each of the m workers keeps its own replica and takes one local SGD step
per server iteration on its own sample; every ``sync_every``-th
iteration the replicas are pulled toward their live-worker average:

    x_i <- x_i - gamma g_i(x_i)                      every iteration
    x_i <- x_i + averaging (x_bar - x_i)             when (t+1) % H == 0

``averaging=1.0`` is plain local SGD, ``< 1`` the EASGD elastic pull.
The iteration index is a host integer here, so the sync boundary is a
host-side branch.  Theory-side bound: `repro_torch.analysis.fit.
local_sgd_mmax` (predictor kind ``"local_sgd"``).

Masking: the replica bank is ``(B, m_pad, d)``; padded rows step on
their own draws, but the sync average and the readout reduce through
``ctx.active``, so no padded value reaches a live row.
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
class LocalSgd(Algorithm):
    """m model replicas, one local point-gradient step each per server
    iteration, masked-mean synchronization every ``sync_every`` steps.

    ``fault`` (`repro_torch.resilience.faults.FaultSpec` or dict):
    corruption rewrites a worker's local gradient; drop, straggle and
    duplicate act on the sync messages (an absent replica weighs 0 in the
    average and is not pulled toward it, a duplicated one weighs 2).  The
    event stream is ``(iters, m_top)``, sliced per bucket like the sample
    draws; zero-rate specs are bit-exact with ``fault=None``."""

    name: ClassVar[str] = "local_sgd"
    bucketed_default: ClassVar[bool] = True      # replica bank is O(m_pad d)
    predictor: ClassVar[str] = "local_sgd"

    gamma: float = 0.1
    sync_every: int = 4
    averaging: float = 1.0      # 1.0 = local SGD, <1 = EASGD elastic pull
    fault: Optional[faults.FaultSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "fault", faults.resolve(self.fault))

    def make_draws(self, key, n, iters, m_top, d):
        idx = R.randint(key, (iters, m_top), 0, n)
        if self.fault is None:
            return idx
        return {"i": idx, **faults.make_stream(self.fault, (iters, m_top),
                                               key.device)}

    def init_state(self, problem, data, ctx: SimContext):
        return torch.zeros(ctx.m.shape[0], ctx.m_pad, data.X.shape[1],
                           device=data.X.device)

    def step(self, problem, data, ctx: SimContext, xs, batch, t):
        idx = batch if self.fault is None else batch["i"]
        gs = problem.point_grad(xs, data.X[idx], data.y[idx])
        if self.fault is not None:
            gs = faults.corrupt(self.fault, gs, batch["corrupt"])
        xs = xs - self.gamma * gs
        if (t + 1) % self.sync_every != 0:
            return xs
        if self.fault is None:
            weight, present = ctx.active, None
            total = ctx.mf
        else:
            # a straggler's message is as lost as a dropped one; an
            # all-absent sync degrades to weight 1 (exact identity
            # otherwise: the live count is integer-valued)
            absent = torch.maximum(batch["drop"], batch["straggle"])
            present = 1.0 - absent
            weight = ctx.active * present * (1.0 + batch["dup"])
            total = torch.clamp_min(weight.sum(dim=1), 1.0)
        avg = torch.einsum("bm,bmd->bd", weight, xs) / total[:, None]
        pull = avg[:, None, :] - xs
        if present is not None:
            # absent workers never saw the average
            pull = present[..., None] * pull
        return xs + self.averaging * pull

    def readout(self, ctx: SimContext, xs):
        return torch.einsum("bm,bmd->bd", ctx.active, xs) / ctx.mf[:, None]
