"""Mini-batch SGD (Alg 2) under the PCA (port of
``repro/core/algorithms/minibatch.py``).

One worker computes one sample's gradient per server iteration and the
server averages the m of them: the degree of parallelism is the batch
size (Fact 1).  The x-axis is server iterations.
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
class Minibatch(Algorithm):
    """m parallel one-sample gradients averaged by the server each step."""

    name: ClassVar[str] = "minibatch"
    bucketed_default: ClassVar[bool] = True      # work is O(m_pad * d)/step

    gamma: float = 0.1

    def make_draws(self, key, n, iters, m_top, d):
        return R.randint(key, (iters, m_top), 0, n)

    def init_state(self, problem, data, ctx: SimContext):
        return torch.zeros(ctx.m.shape[0], data.X.shape[1],
                           device=data.X.device)

    def step(self, problem, data, ctx: SimContext, x, idx, t):
        g = problem.masked_batch_grad(x, data.X[idx], data.y[idx],
                                      ctx.active, ctx.mf)
        return x - self.gamma * g

    def readout(self, ctx: SimContext, x):
        return x
