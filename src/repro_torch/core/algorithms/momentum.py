"""Momentum mini-batch SGD, heavy-ball or Nesterov, under the PCA (port of
``repro/core/algorithms/momentum.py``).

The parallelization of Alg 2 (m one-sample worker gradients averaged by
the server each iteration), applied through a momentum buffer:

    heavy-ball:  v_{t+1} = beta v_t - gamma g(x_t);   x_{t+1} = x_t + v_{t+1}
    Nesterov:    v_{t+1} = beta v_t - gamma g(x_t + beta v_t)

The buffer averages about 1/(1-beta) past gradients, so the variance
gain of a larger batch saturates earlier: the theory-side bound is
`repro_torch.analysis.fit.momentum_mmax` (predictor kind ``"momentum"``).
The effective step is gamma / (1 - beta), declared as ``gamma_scale``.
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
class Momentum(Algorithm):
    """m parallel one-sample gradients averaged by the server, applied
    through a heavy-ball (or Nesterov) momentum buffer each step."""

    name: ClassVar[str] = "momentum"
    bucketed_default: ClassVar[bool] = True      # work is O(m_pad * d)/step
    predictor: ClassVar[str] = "momentum"
    #: effective step is gamma/(1-beta): generic harnesses scale gamma by this
    gamma_scale: ClassVar[float] = 0.1

    gamma: float = 0.01
    beta: float = 0.9
    nesterov: bool = False

    def make_draws(self, key, n, iters, m_top, d):
        # Minibatch's layout: member m reads the first m worker columns
        return R.randint(key, (iters, m_top), 0, n)

    def init_state(self, problem, data, ctx: SimContext):
        shape = (ctx.m.shape[0], data.X.shape[1])
        return (torch.zeros(shape, device=data.X.device),     # model
                torch.zeros(shape, device=data.X.device))     # velocity

    def step(self, problem, data, ctx: SimContext, state, idx, t):
        x, v = state
        x_eval = x + self.beta * v if self.nesterov else x
        g = problem.masked_batch_grad(x_eval, data.X[idx], data.y[idx],
                                      ctx.active, ctx.mf)
        v_new = self.beta * v - self.gamma * g
        return (x + v_new, v_new)

    def readout(self, ctx: SimContext, state):
        return state[0]
