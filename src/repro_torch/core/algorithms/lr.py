"""The paper's model: L2-regularized logistic regression (Eq. 4), port of
``repro/core/algorithms/lr.py``.

  argmin_x (1/n) sum_i Phi(label_i * xi_i . x) + (lambda/2) ||x||^2,
  Phi(t) = log(1 + exp(-t)),  lambda = 0.01.

The engine-facing objective is `repro_torch.core.problems.
LogisticRegression`, which delegates here.  Model vectors may carry
leading batch dimensions: ``x`` of shape ``(..., d)``.
"""

from __future__ import annotations

import torch

LAMBDA = 0.01


def _logaddexp0(t):
    return torch.logaddexp(torch.zeros_like(t), t)


def logloss_point(x, xi, yi):
    t = yi * (xi * x).sum(dim=-1)
    return _logaddexp0(-t)


def logloss(x, X, y, lam=LAMBDA):
    t = y * (x @ X.T)
    return _logaddexp0(-t).mean(dim=-1) + 0.5 * lam * (x * x).sum(dim=-1)


def test_logloss(x, X, y):
    """Paper figures plot *test* log loss (no regularizer)."""
    t = y * (x @ X.T)
    return _logaddexp0(-t).mean(dim=-1)


def lr_grad(x, xi, yi, lam=LAMBDA):
    """Per-sample gradient G_xi(x); ``xi`` and ``x`` broadcast over
    leading dimensions, ``yi`` has those leading dimensions."""
    t = yi * (xi * x).sum(dim=-1)
    sig = torch.sigmoid(-t)
    return (-sig * yi)[..., None] * xi + lam * x


def lr_grad_batch(x, Xb, yb, lam=LAMBDA):
    t = yb * (Xb @ x)
    sig = torch.sigmoid(-t)
    return -(sig * yb) @ Xb / Xb.shape[0] + lam * x
