"""Registered training objectives, the `Problem` protocol (port of
``repro/core/problems.py``).

A :class:`Problem` describes a linear-model objective

    argmin_x (1/n) sum_i phi(x . xi_i, label_i) + (lam/2) ||x||^2

through primal hooks (``dloss``, the batch / point gradients and the
unregularized ``test_loss``) and the dual hooks DADM's SDCA update needs
(``dual_init``, ``sdca_stepfactor``, ``sdca_delta``, ``sdca_damping``).
The hooks take batched tensors: a model ``x`` of shape ``(B, d)`` is B
independent models, one per sweep member, and every hook keeps the
leading dimensions.

Registered: ``logistic`` (the paper's Eq. 4), ``ridge`` and ``hinge``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Type

import torch

from repro_torch.core.algorithms import lr

LAMBDA = lr.LAMBDA

#: name -> Problem subclass; latest registration wins.
PROBLEMS: Dict[str, Type["Problem"]] = {}


def register_problem(cls: Type["Problem"]) -> Type["Problem"]:
    """Class decorator: make a Problem resolvable by its ``name``."""
    if not (isinstance(getattr(cls, "name", None), str) and cls.name):
        raise TypeError(f"{cls!r} needs a non-empty ClassVar 'name'")
    PROBLEMS[cls.name] = cls
    return cls


def get_problem(name: str) -> Type["Problem"]:
    try:
        return PROBLEMS[name]
    except KeyError:
        raise KeyError(f"unknown problem {name!r}; "
                       f"known: {sorted(PROBLEMS)}") from None


def resolve_problem(problem, lam=None) -> "Problem":
    """Coerce a name / class / instance (+ optional lam override) to an
    instance."""
    if isinstance(problem, str):
        problem = get_problem(problem)
    if isinstance(problem, type):
        problem = problem() if lam is None else problem(lam=lam)
    elif lam is not None and lam != problem.lam:
        problem = dataclasses.replace(problem, lam=lam)
    return problem


@dataclasses.dataclass(frozen=True)
class Problem:
    """Base protocol.  Subclass, set ``name``, implement the hooks."""

    name: ClassVar[str] = ""
    lam: float = LAMBDA

    # -- primal -------------------------------------------------------------
    def dloss(self, z, y):
        """d phi(z, y) / dz at prediction z = x . xi."""
        raise NotImplementedError

    def test_loss(self, x, X, y):
        """Mean unregularized loss of each model in ``x`` (..., d)."""
        raise NotImplementedError

    def train_loss(self, x, X, y):
        return self.test_loss(x, X, y) + 0.5 * self.lam * (x * x).sum(-1)

    def point_grad(self, x, xi, yi):
        """Per-sample regularized gradient; x, xi (..., d), yi (...)."""
        c = self.dloss((xi * x).sum(dim=-1), yi)
        return c[..., None] * xi + self.lam * x

    def batch_grad(self, x, Xb, yb):
        """Mean regularized gradient over a batch: x (..., d), Xb (b, d)."""
        c = self.dloss(x @ Xb.T, yb)
        return (c @ Xb) / Xb.shape[0] + self.lam * x

    def masked_batch_grad(self, x, Xb, yb, active, mf):
        """Engine hot path, batched over members: x (B, d), Xb (B, m, d),
        yb and active (B, m), mf (B,).  Rows with ``active == 0`` add
        nothing and the mean divides by the live count ``mf``."""
        z = torch.einsum("bmd,bd->bm", Xb, x)
        c = self.dloss(z, yb) * active
        return torch.einsum("bm,bmd->bd", c, Xb) / mf[:, None] + self.lam * x

    # -- dual (DADM / SDCA) -------------------------------------------------
    def dual_init(self) -> float:
        return 0.0

    def sdca_stepfactor(self, sq_norms, n):
        raise NotImplementedError

    def sdca_delta(self, z, y, alpha, step):
        raise NotImplementedError

    def sdca_damping(self, k):
        """Scale of the k concurrent dual increments per server iteration
        (``k`` a float tensor, one entry per member).  1.0 keeps the
        paper's additive all-gather; unbounded duals average (1/k)."""
        return torch.ones_like(k)


@register_problem
@dataclasses.dataclass(frozen=True)
class LogisticRegression(Problem):
    """Paper Eq. 4 — delegates to `lr.py`."""

    name: ClassVar[str] = "logistic"

    def dloss(self, z, y):
        return -torch.sigmoid(-(y * z)) * y

    def test_loss(self, x, X, y):
        return lr.test_logloss(x, X, y)

    def point_grad(self, x, xi, yi):
        return lr.lr_grad(x, xi, yi, self.lam)

    def dual_init(self) -> float:
        return 0.5                       # alpha in (0, 1)

    def sdca_stepfactor(self, sq_norms, n):
        # logistic is 1/4-smooth: min(1, lam n / (||xi||^2/4 + lam n))
        return torch.clamp_max((self.lam * n)
                               / (sq_norms / 4.0 + self.lam * n), 1.0)

    def sdca_delta(self, z, y, alpha, step):
        return (torch.sigmoid(-(y * z)) - alpha) * step


@register_problem
@dataclasses.dataclass(frozen=True)
class RidgeRegression(Problem):
    """L2-regularized least squares on the +-1 ruler labels:
    phi(z, y) = (z - y)^2 / 2.  The exact SDCA coordinate step is
    Delta alpha = (y - z - alpha) / (1 + ||xi||^2 / (lam n))."""

    name: ClassVar[str] = "ridge"

    def dloss(self, z, y):
        return z - y

    def test_loss(self, x, X, y):
        r = x @ X.T - y
        return 0.5 * (r * r).mean(dim=-1)

    def sdca_stepfactor(self, sq_norms, n):
        return (self.lam * n) / (self.lam * n + sq_norms)

    def sdca_delta(self, z, y, alpha, step):
        return (1.0 - y * z - alpha) * step

    def sdca_damping(self, k):
        # the squared-loss dual is unconstrained: average the k concurrent
        # exact-maximizer steps instead of adding them
        return 1.0 / k


@register_problem
@dataclasses.dataclass(frozen=True)
class HingeSVM(Problem):
    """Soft-margin SVM: phi(z, y) = max(0, 1 - y z).  Primal uses the
    subgradient; the dual is the box-constrained SDCA update with the
    normalized coordinate alpha_i in [0, 1]."""

    name: ClassVar[str] = "hinge"

    def dloss(self, z, y):
        return -y * (y * z < 1.0).to(torch.float32)

    def test_loss(self, x, X, y):
        return torch.clamp_min(1.0 - y * (x @ X.T), 0.0).mean(dim=-1)

    def sdca_stepfactor(self, sq_norms, n):
        return (self.lam * n) / torch.clamp_min(sq_norms, 1e-12)

    def sdca_delta(self, z, y, alpha, step):
        return torch.clamp(alpha + (1.0 - y * z) * step, 0.0, 1.0) - alpha

    def sdca_damping(self, k):
        # averaging keeps the box-corner jumps monotone and deterministic
        return 1.0 / k
