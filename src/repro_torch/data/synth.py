"""Synthetic datasets matching the paper's Table I constructions (port of
``repro/data/synth.py``).

Generators register by name in :data:`GENERATORS`, which specs reference
and whose sources the spec fingerprint hashes.  Each generator takes a
key from `repro_torch.random` and draws on the key's device, so the data
is made where it is used and, for the same key, is bit-identical to the
reference's.  This slice ports the three generators the ``upper_bound``
spec uses: ``realsim_like``, ``higgs_like`` and ``upper_bound``.

Labels follow the paper: label_i = sign(xi_i . ruler),
ruler = (-1, 2, -3, 4, ..., (-1)^d * d).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch import random as R

#: name -> generator ``fn(key, **kwargs) -> Dataset``; latest wins.
GENERATORS: Dict[str, Callable] = {}


def register_generator(name: str):
    """Decorator: register a dataset generator under a spec-facing name."""
    def deco(fn):
        GENERATORS[name] = fn
        return fn
    return deco


def get_generator(name: str) -> Callable:
    try:
        return GENERATORS[name]
    except KeyError:
        raise KeyError(f"unknown generator {name!r}; "
                       f"known: {sorted(GENERATORS)}") from None


def ruler(d, device="cpu"):
    r = torch.arange(1, d + 1, dtype=torch.float32, device=device)
    return r * torch.pow(-1.0, r)


def label_with_ruler(X):
    y = torch.sign(X @ ruler(X.shape[1], X.device))
    return torch.where(y == 0, torch.ones_like(y), y)


@dataclasses.dataclass
class Dataset:
    X: torch.Tensor              # (n, d) float32
    y: torch.Tensor              # (n,) in {-1, +1}
    name: str = ""

    def split(self, train_frac=0.7, valid_frac=0.2, key=None,
              with_test=False):
        """Paper §VII.A fractions: 70% train / 20% valid / 10% held-out
        test.  ``key=None`` keeps the row order (the sampling order is a
        dataset character); a key shuffles with `random.permutation`.
        The tail is returned as a third dataset when ``with_test``."""
        if not (0.0 < train_frac <= 1.0 and 0.0 <= valid_frac <= 1.0
                and train_frac + valid_frac <= 1.0 + 1e-9):
            raise ValueError(
                f"bad split fractions: train={train_frac} valid={valid_frac}"
                f" (need 0 < train, 0 <= valid, train + valid <= 1)")
        n = self.X.shape[0]
        idx = (R.permutation(key, n).to(self.X.device) if key is not None
               else torch.arange(n, device=self.X.device))
        ntr = int(n * train_frac)
        nva = int(n * valid_frac)
        parts = [(idx[:ntr], ":train"), (idx[ntr:ntr + nva], ":valid")]
        if with_test:
            parts.append((idx[ntr + nva:], ":test"))
        return tuple(Dataset(self.X[i], self.y[i], self.name + tag)
                     for i, tag in parts)


def _masked_uniform(key, n, d, density, lo, hi):
    k1, k2 = R.split(key)
    mask = R.bernoulli(k1, density, (n, d))
    vals = R.uniform(k2, (n, d), minval=lo, maxval=hi)
    return torch.where(mask, vals, torch.zeros_like(vals))


@register_generator("realsim_like")
def make_realsim_like(key, n=8000, d=2000, density=0.03, lo=0.0, hi=1.0):
    """Sparse, small-feature-variance dataset (real-sim analogue)."""
    X = _masked_uniform(key, n, d, density, lo, hi)
    return Dataset(X, label_with_ruler(X), "realsim_like")


@register_generator("higgs_like")
def make_higgs_like(key, n=8000, d=28, lo=-4.0, hi=3.0):
    """Dense, large-feature-variance dataset (HIGGS analogue)."""
    X = R.uniform(key, (n, d), minval=lo, maxval=hi)
    return Dataset(X, label_with_ruler(X), "higgs_like")


@register_generator("upper_bound")
def make_upper_bound_dataset(key, n=6000, d=400, density=0.7, lo=0.0, hi=1.0):
    """§VII.E: 70%-density simulated dataset whose Hogwild! upper bound is
    reachable with few workers."""
    X = _masked_uniform(key, n, d, density, lo, hi)
    return Dataset(X, label_with_ruler(X), "upper_bound_sim")
