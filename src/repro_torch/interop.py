"""Carry-across functions: the reference's state, given as numpy arrays,
turned into the port's, so tests can feed both packages identical inputs.

  :func:`dataset`  X and y (and a name) -> `data.synth.Dataset`
  :func:`split`    the reference's train / valid (/ test) datasets, each
                   as an ``(X, y)`` pair -> a tuple of port datasets
  :func:`draws`    an algorithm's ``make_draws`` output -> the port's
                   draws (ECD-PSGD's per-(iteration, worker) keys become
                   the uniform noise they seed)
  :func:`model`    a model vector -> a float32 tensor
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.data.synth import Dataset


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def dataset(X, y, name: str = "", device="cpu") -> Dataset:
    return Dataset(_tensor(X, torch.float32, device),
                   _tensor(y, torch.float32, device), name)


def split(*parts, device="cpu"):
    """``split((Xtr, ytr), (Xva, yva)[, (Xte, yte)])`` -> datasets."""
    tags = (":train", ":valid", ":test")
    return tuple(dataset(X, y, tag, device)
                 for (X, y), tag in zip(parts, tags))


def model(x, device="cpu") -> torch.Tensor:
    return _tensor(x, torch.float32, device)


def draws(algorithm: str, ref_draws, d: int, device="cpu"):
    """The reference's ``make_draws`` pytree for ``algorithm`` -> the
    port's draws.  Sample indices become int64; ECD-PSGD's ``keys``
    (iters, m_top, 2) uint32 become ``u`` (iters, m_top, d), the uniform
    noise each key draws."""
    if algorithm == "ecd_psgd":
        keys = _tensor(np.asarray(ref_draws["keys"]).astype(np.int64),
                       torch.int64, device)
        return {"order": _tensor(ref_draws["order"], torch.int64, device),
                "u": R.uniform(keys, (d,))}
    if algorithm in ("minibatch", "hogwild", "dadm"):
        return _tensor(ref_draws, torch.int64, device)
    raise KeyError(f"no carry-across for algorithm {algorithm!r}")
