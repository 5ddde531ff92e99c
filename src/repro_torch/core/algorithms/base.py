"""The `Algorithm` protocol — the engine-facing shape of a parallel trainer
(port of ``repro/core/algorithms/base.py``).

`repro_torch.experiments.engine` runs every algorithm the same way: all
members of a bucket of the worker grid (and all seed replicates) are one
batch of B independent simulations, every state tensor has a leading
member axis of size B, the worker axis is padded to the bucket's
``m_pad``, and each member's live worker count ``m`` is an entry of a
``(B,)`` tensor.  What varies per algorithm is this protocol:

  ``make_draws(key, n, iters, m_top, d)``  every random draw of one run,
        made once at the global top ``m_top`` of the worker grid, leading
        dimension ``iters``
  ``slice_draws(draws, m_pad)``   restrict draws to a bucket's pad width
  ``init_state(problem, data, ctx)``  the batched state (derived
        constants such as ring matrices go on ``ctx``)
  ``step(problem, data, ctx, state, batch, t)``  one server iteration for
        every member; ``batch`` is iteration t's draws, ``(B, ...)``
  ``readout(ctx, state)``         the ``(B, d)`` models the loss reads

The masking contract: for any ``m <= m_pad``, padded workers (index >= m)
take no part in any reduction or stateful write, so the padded run is
numerically the m-worker run.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Type

import torch

#: name -> Algorithm subclass; latest registration wins.
ALGORITHMS: Dict[str, Type["Algorithm"]] = {}

#: predictor kinds an Algorithm may declare (resolved in experiments.runner)
PREDICTOR_KINDS = ("sync", "hogwild", "dadm", "momentum", "local_sgd", "svrg")


def register_algorithm(cls: Type["Algorithm"]) -> Type["Algorithm"]:
    """Class decorator: make an Algorithm resolvable by its ``name``."""
    if not (isinstance(getattr(cls, "name", None), str) and cls.name):
        raise TypeError(f"{cls!r} needs a non-empty ClassVar 'name'")
    if cls.predictor not in PREDICTOR_KINDS:
        raise ValueError(f"{cls.name}: predictor {cls.predictor!r} "
                         f"not in {PREDICTOR_KINDS}")
    ALGORITHMS[cls.name] = cls
    return cls


def get_algorithm(name: str) -> Type["Algorithm"]:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise KeyError(f"unknown algorithm {name!r}; "
                       f"known: {sorted(ALGORITHMS)}") from None


def registered_algorithms():
    return tuple(sorted(ALGORITHMS))


class SimContext:
    """Per-batch context: the pad width, each member's live worker count
    and the masks derived from it."""

    def __init__(self, m, m_pad: int):
        self.m = m                               # (B,) int64 live counts
        self.m_pad = int(m_pad)                  # worker-axis width
        self.mf = m.to(torch.float32)
        #: (B, m_pad) float mask — 1 for live workers, 0 for padding
        workers = torch.arange(m_pad, device=m.device)
        self.active = (workers[None, :] < m[:, None]).to(torch.float32)
        self.rows = torch.arange(m.shape[0], device=m.device)


def map_draws(fn, draws):
    """Apply ``fn`` to a draws tensor or to each tensor of a draws dict."""
    if isinstance(draws, dict):
        return {k: fn(v) for k, v in draws.items()}
    return fn(draws)


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """Base protocol.  Subclass, set ``name``, implement the hooks."""

    name: ClassVar[str] = ""
    asynchronous: ClassVar[bool] = False
    bucketed_default: ClassVar[bool] = True
    force_flat: ClassVar[bool] = False
    predictor: ClassVar[str] = "sync"
    #: effective-step amplification a generic harness should divide out
    gamma_scale: ClassVar[float] = 1.0

    def make_draws(self, key, n: int, iters: int, m_top: int, d: int):
        """All draws for ``iters`` steps at the grid top ``m_top``: a
        tensor or a dict of tensors with leading dimension ``iters``."""
        raise NotImplementedError

    def slice_draws(self, draws, m_pad: int):
        """Default: worker axes are axis 1 — take their first ``m_pad``
        columns; per-iteration scalars pass through."""
        return map_draws(lambda a: a[:, :m_pad] if a.dim() >= 2 else a, draws)

    def init_state(self, problem, data, ctx: SimContext):
        raise NotImplementedError

    def step(self, problem, data, ctx: SimContext, state, batch, t: int):
        raise NotImplementedError

    def readout(self, ctx: SimContext, state):
        raise NotImplementedError
