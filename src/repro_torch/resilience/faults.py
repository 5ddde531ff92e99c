"""Deterministic fault injection for parallel-training update streams
(port of ``repro/resilience/faults.py``).

A :class:`FaultSpec` names four fault processes on the stream of worker
updates:

  * **drop**      the update is lost (``drop_rate``);
  * **duplicate** the update lands twice (``duplicate_rate``);
  * **straggle**  the worker read a model ``straggle_rounds`` rounds
                  staler than the algorithm's own staleness
                  (``straggle_rate``);
  * **corrupt**   the gradient is corrupted: ``sign_flip`` or
                  ``quantize`` (``corrupt_bits``-bit rounding)
                  (``corrupt_rate``).

Faults are environment, not randomness of the experiment: every event
mask is drawn from ``PRNGKey(FaultSpec.seed)``, one ``fold_in`` tag per
kind, never from the sweep's keys, so seed replicates share the schedule
and the masks are bit-identical to the reference's.  Every helper is
IEEE-exact at zero rates (a computed scale of 1.0, a ``where`` over an
all-False mask), so ``FaultSpec()`` runs bit-identical to ``fault=None``.

The helpers take any mapping holding the four masks under the keys of
:func:`make_stream` (the algorithms keep them beside their sample
indices in one flat draws dict), sliced to one iteration with a leading
member axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import random as R
from repro_torch.device import DEFAULT_DEVICE

#: corruption models a FaultSpec may name
CORRUPT_KINDS = ("sign_flip", "quantize")

#: fold_in tags, one independent threefry stream per fault process
_TAGS = {"drop": 0, "dup": 1, "straggle": 2, "corrupt": 3}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault environment: four event rates plus their parameters.
    Rates are per-update probabilities in ``[0, 1]``; the dict form lives
    in ``JobSpec.kwargs``, so faulted jobs split the cache like any other
    hyperparameter."""

    drop_rate: float = 0.0
    duplicate_rate: float = 0.0
    straggle_rate: float = 0.0
    straggle_rounds: int = 1          # extra staleness per straggle event
    corrupt_rate: float = 0.0
    corrupt_kind: str = "sign_flip"   # one of CORRUPT_KINDS
    corrupt_bits: int = 8             # quantize: signed levels = 2^(bits-1)
    seed: int = 0                     # the fault environment's own key

    def validate(self) -> "FaultSpec":
        for f in ("drop_rate", "duplicate_rate", "straggle_rate",
                  "corrupt_rate"):
            v = getattr(self, f)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"FaultSpec.{f}={v!r} must be in [0, 1]")
        if self.corrupt_kind not in CORRUPT_KINDS:
            raise ValueError(f"FaultSpec.corrupt_kind={self.corrupt_kind!r} "
                             f"not in {CORRUPT_KINDS}")
        if self.straggle_rounds < 1:
            raise ValueError(
                f"FaultSpec.straggle_rounds={self.straggle_rounds} "
                f"must be >= 1")
        if self.corrupt_bits < 1:
            raise ValueError(f"FaultSpec.corrupt_bits={self.corrupt_bits} "
                             f"must be >= 1")
        return self

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


FaultLike = Union[None, Dict, FaultSpec]


def resolve(fault: FaultLike) -> Optional[FaultSpec]:
    """``None`` passes through; a dict (the ``JobSpec.kwargs`` form)
    becomes a validated :class:`FaultSpec`; a spec validates."""
    if fault is None:
        return None
    if isinstance(fault, FaultSpec):
        return fault.validate()
    if isinstance(fault, dict):
        try:
            return FaultSpec(**fault).validate()
        except TypeError as e:
            raise ValueError(f"bad fault dict {fault!r}: {e}") from None
    raise TypeError(f"fault must be None, a dict, or a FaultSpec; "
                    f"got {type(fault).__name__}")


def make_stream(spec: FaultSpec, shape: Tuple[int, ...],
                device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """The per-update event indicators of a whole run: ``{"drop", "dup",
    "straggle", "corrupt"}``, float32 0/1 tensors of ``shape`` on
    ``device``, each ``uniform(fold_in(PRNGKey(seed), tag)) < rate`` (a
    zero rate gives all zeros: uniform draws lie in ``[0, 1)``)."""
    key = R.PRNGKey(spec.seed, device=device)
    rates = {"drop": spec.drop_rate, "dup": spec.duplicate_rate,
             "straggle": spec.straggle_rate, "corrupt": spec.corrupt_rate}
    return {name: (R.uniform(R.fold_in(key, tag), shape)
                   < torch.tensor(rates[name], dtype=torch.float32,
                                  device=key.device)).to(torch.float32)
            for name, tag in _TAGS.items()}


def delivery_scale(stream_slice):
    """Multiplier a delivered update lands with: ``(1 - drop)(1 + dup)``,
    0 for a lost message, 2 for a duplicated one, exactly 1.0 otherwise.
    ``stream_slice`` is :func:`make_stream`'s dict indexed at the
    update."""
    return (1.0 - stream_slice["drop"]) * (1.0 + stream_slice["dup"])


def extra_staleness(spec: FaultSpec, stream_slice):
    """int64 extra rounds of staleness a straggle event adds (0 when the
    event did not fire)."""
    return (stream_slice["straggle"] * spec.straggle_rounds).to(torch.int64)


def corrupt(spec: FaultSpec, g, flag):
    """Apply the spec's corruption model where ``flag`` fired.  ``g`` has a
    leading member axis and ``flag`` broadcasts against it from the left
    (a per-worker flag corrupts that worker's gradient row).  The
    quantize scale is each member's max ``|g|``, as the reference takes
    it over one member's gradient."""
    while flag.dim() < g.dim():
        flag = flag[..., None]
    if spec.corrupt_kind == "sign_flip":
        bad = -g
    else:   # quantize: deterministic symmetric rounding to 2^(bits-1) levels
        levels = float(2 ** (spec.corrupt_bits - 1))
        s = torch.clamp_min(torch.abs(g).flatten(1).amax(dim=1), 1e-12)
        s = s.reshape(-1, *([1] * (g.dim() - 1)))
        bad = torch.round(g / s * levels) * (s / levels)
    return torch.where(flag > 0, bad, g)
