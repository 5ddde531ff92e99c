"""Model FLOPs of one training token, by term, from the counts of the
configuration's reference kind (``portbench/counts/<kind>.py``, see
:mod:`portbench.harness.kinds`)."""

from __future__ import annotations

import math

from portbench.harness import kinds


def terms(cfg, seq: int) -> dict:
    """FLOPs per token by term, forward and backward."""
    return kinds.counts(cfg).terms(cfg, seq)


def per_token(cfg, seq: int) -> float:
    return math.fsum(terms(cfg, seq).values())
