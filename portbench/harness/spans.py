"""The program's own spans: device milliseconds per traced step of named
spans of the port's training step (``repro_torch.telemetry.instrument``),
read from its process registry after the traced window.

The program times a step's spans while a profiler records, so the
totals cover every profiled step (the window's and the idle-gap step) and
no other.  A program without the spans, or a run that timed no step,
reads None."""

from __future__ import annotations

#: the checkpoints' recompute inside the backward pass
RECOMPUTE = (("model.block", "recompute"), ("model.ce", "recompute"))


def totals():
    """The program's span totals (``instrument.span_totals``), or None."""
    try:
        from repro_torch.telemetry import instrument
        read = instrument.span_totals
    except (ImportError, AttributeError):
        return None
    t = read()
    return t if t["steps"] else None


def ms_per_step(plus, minus=()):
    """Device ms per traced step of the spans ``plus`` less ``minus``,
    each a ``(span, phase)`` (phase None: every phase); None when no span
    of ``plus`` was timed."""
    t = totals()
    if t is None:
        return None

    def total(keys):
        hits = [s for (name, phase), s in t["seconds"].items()
                if any(name == k and p in (None, phase) for k, p in keys)]
        return sum(hits), bool(hits)
    got, found = total(plus)
    if not found:
        return None
    return 1e3 * (got - total(minus)[0]) / t["steps"]
