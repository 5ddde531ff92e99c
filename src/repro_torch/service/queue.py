"""Bounded admission for the advisor service (port of
``repro/service/queue.py``).

An escalated probe holds the device for seconds, and an unbounded queue
turns overload into unbounded latency.  `AdmissionQueue` is a
counting-semaphore admission gate: ``try_admit`` never blocks; a None
means the caller answers with a structured ``overloaded`` response now
(see `api.AdvisorService.probe_batch`), and requests under capacity are
never affected by the shed ones.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from repro_torch.telemetry import metrics

_ADMITTED = metrics.counter("repro_service_admitted_total",
                            help="probe requests admitted past the gate")
_SHED = metrics.counter("repro_service_shed_total",
                        help="probe requests shed at admission (overload)")
_DEPTH = metrics.gauge("repro_service_queue_depth",
                       help="probes currently holding an admission slot")
_HIGH_WATER = metrics.gauge(
    "repro_service_queue_high_water",
    help="max concurrent in-service probes since last reset")
#: slot-hold durations: how long each admitted probe kept its admission
#: slot (analytic answers are sub-ms, escalations hold for a whole
#: sweep) — paired with shed_total this is the shedding-pressure story a
#: scrape window sees: long holds + a full gate = clipped load
_WAIT = metrics.histogram(
    "repro_service_queue_wait_seconds",
    help="seconds an admitted probe held its admission slot")


class AdmissionQueue:
    """Non-blocking admission gate with a fixed depth.

    ``try_admit`` takes a slot if one is free (and counts the request);
    ``release`` returns it.  Shed requests are counted but never queued —
    load shedding is the contract, not buffering.  ``high_water`` is the
    deepest concurrent occupancy seen — the capacity-planning number: a
    high-water mark at ``depth`` with nonzero ``shed`` means the gate is
    actually clipping load, not just sized generously."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"queue depth {depth} must be >= 1")
        self.depth = int(depth)
        self._sem = threading.BoundedSemaphore(self.depth)
        self._lock = threading.Lock()
        self._in_service = 0
        self.admitted = 0
        self.shed = 0
        self.high_water = 0

    def try_admit(self) -> Optional[float]:
        """Take a slot; returns an admission stamp (monotonic seconds, to
        hand back to :meth:`release` for the wait histogram) or None when
        the gate is full.  Truthiness is unchanged from the old bool
        return — ``if queue.try_admit():`` still reads correctly, since a
        perf_counter stamp is always > 0."""
        ok = self._sem.acquire(blocking=False)
        with self._lock:
            if ok:
                self.admitted += 1
                self._in_service += 1
                if self._in_service > self.high_water:
                    self.high_water = self._in_service
                _DEPTH.set(self._in_service)
            else:
                self.shed += 1
        if ok:
            _ADMITTED.inc()
            _HIGH_WATER.set_max(self.high_water)
            return time.perf_counter()
        _SHED.inc()
        return None

    def release(self, admitted_at: Optional[float] = None) -> None:
        """Return a slot; passing the stamp :meth:`try_admit` returned
        records the slot-hold duration in
        ``repro_service_queue_wait_seconds``."""
        if admitted_at is not None:
            _WAIT.observe(time.perf_counter() - admitted_at)
        with self._lock:
            self._in_service -= 1
            _DEPTH.set(self._in_service)
        self._sem.release()

    @property
    def in_service(self) -> int:
        with self._lock:
            return self._in_service

    def stats(self, reset: bool = False) -> Dict:
        """Queue counters; ``reset=True`` additionally re-arms the
        ``high_water`` mark to the *current* occupancy after reading, so
        a scraper polling ``stats(reset=True)`` per window sees the
        per-window peak instead of the since-start one.  The returned
        dict is always the pre-reset view."""
        with self._lock:
            out = {"depth": self.depth, "in_service": self._in_service,
                   "admitted": self.admitted, "shed": self.shed,
                   "high_water": self.high_water}
            if reset:
                self.high_water = self._in_service
                _HIGH_WATER.set(self._in_service)
        return out
