"""Flight recorder: a bounded, always-on ring of sweep progress events
(the port's copy of ``repro/telemetry/recorder.py``).

Two bounded rings behind one monotone sequence counter:

  * **events** — per-job progress markers published by
    `experiments.runner.run_sweep` (sweep/job started, retried, replayed,
    diverged, failed, stored).  Publishing is a lock and a
    ``deque.append`` of a small dict, a handful of times per sweep.
  * **spans** — completed spans mirrored from the tracer while one is
    installed (`trace.add_span_sink`); with tracing off this ring stays
    empty.

Each record carries a process-monotonic ``seq``;
:meth:`FlightRecorder.snapshot` returns everything newer than a caller's
``since`` cursor, so a poller (``GET /flight?since=N``) tails the stream.
Old records fall off the bounded ends: the recorder is an observability
window, the crash journal (`repro_torch.resilience.journal`) the durable
record.  Publishing happens beside the sweep's computation, never in it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, Optional

#: default ring capacities — sized for "the last few sweeps", not history
DEFAULT_EVENTS = 4096
DEFAULT_SPANS = 2048


class FlightRecorder:
    """Two bounded rings (progress events, mirrored spans) behind one
    monotone sequence counter."""

    def __init__(self, max_events: int = DEFAULT_EVENTS,
                 max_spans: int = DEFAULT_SPANS):
        self._lock = threading.Lock()
        self._seq = 0
        self._events: Deque[Dict] = collections.deque(maxlen=max_events)
        self._spans: Deque[Dict] = collections.deque(maxlen=max_spans)
        self._published = 0
        self._t0 = time.time()

    # -- producers -----------------------------------------------------------
    def publish(self, kind: str, **fields) -> Dict:
        """Append one progress event; returns the recorded dict.  ``kind``
        is the event schema selector; ``fields`` must be JSON-serializable (the HTTP snapshot dumps
        them verbatim)."""
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "t": time.time(), "kind": kind,
                  **fields}
            self._events.append(ev)
            self._published += 1
        return ev

    def record_span(self, span_event: Dict) -> None:
        """Span-sink callback (`trace.add_span_sink`): mirror a completed
        span into the bounded span ring."""
        with self._lock:
            self._seq += 1
            self._spans.append(dict(span_event, seq=self._seq))

    # -- consumers -----------------------------------------------------------
    def snapshot(self, since: int = 0,
                 limit: Optional[int] = None) -> Dict:
        """Everything newer than the ``since`` cursor, oldest first.

        Returns ``{"seq", "published", "uptime_s", "events", "spans"}``;
        ``seq`` is the cursor to pass back on the next poll.  ``limit``
        caps each list (newest kept) so one scrape stays bounded even
        after a long gap."""
        with self._lock:
            events = [e for e in self._events if e["seq"] > since]
            spans = [s for s in self._spans if s["seq"] > since]
            seq, published = self._seq, self._published
        if limit is not None:
            events, spans = events[-limit:], spans[-limit:]
        return {"seq": seq, "published": published,
                "uptime_s": time.time() - self._t0,
                "events": events, "spans": spans}

    def clear(self) -> None:
        """Drop both rings (tests; the seq cursor keeps advancing so a
        poller never sees a replay)."""
        with self._lock:
            self._events.clear()
            self._spans.clear()

    def stats(self) -> Dict:
        with self._lock:
            return {"seq": self._seq, "published": self._published,
                    "events_held": len(self._events),
                    "spans_held": len(self._spans),
                    "max_events": self._events.maxlen,
                    "max_spans": self._spans.maxlen}


#: the process-default recorder every instrumented module publishes to
RECORDER = FlightRecorder()


def publish(kind: str, **fields) -> Dict:
    """Publish one progress event to the process recorder."""
    return RECORDER.publish(kind, **fields)


def snapshot(since: int = 0, limit: Optional[int] = None) -> Dict:
    return RECORDER.snapshot(since=since, limit=limit)
