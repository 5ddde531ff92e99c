"""Context-var span tracer with Chrome-trace / Perfetto JSON export (the
port's copy of ``repro/telemetry/trace.py``).

  * **Zero overhead when disabled.**  Tracing is off by default;
    :func:`span` then returns a shared no-op context manager — one
    module-global read and one ``is None`` check, no allocation, no clock
    read.  The instrumented code runs the same statements either way, so
    artifacts are byte-identical with tracing on or off.
  * **Thread-safe, nesting-correct.**  The current span stack lives in a
    `contextvars.ContextVar`, so the service's request threads (and dedup
    leader/waiter races) each carry their own stack; events carry the
    thread id and nesting depth.
  * **One tracer at a time.**  :func:`start` installs the process-wide
    tracer, :func:`stop` uninstalls it but keeps it addressable as the
    *last* tracer, so :func:`export` after ``stop()`` writes the trace.
  * **The profiler's clock.**  Spans are timed with ``perf_counter_ns``
    and exported in microseconds from the tracer's start, whose Unix-epoch
    nanoseconds ``otherData.base_epoch_ns`` records (:data:`CLOCK`):
    ``torch.profiler`` stamps its host events and the device's activity
    on the Unix epoch, so ``ts + base_epoch_ns / 1e3`` lays an exported
    trace over a profile of the same run.

Usage::

    from repro_torch.telemetry import trace
    trace.start()
    with trace.span("sweep", name="upper_bound"):
        with trace.span("job", key="minibatch/dense"):
            ...
    trace.stop()
    trace.export("out.json")          # Chrome-trace JSON

:func:`phase_breakdown` aggregates a trace's spans per name.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Dict, List, Optional

#: (start_ns, depth) tuples of the enclosing spans for the current
#: execution context — contextvars give each thread (and each asyncio
#: task, should the service ever grow one) its own stack
_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_trace_stack", default=())


#: the clock of the exported ``ts`` (microseconds): the Unix epoch, as
#: ``torch.profiler``'s events have it, less ``otherData.base_epoch_ns``
CLOCK = "unix_epoch_from_base"

#: registered span sinks — callables fed every completed span event while
#: a tracer is installed (the flight recorder mirrors spans this way);
#: sinks must be cheap and never raise
_SPAN_SINKS: List = []


def add_span_sink(fn) -> None:
    """Register a callback receiving every completed span's event dict.
    Idempotent per callable; only fires while a tracer is installed."""
    if fn not in _SPAN_SINKS:
        _SPAN_SINKS.append(fn)


def remove_span_sink(fn) -> None:
    if fn in _SPAN_SINKS:
        _SPAN_SINKS.remove(fn)


#: callables run before a tracer's events are read out (the device-timed
#: spans of ``instrument`` record once the device has reached them)
_FLUSH_HOOKS: List = []


def add_flush_hook(fn) -> None:
    """Register ``fn()``, run before :meth:`Tracer.payload` and
    :meth:`Tracer.drain` read the events.  Idempotent per callable."""
    if fn not in _FLUSH_HOOKS:
        _FLUSH_HOOKS.append(fn)


def _flush() -> None:
    for fn in _FLUSH_HOOKS:
        fn()


class Tracer:
    """Collects completed spans as Chrome-trace ``X`` (complete) events."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict] = []
        self.t0_ns = time.perf_counter_ns()
        #: the Unix epoch's ns at ``t0_ns``, the exported ``ts``'s origin
        self.base_epoch_ns = time.time_ns()

    def record(self, name: str, start_ns: int, dur_ns: int, depth: int,
               args: Dict) -> None:
        ev = {
            "name": name,
            "ph": "X",
            # Chrome-trace timestamps are microseconds (float ok)
            "ts": (start_ns - self.t0_ns) / 1e3,
            "dur": dur_ns / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "cat": "repro_torch",
            "args": dict(args, depth=depth),
        }
        with self._lock:
            self._events.append(ev)
        for sink in _SPAN_SINKS:
            sink(ev)

    @property
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def drain(self) -> List[Dict]:
        """Pop and return every recorded span (the HTTP ``/trace?drain=1``
        path — a poller that exports incrementally without holding the
        whole run in tracer memory)."""
        _flush()
        with self._lock:
            evs, self._events = self._events, []
            return evs

    def payload(self) -> Dict:
        """The exported JSON object (Chrome-trace "JSON Object Format")."""
        _flush()
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": self.other_data(),
        }

    def other_data(self) -> Dict:
        """The export's ``otherData``: its producer and clock."""
        return {"producer": "repro_torch.telemetry", "clock": CLOCK,
                "base_epoch_ns": self.base_epoch_ns}

    def export(self, path: str) -> str:
        payload = self.payload()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path


class _Span:
    """Live span context manager — records itself on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_depth", "_token")

    def __init__(self, tracer: Tracer, name: str, args: Dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        stack = _STACK.get()
        self._depth = len(stack)
        self._t0 = time.perf_counter_ns()
        self._token = _STACK.set(stack + ((self._name, self._t0),))
        return self

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. a result size)."""
        self._args.update(attrs)
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        _STACK.reset(self._token)
        self._tracer.record(self._name, self._t0, dur, self._depth,
                            self._args)
        return False


class _NoopSpan:
    """The disabled-mode span: enter/exit/set are all no-ops.  One shared
    instance — `span()` with tracing off allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()

#: the installed tracer (None = disabled) and the last one installed —
#: export() after stop() still writes the completed trace
_ACTIVE: Optional[Tracer] = None
_LAST: Optional[Tracer] = None
_INSTALL_LOCK = threading.Lock()


def start() -> Tracer:
    """Install (and return) a fresh process-wide tracer."""
    global _ACTIVE, _LAST
    with _INSTALL_LOCK:
        _ACTIVE = _LAST = Tracer()
        return _ACTIVE


def stop() -> Optional[Tracer]:
    """Uninstall the tracer; it stays addressable via :func:`last` /
    :func:`export`.  Returns the stopped tracer (None if none ran)."""
    global _ACTIVE
    with _INSTALL_LOCK:
        t, _ACTIVE = _ACTIVE, None
        return t


def active() -> Optional[Tracer]:
    """The installed tracer, or None when tracing is disabled."""
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def last() -> Optional[Tracer]:
    """The most recently installed tracer (running or stopped)."""
    return _LAST


def span(name: str, /, **args) -> "_Span | _NoopSpan":
    """Context manager for one named span.  With tracing disabled this is
    a shared no-op — the caller's code path is identical either way."""
    tracer = _ACTIVE
    if tracer is None:
        return _NOOP
    return _Span(tracer, name, args)


def export(path: str) -> Optional[str]:
    """Write the last tracer's Chrome-trace JSON; None if nothing traced."""
    t = _LAST
    if t is None:
        return None
    return t.export(path)


# ---------------------------------------------------------------------------
# trace analysis (shared by the report section and the --summarize CLI)
# ---------------------------------------------------------------------------

def phase_breakdown(events: List[Dict],
                    root: Optional[str] = None) -> Dict:
    """Aggregate a trace's spans per name; optionally scoped to the last
    top-level span called ``root`` (e.g. ``"sweep"``).

    Returns ``{"root": {...} | None, "wall_us", "coverage",
    "phases": {name: {"total_us", "count", "frac_of_wall"}}}`` where
    ``coverage`` is the fraction of the wall interval covered by the
    union of top-level (depth-0) spans — the acceptance metric for "the
    trace attributes >= 95% of the run".
    """
    evs = [e for e in events if e.get("ph") == "X"]
    if not evs:
        return {"root": None, "wall_us": 0.0, "coverage": 0.0, "phases": {}}
    wall_lo = min(e["ts"] for e in evs)
    wall_hi = max(e["ts"] + e["dur"] for e in evs)
    wall = wall_hi - wall_lo

    root_ev = None
    if root is not None:
        roots = [e for e in evs if e["name"] == root]
        if roots:
            root_ev = max(roots, key=lambda e: e["ts"])
            lo, hi = root_ev["ts"], root_ev["ts"] + root_ev["dur"]
            evs = [e for e in evs
                   if e["tid"] == root_ev["tid"]
                   and e["ts"] >= lo and e["ts"] + e["dur"] <= hi + 1e-6]

    # coverage = union of the attributing spans over the reference wall:
    # with a root, its direct children over the root's own interval
    # (how much of the sweep the child phases attribute); without one,
    # the top-level (depth-0) spans over the whole trace wall (how much
    # of the run the trace attributes at all)
    cov_depth = (root_ev["args"].get("depth", 0) + 1) if root_ev else 0
    tops = sorted(
        ((e["ts"], e["ts"] + e["dur"]) for e in evs
         if e.get("args", {}).get("depth", 0) == cov_depth),
        key=lambda iv: iv[0])
    covered, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in tops:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    denom = root_ev["dur"] if root_ev else wall

    phases: Dict[str, Dict] = {}
    for e in evs:
        if e is root_ev:
            continue
        p = phases.setdefault(e["name"], {"total_us": 0.0, "count": 0})
        p["total_us"] += e["dur"]
        p["count"] += 1
    for p in phases.values():
        p["frac_of_wall"] = p["total_us"] / denom if denom else 0.0
    return {
        "root": root_ev["name"] if root_ev else None,
        "wall_us": denom,
        "coverage": covered / denom if denom else 0.0,
        "phases": phases,
    }
