"""Device-aware tracing helpers (the port's counterpart of
``repro/telemetry/instrument.py``).

The reference splits a traced dispatch into ``lower`` / ``compile`` /
``execute`` children through jax's AOT path.  The port compiles nothing
per call: its one compile is the first-use build of the CUDA extension,
which `repro_torch.kernels.build` traces as a ``compile`` span wherever
it happens.  So a traced :func:`dispatch` here has one child,
``execute``, closed after ``torch.cuda.synchronize`` on every CUDA device
the result lives on, so that it measures the device work and not the
asynchronous enqueue.

With no tracer installed both helpers are exactly ``fn(*args)``: no clock
read and no synchronisation, so the untraced sweep keeps its sync-free
steps and tracing never changes a result.

A training step cannot wait for the device at each layer, so its spans
(:func:`step`, :func:`span`) are timed on the device instead: a CUDA
event recorded on the current stream at entry and at exit, never a
synchronisation (the host clock on a CPU tensor path).  A pair resolves
once the device has passed both events, at the next live step's entry
(the loss read orders every event of a step before it) or, waiting for
the device, when :func:`span_totals` reads the totals.  A resolved span
adds its seconds and a call to the process registry's
``repro_train_span_device_seconds_total{span, phase}`` and
``repro_train_span_calls_total{span, phase}``; a live step counts in
``repro_train_traced_steps_total``.

A step is live while the port's tracer runs or a ``torch.profiler``
session records, decided once at its entry and held until its exit (a
non-reentrant checkpoint's recompute must build the graph its first pass
built).  Off, :func:`span` is one module-global read returning the shared
no-op: no event, no clock read, no autograd node.  Under the port's
tracer each span also opens a ``record_function`` range of its name and
records a tracer event whose args carry ``device_ms`` and ``phase``;
under a profiler alone it opens no range, so the profile's device
activity holds only the step's own work.

A span's phase is ``forward``, or ``recompute`` when it runs inside a
backward pass (a checkpoint's recompute), unless the caller names it:
``train.backward`` and attention's backward are ``backward``,
``train.optimizer`` is ``optimizer``, the step itself ``step``.

This module imports torch (for the synchronisation and the events);
`trace` and `metrics` stay stdlib-only.
"""

from __future__ import annotations

import threading
import time

import torch

from repro_torch.telemetry import metrics, trace

SECONDS = "repro_train_span_device_seconds_total"
CALLS = "repro_train_span_calls_total"
STEPS = "repro_train_traced_steps_total"


def _cuda_devices(out, found=None):
    """The CUDA devices of every tensor in ``out`` (a tensor or nested
    tuples and lists of them)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for item in out:
            _cuda_devices(item, found)
    return found


def _wait(out) -> None:
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def dispatch(fn, *args, span_name: str = "bucket", **attrs):
    """Call ``fn(*args)``; under an active tracer, emit a ``span_name``
    span whose ``execute`` child ends when the result's devices are done."""
    if trace.active() is None:
        return fn(*args)
    with trace.span(span_name, **attrs):
        with trace.span("execute"):
            out = fn(*args)
            _wait(out)
    return out


def timed_call(fn, *args, span_name: str = "execute", **attrs):
    """One span around ``fn(*args)``, ended after the result's devices
    are done (the per-member calls of the sequential path)."""
    if trace.active() is None:
        return fn(*args)
    with trace.span(span_name, **attrs):
        out = fn(*args)
        _wait(out)
    return out


# ---------------------------------------------------------------------------
# device-timed spans of the training step
# ---------------------------------------------------------------------------

class _Live:
    """What a live step's spans share: the clock (CUDA events or the host
    clock) and the port's tracer, None when only a profiler records."""

    __slots__ = ("cuda", "tracer")

    def __init__(self, cuda, tracer):
        self.cuda, self.tracer = cuda, tracer


#: the live step; None: every span is the shared no-op
_STEP = None
#: spans whose end event the device may not have reached: (name, phase,
#: start event, end event, the tracer's record or None)
_PENDING = []
_LOCK = threading.Lock()


def _profiling() -> bool:
    return (torch.autograd.profiler._is_profiler_enabled
            or torch._C._autograd._profiler_enabled())


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def live() -> bool:
    """Whether the running step's spans are timed."""
    return _STEP is not None


def _add(name, phase, seconds, record):
    labels = {"span": name, "phase": phase}
    metrics.REGISTRY.counter(
        SECONDS, "device seconds of the training step's spans",
        labels).inc(seconds)
    metrics.REGISTRY.counter(
        CALLS, "calls of the training step's spans", labels).inc()
    if record is not None:
        tracer, t0, dur, depth = record
        tracer.record(name, t0, dur, depth,
                      {"phase": phase, "device_ms": seconds * 1e3})


def _resolve(wait: bool) -> None:
    """Add every pending span the device has passed (every one, waiting
    for the device, with ``wait``)."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    keep = []
    for item in pending:
        start, end = item[2], item[3]
        if wait:
            end.synchronize()
        elif not (end.query() and start.query()):
            keep.append(item)
            continue
        _add(item[0], item[1], start.elapsed_time(end) / 1e3, item[4])
    if keep:
        with _LOCK:
            _PENDING[:0] = keep


def flush() -> None:
    """Resolve every pending span, waiting for the device."""
    if _PENDING:
        _resolve(wait=True)


trace.add_flush_hook(flush)


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """A live span: a pair of CUDA events (or host-clock stamps) and,
    under the port's tracer, a ``record_function`` range and a tracer
    event."""

    __slots__ = ("_live", "_name", "_phase", "_start", "_host", "_range",
                 "_token")

    def __init__(self, live_step, name, phase):
        self._live, self._name = live_step, name
        self._phase = phase or ("recompute" if _in_backward()
                                else "forward")

    def __enter__(self):
        live_step = self._live
        if live_step.tracer is not None:
            stack = trace._STACK.get()
            self._host = (time.perf_counter_ns(), len(stack))
            self._token = trace._STACK.set(stack + ((self._name,
                                                     self._host[0]),))
            self._range = torch.autograd.profiler.record_function(
                self._name)
            self._range.__enter__()
        self._start = _event() if live_step.cuda else time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        live_step = self._live
        if live_step.cuda:
            end = _event()
        else:
            seconds = (time.perf_counter_ns() - self._start) / 1e9
        record = None
        if live_step.tracer is not None:
            self._range.__exit__(None, None, None)
            trace._STACK.reset(self._token)
            t0, depth = self._host
            record = (live_step.tracer, t0, time.perf_counter_ns() - t0,
                      depth)
        if live_step.cuda:
            with _LOCK:
                _PENDING.append((self._name, self._phase, self._start, end,
                                 record))
        else:
            _add(self._name, self._phase, seconds, record)
        return False


def span(name: str, /, phase=None):
    """A device-timed span of the running step (the shared no-op when the
    step is not live)."""
    live_step = _STEP
    if live_step is None:
        return trace._NOOP
    return _Span(live_step, name, phase)


class _Step:
    """The span of a live step: it makes the step's spans live on entry
    and ends them on exit."""

    __slots__ = ("_live", "_span")

    def __init__(self, live_step, name):
        self._live = live_step
        self._span = _Span(live_step, name, "step")

    def __enter__(self):
        global _STEP
        if self._live.cuda:
            _resolve(wait=False)
        metrics.REGISTRY.counter(STEPS, "training steps timed by span").inc()
        _STEP = self._live
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        global _STEP
        try:
            self._span.__exit__(*exc)
        finally:
            _STEP = None
        return False


def step(name: str, device, /):
    """The span of one whole step on ``device``: live, with every
    :func:`span` inside it, while the port's tracer runs or a profiler
    records; otherwise the shared no-op."""
    tracer = trace.active()
    if tracer is None and not _profiling():
        return trace._NOOP
    return _Step(_Live(torch.device(device).type == "cuda", tracer), name)


def span_totals():
    """Every span's totals, the device waited for first: ``{"steps": live
    steps, "seconds": {(span, phase): device seconds}, "calls": {(span,
    phase): calls}}``."""
    flush()
    reg = metrics.REGISTRY

    def by_span(name):
        return {(labels["span"], labels["phase"]): v
                for labels, v in reg.series(name)}
    steps = sum(v for _, v in reg.series(STEPS))
    return {"steps": steps, "seconds": by_span(SECONDS),
            "calls": by_span(CALLS)}
