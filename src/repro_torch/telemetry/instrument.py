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

This module imports torch (for the synchronisation); `trace` and
`metrics` stay stdlib-only.
"""

from __future__ import annotations

import torch

from repro_torch.telemetry import trace


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
