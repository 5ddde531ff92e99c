"""repro_torch.telemetry — spans, metrics and the flight recorder (the
port's copies of ``repro/telemetry/{trace,metrics,recorder}.py``).

  * `trace` — a context-var span tracer, off by default; with tracing
    off every `span()` is a shared no-op, so the sweep runs the same code
    and writes byte-identical artifacts either way.
  * `metrics` — an always-on, thread-safe registry of counters, gauges
    and histograms with JSON and Prometheus text exposition.  Metric
    names keep the reference's ``repro_`` prefix: the HTTP ``/metrics``
    contract is the reference's.
  * `recorder` — bounded rings of sweep progress events and mirrored
    spans (``GET /flight``).
  * `instrument` — the per-bucket dispatch span with its device-synced
    ``execute`` child, and the training step's device-timed spans, whose
    totals land in the registry (imports torch; not imported here).

CLI: ``python -m repro_torch.telemetry`` dumps the process registry,
``--summarize TRACE`` phase-breaks a saved trace and ``--watch URL``
tails a live ``/flight`` plane.

The package imports nothing else of the port, so any module can
instrument itself without cycles.
"""

from repro_torch.telemetry import recorder, trace
from repro_torch.telemetry.metrics import (REGISTRY, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           counter, gauge, histogram)
from repro_torch.telemetry.recorder import RECORDER
from repro_torch.telemetry.trace import span

# the flight recorder mirrors completed spans whenever a tracer runs
trace.add_span_sink(RECORDER.record_span)

__all__ = [
    "trace", "span",
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram",
    "recorder", "RECORDER",
]
