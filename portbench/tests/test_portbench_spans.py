"""The program's spans on the card: a traced run of the cell splits each
step into forward, recompute, backward and optimizer, which together take
the traced window's time, and timing the spans adds no device launch."""

import time

import pytest
import torch

from _portbench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)
from portbench.harness import cells, compare, train

CELL = "phi3-mini-3.8b.sync"
PHASES = ("forward_ms_per_step.train", "recompute_ms_per_step.train",
          "backward_ms_per_step.train", "optimizer_ms_per_step.train")


def _traced(seed):
    cell = cells.load(CELL)
    readers = {m["name"]: cells.reader(m["name"]) for m in cell.per_layer}
    res = train.run(cell, seed, 10.0, True, "cuda", time.perf_counter(),
                    peaks=cells.peaks(), readers=readers)
    assert all(c["ok"] for c in compare.checks(res["values"],
                                               cell.limits).values())
    return res, cell


@pytest.mark.cuda
def test_spans_split_the_traced_step_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.telemetry import instrument, metrics
    with monkeypatch.context() as m:
        m.setattr(instrument, "_profiling", lambda: False)
        m.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())
        off, _ = _traced(20261019)
    monkeypatch.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())
    on, cell = _traced(20261019)
    assert not any(n in off["metrics"] for n in PHASES)
    window_ms = 1e3 * on["window_s"] / cell.traffic["trace_steps"]
    split = sum(on["metrics"][n] for n in PHASES)
    assert 0.95 * window_ms <= split <= 1.02 * window_ms, (split, window_ms)
    assert on["metrics"]["launches_per_step.train"] == \
        off["metrics"]["launches_per_step.train"]
