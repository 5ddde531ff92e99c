"""The port's telemetry (`repro_torch.telemetry`) against the reference's:
the same sequence of metric operations renders byte-equal Prometheus
text and JSON snapshots in both packages, the strict parser rejects the
same non-conformant text with the same message, spans nest per thread,
the flight recorder's ring keeps its cursor, and the port's runner
publishes its progress events and spans without changing the artifact."""

import json
import sys
import threading

import pytest

from repro.telemetry import metrics as JM
from repro.telemetry import trace as JT
from repro_torch.experiments import runner
from repro_torch.experiments.spec import DatasetSpec, JobSpec, SweepSpec
from repro_torch.telemetry import RECORDER
from repro_torch.telemetry import metrics as TM
from repro_torch.telemetry import trace as TT
from repro_torch.telemetry.recorder import FlightRecorder


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    TT.stop()
    yield
    TT.stop()


def _exercise(mod):
    """One sequence of registry operations, run against either package."""
    reg = mod.MetricsRegistry()
    c = reg.counter("jobs_total", help='finished jobs ("stored")',
                    labels={"status": 'we"ird\\path\nx'})
    c.inc(7)
    reg.counter("jobs_total", labels={"status": "ok"}).inc(2)
    reg.counter("rule:recorded_total").inc()
    g = reg.gauge("depth_now", help="current depth")
    g.set(5)
    g.set_max(3)
    g.dec(0.5)
    h = reg.histogram("lat_seconds", help="latency\nsecond line",
                      buckets=(0.01, 0.1, 1.0), labels={"tier": "a"})
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    reg.histogram("lat_seconds", labels={"tier": "b"},
                  buckets=(0.01, 0.1, 1.0)).observe(0.02)
    reg.histogram("empty_seconds")
    return reg


def test_render_prometheus_byte_equal_to_reference():
    ref, port = _exercise(JM), _exercise(TM)
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    assert port.render_prometheus(prefix="lat") == \
        ref.render_prometheus(prefix="lat")
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    assert TM.parse_prometheus_text(text) == JM.parse_prometheus_text(text)
    fams = TM.parse_prometheus_text(text)
    samples = {v: labels for _, labels, v in fams["jobs_total"]["samples"]}
    assert samples[7] == {"status": 'we"ird\\path\nx'}
    assert TM.MetricsRegistry().render_prometheus() == ""


@pytest.mark.parametrize("bad, msg", [
    ("x_total 3", "newline"),
    ("orphan_metric 1\n", "no preceding # TYPE"),
    ("# TYPE a counter\na 1\n# TYPE a counter\n", "duplicate TYPE"),
    ("# TYPE a counter\na -2\n", "negative"),
    ("# TYPE a wat\n", "unknown type"),
    ("# TYPE a counter\na{l=\"v\" 1\n", "malformed"),
    ("# TYPE a counter\na 1\n# TYPE a gauge extra\n", "malformed TYPE"),
    ("# TYPE h histogram\n"
     'h_bucket{le="1.0"} 2\nh_bucket{le="+Inf"} 3\nh_sum 1\n',
     "missing _sum or _count"),
    ("# TYPE h histogram\n"
     'h_bucket{le="1.0"} 5\nh_bucket{le="+Inf"} 3\nh_sum 1\nh_count 3\n',
     "not cumulative"),
    ("# TYPE h histogram\n"
     'h_bucket{le="1.0"} 2\nh_sum 1\nh_count 2\n', r"\+Inf"),
    ("# TYPE h histogram\n"
     'h_bucket{le="1.0"} 2\nh_bucket{le="+Inf"} 3\nh_sum 1\nh_count 9\n',
     "!= _count"),
])
def test_parser_rejects_what_the_reference_rejects(bad, msg):
    with pytest.raises(ValueError, match=msg) as port:
        TM.parse_prometheus_text(bad)
    with pytest.raises(ValueError) as ref:
        JM.parse_prometheus_text(bad)
    assert str(port.value) == str(ref.value)


def test_registry_kinds_and_name_validation():
    reg = TM.MetricsRegistry()
    c = reg.counter("reqs_total")
    assert reg.counter("reqs_total") is c
    with pytest.raises(TypeError):
        reg.gauge("reqs_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    for bad in ("bad name", "2starts_with_digit"):
        with pytest.raises(ValueError):
            reg.counter(bad)
    with pytest.raises(ValueError):
        reg.counter("ok_total", labels={"bad-label": "v"})


def test_counter_exact_under_threads():
    """16 threads x 2000 increments under a short switch interval land
    exactly 32000."""
    c = TM.MetricsRegistry().counter("race_total")

    def hammer():
        for _ in range(2000):
            c.inc()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 32000


def test_spans_nest_per_thread_and_noop_when_disabled():
    assert TT.span("x") is TT.span("y")              # shared no-op
    tracer = TT.start()
    barrier = threading.Barrier(4)

    def work(i):
        with TT.span("outer", i=i):
            barrier.wait(timeout=30)
            with TT.span("inner", i=i):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    TT.stop()
    evs = tracer.events
    assert len(evs) == 8
    for e in evs:
        assert e["args"]["depth"] == (0 if e["name"] == "outer" else 1)
    for inner in (e for e in evs if e["name"] == "inner"):
        outer = next(e for e in evs if e["name"] == "outer"
                     and e["args"]["i"] == inner["args"]["i"])
        assert outer["tid"] == inner["tid"]
        assert outer["ts"] <= inner["ts"]
        assert (inner["ts"] + inner["dur"]
                <= outer["ts"] + outer["dur"] + 1e-3)


def test_phase_breakdown_matches_reference():
    evs = [{"name": "sweep", "ph": "X", "ts": 0.0, "dur": 100.0, "tid": 1,
            "args": {"depth": 0}},
           {"name": "datasets", "ph": "X", "ts": 0.0, "dur": 30.0, "tid": 1,
            "args": {"depth": 1}},
           {"name": "job", "ph": "X", "ts": 40.0, "dur": 50.0, "tid": 1,
            "args": {"depth": 1}},
           {"name": "job", "ph": "X", "ts": 45.0, "dur": 10.0, "tid": 2,
            "args": {"depth": 0}},
           {"name": "store", "ph": "X", "ts": 120.0, "dur": 5.0, "tid": 1,
            "args": {"depth": 0}}]
    for root in (None, "sweep"):
        assert TT.phase_breakdown(evs, root) == \
            JT.phase_breakdown(evs, root)
    assert TT.phase_breakdown([]) == JT.phase_breakdown([])


def test_flight_recorder_ring_seq_and_cursor():
    rec = FlightRecorder(max_events=4, max_spans=2)
    for i in range(7):
        rec.publish("probe", i=i)
    snap = rec.snapshot()
    assert snap["seq"] == 7 and snap["published"] == 7
    assert [e["i"] for e in snap["events"]] == [3, 4, 5, 6]
    assert [e["i"] for e in rec.snapshot(since=5)["events"]] == [5, 6]
    assert [e["i"] for e in rec.snapshot(limit=2)["events"]] == [5, 6]
    for i in range(3):
        rec.record_span({"name": f"s{i}"})
    assert [s["name"] for s in rec.snapshot()["spans"]] == ["s1", "s2"]
    rec.clear()
    assert rec.snapshot()["events"] == []
    rec.publish("after_clear")
    assert rec.snapshot()["seq"] == 11
    assert rec.stats()["max_events"] == 4


def test_recorder_mirrors_spans_only_while_tracing():
    seq0 = RECORDER.snapshot()["seq"]
    with TT.span("untraced"):
        pass
    assert RECORDER.snapshot(since=seq0)["spans"] == []
    TT.start()
    with TT.span("traced_probe", x=1):
        pass
    TT.stop()
    spans = RECORDER.snapshot(since=seq0)["spans"]
    assert [s["name"] for s in spans] == ["traced_probe"]
    assert spans[0]["args"]["x"] == 1


def _tiny_spec(name):
    return SweepSpec(
        name=name, ms=(1, 2), iters=40, eval_every=20,
        datasets={"d0": DatasetSpec("higgs_like", {"n": 96, "d": 8})},
        jobs=(JobSpec("minibatch", "d0"),
              JobSpec("hogwild", "d0", {"gamma": 0.05}))).validate()


def test_run_sweep_publishes_flight_events_and_spans(tmp_path):
    """A computed sweep leaves sweep_started -> job_started/grid/job_stored
    per job -> sweep_stored in the recorder and the reference's span names
    in the trace; a cache hit publishes nothing; the artifact is
    byte-identical to one computed with tracing off."""
    spec = _tiny_spec("tel_flight")
    untraced = runner.run_sweep(spec, device="cpu",
                                cache_dir=str(tmp_path / "a"))
    seq0 = RECORDER.snapshot()["seq"]
    tracer = TT.start()
    traced = runner.run_sweep(spec, device="cpu",
                              cache_dir=str(tmp_path / "b"))
    TT.stop()
    kinds = [e["kind"] for e in RECORDER.snapshot(since=seq0)["events"]]
    assert kinds == ["sweep_started", "job_started", "grid", "job_stored",
                     "job_started", "grid", "job_stored", "sweep_stored"]
    names = {e["name"] for e in tracer.events}
    assert names == {"sweep", "journal_read", "datasets", "job", "grid",
                     "bucket", "execute", "readout", "journal_append",
                     "store"}
    breakdown = TT.phase_breakdown(tracer.events, root="sweep")
    assert breakdown["phases"]["job"]["count"] == 2
    assert breakdown["coverage"] > 0.5
    with open(untraced["cache"]["path"], "rb") as a, \
            open(traced["cache"]["path"], "rb") as b:
        assert a.read() == b.read()
    seq1 = RECORDER.snapshot()["seq"]
    assert runner.run_sweep(spec, device="cpu",
                            cache_dir=str(tmp_path / "b"))["cache"]["hit"]
    assert RECORDER.snapshot(since=seq1)["events"] == []


def test_runner_counters_are_registry_backed(tmp_path):
    spec = _tiny_spec("tel_counters")
    before = runner.SWEEP_COMPUTES
    appends = TM.REGISTRY.counter("repro_journal_appends_total").value
    runner.run_sweep(spec, device="cpu", cache_dir=str(tmp_path))
    runner.run_sweep(spec, device="cpu", cache_dir=str(tmp_path))
    assert runner.SWEEP_COMPUTES == before + 1
    assert TM.REGISTRY.counter("repro_journal_appends_total").value == \
        appends + 2
    with pytest.raises(AttributeError):
        runner.NO_SUCH_COUNTER
    text = TM.REGISTRY.render_prometheus(prefix="repro_sweep")
    fams = TM.parse_prometheus_text(text)
    assert fams["repro_sweep_computes_total"]["samples"][0][2] == \
        runner.SWEEP_COMPUTES
    # the port's registry is its own: the reference's never sees it
    assert TM.REGISTRY is not JM.REGISTRY
