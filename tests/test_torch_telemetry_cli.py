"""The port's dispatch instrumentation, the engine's spans, the telemetry
CLI (``python -m repro_torch.telemetry``) and the sweep CLI's
``--trace``/``--metrics``/``--serve``/``--seq``/``--devices``, against the
reference's ``repro.telemetry`` where both have the same function.

Tracing only observes: an untraced ``dispatch`` is ``fn(*args)``, and a
traced run's artifact bytes equal an untraced run's, batched and
``--seq``."""

import io
import json
import os

import pytest
import torch

from repro.telemetry import __main__ as ref_cli
from repro_torch.experiments import engine, run, runner
from repro_torch.experiments.spec import (DatasetSpec, EpsilonSpec, JobSpec,
                                          SweepSpec)
from repro_torch.service.http import ServiceServer
from repro_torch.telemetry import __main__ as cli
from repro_torch.telemetry import instrument, trace
from repro_torch.telemetry.recorder import RECORDER

from _torch_threads import one_torch_thread  # noqa: F401


def _spec(name="tcli_tiny"):
    return SweepSpec(
        name=name, description="telemetry CLI unit spec", ms=(1, 2, 4),
        iters=40, eval_every=20,
        datasets={"d0": DatasetSpec("higgs_like", {"n": 160, "d": 8})},
        jobs=(JobSpec("minibatch", "d0"), JobSpec("ecd_psgd", "d0"),
              JobSpec("hogwild", "d0", {"gamma": 0.05}, predict=True)),
        epsilon=EpsilonSpec(probe_m=1, frac=0.7), n_seeds=2).validate()


def _traced(fn):
    trace.start()
    try:
        out = fn()
    finally:
        tracer = trace.stop()
    return out, tracer.events


def _inside(child, parent):
    return (child["tid"] == parent["tid"]
            and child["args"]["depth"] == parent["args"]["depth"] + 1
            and child["ts"] >= parent["ts"] - 1e-3
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + 1e-3)


# ---------------------------------------------------------------------------
# instrument
# ---------------------------------------------------------------------------

def test_untraced_dispatch_is_the_plain_call(monkeypatch):
    assert trace.active() is None

    def no_span(*a, **k):
        raise AssertionError("an untraced dispatch opened a span")

    monkeypatch.setattr(trace, "span", no_span)
    monkeypatch.setattr(torch.cuda, "synchronize", no_span)
    sentinel = object()
    seen = []

    def fn(*args):
        seen.append(args)
        return sentinel

    assert instrument.dispatch(fn, 1, 2, span_name="bucket", m_pad=4) \
        is sentinel
    assert instrument.timed_call(fn, 3, span_name="grid_member") is sentinel
    assert seen == [(1, 2), (3,)]


def test_traced_dispatch_has_an_execute_child():
    x = torch.ones(3)
    out, events = _traced(lambda: instrument.dispatch(
        torch.add, x, x, span_name="bucket", m_pad=4, members=2))
    assert torch.equal(out, x + x)
    (bucket,) = [e for e in events if e["name"] == "bucket"]
    (execute,) = [e for e in events if e["name"] == "execute"]
    assert bucket["args"]["m_pad"] == 4 and bucket["args"]["members"] == 2
    assert _inside(execute, bucket)


@pytest.mark.parametrize("per_m", [False, True])
def test_traced_sweep_nests_grid_bucket_execute(per_m):
    from repro_torch import random as R
    from repro_torch.data import synth
    ds = synth.get_generator("higgs_like")(R.PRNGKey(0, device="cpu"),
                                           n=160, d=8)
    tr, te = ds.split(key=R.PRNGKey(0, device="cpu"))
    kw = dict(iters=40, eval_every=20, per_m=per_m, n_seeds=2)
    plain = engine.sweep("ecd_psgd", tr, te, [1, 2, 4], **kw)
    seq = RECORDER.snapshot()["seq"]
    traced, events = _traced(
        lambda: engine.sweep("ecd_psgd", tr, te, [1, 2, 4], **kw))
    assert traced == plain
    (grid,) = [e for e in events if e["name"] == "grid"]
    assert grid["args"] == {**grid["args"], "algorithm": "ecd_psgd",
                            "members": 3, "n_seeds": 2}
    inner = "grid_member" if per_m else "bucket"
    groups = [e for e in events if e["name"] == inner]
    assert len(groups) == (3 if per_m else len(engine._buckets([1, 2, 4])))
    assert all(_inside(g, grid) for g in groups)
    if not per_m:
        executes = [e for e in events if e["name"] == "execute"]
        assert all(any(_inside(x, g) for x in executes) for g in groups)
    pads = [e for e in RECORDER.snapshot(since=seq)["events"]
            if e["kind"] == "grid"]
    assert pads and pads[-1]["members"] == 3


@pytest.mark.parametrize("per_m", [False, True])
def test_traced_artifact_bytes_equal_untraced(tmp_path, per_m):
    spec = _spec(f"tcli_bytes_{int(per_m)}")

    def sweep(where):
        return runner.run_sweep(spec, device="cpu", per_m=per_m,
                                cache_dir=str(tmp_path / where))

    plain = sweep("plain")
    traced, events = _traced(lambda: sweep("traced"))
    with open(plain["cache"]["path"], "rb") as a, \
            open(traced["cache"]["path"], "rb") as b:
        assert a.read() == b.read()
    names = {e["name"] for e in events}
    assert {"sweep", "datasets", "job", "grid", "store"} <= names
    assert ("grid_member" if per_m else "bucket") in names


# ---------------------------------------------------------------------------
# the telemetry CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trace_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    spec = _spec("tcli_trace")
    _, _ = _traced(lambda: runner.run_sweep(spec, device="cpu",
                                            use_cache=False))
    trace.export(path)
    return path


def test_summarize_matches_reference(trace_file):
    mine = cli.summarize(trace_file)
    ref = ref_cli.summarize(trace_file)
    assert mine == ref
    assert mine["last_sweep"]["root"] == "sweep"
    assert mine["overall"]["coverage"] > 0.95


def test_summarize_passes_and_fails_min_coverage(trace_file, capsys):
    assert cli.main(["--summarize", trace_file, "--min-coverage",
                     "0.95"]) == 0
    out = capsys.readouterr().out
    assert "last 'sweep' span" in out and "bucket" in out
    assert cli.main(["--summarize", trace_file, "--min-coverage",
                     "1.01"]) == 1
    assert "FAIL: coverage" in capsys.readouterr().err


def test_summarize_rejects_a_malformed_trace(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x", "ph": "X"}]}))
    assert cli.main(["--summarize", str(bad)]) == 2
    assert "missing required keys" in capsys.readouterr().err
    junk = tmp_path / "junk.json"
    junk.write_text("{not json")
    assert cli.main(["--summarize", str(junk)]) == 2


def test_registry_dump_formats(capsys):
    import repro_torch.experiments.runner  # noqa: F401  (registers metrics)
    assert cli.main(["--format", "json", "--prefix", "repro_sweep"]) == 0
    dumped = json.loads(capsys.readouterr().out)
    assert dumped and all(k.startswith("repro_sweep") for k in dumped)
    assert cli.main(["--prefix", "repro_sweep_computes"]) == 0
    assert "# TYPE repro_sweep_computes_total counter" in \
        capsys.readouterr().out


def test_watch_tails_a_local_plane():
    RECORDER.publish("grid", members=3, pad_waste=0.25)
    with ServiceServer(None, port=0) as server:
        out = io.StringIO()
        assert cli.watch(server.url, interval=0.01, max_polls=2,
                         out=out) == 0
    lines = out.getvalue().splitlines()
    assert any("grid" in ln and "pad_waste=0.25" in ln for ln in lines)
    assert cli.watch("http://127.0.0.1:9", max_polls=1,
                     out=io.StringIO()) == 2


def test_event_lines_match_reference():
    ev = {"seq": 7, "t": 0.0, "kind": "race", "m": 8, "devices": 8,
          "psum_rounds": 208}
    assert cli._format_event(ev) == ref_cli._format_event(ev)


# ---------------------------------------------------------------------------
# the sweep CLI's observability flags
# ---------------------------------------------------------------------------

def test_run_cli_trace_metrics_serve_devices(tmp_path, capsys,
                                              monkeypatch):
    monkeypatch.setattr(run.registry, "get_spec",
                        lambda name, **kw: _spec("tcli_cli"))
    path = str(tmp_path / "run.json")
    assert run.main(["--spec", "tcli_cli", "--device", "cpu", "--no-cache",
                     "--trace", path, "--metrics", "--serve", "0",
                     "--devices", "1"]) == 0
    out = capsys.readouterr().out
    assert "mesh: 1 x cpu device [cpu] — single-device fallback" in out
    assert "observability plane at http://127.0.0.1:" in out
    assert f"wrote trace {path}" in out
    assert "# TYPE repro_sweep_computes_total counter" in out
    assert cli.main(["--summarize", path, "--min-coverage", "0.95"]) == 0
    with pytest.raises(SystemExit):
        run.main(["--spec", "tcli_cli", "--device", "cpu",
                  "--devices", "many"])
    assert os.path.exists(path)
