"""The port's robust runner and cache against the reference's contracts:
checksummed artifacts with quarantine, the LRU cap, the single-flight
table, the crash journal (torn and foreign lines, byte-identical resume),
retries with per-job status, diverged jobs kept out of the readouts, and
N concurrent callers of one fingerprint computing once.  Checksums and
journal lines are byte-equal to the reference's for the same payload."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.experiments import cache as JC
from repro.resilience import journal as JJ
from repro_torch.analysis import fit
from repro_torch.experiments import cache as artifact_cache
from repro_torch.experiments import engine, runner
from repro_torch.experiments.spec import (DatasetSpec, EpsilonSpec, JobSpec,
                                          SweepSpec, fingerprint)
from repro_torch.resilience import journal
from repro_torch.telemetry import RECORDER


def _tiny_spec(name, **kw):
    kw.setdefault("ms", (1, 2))
    kw.setdefault("iters", 40)
    kw.setdefault("eval_every", 20)
    kw.setdefault("datasets",
                  {"d0": DatasetSpec("higgs_like", {"n": 96, "d": 8})})
    kw.setdefault("jobs", (JobSpec("minibatch", "d0"),))
    return SweepSpec(name=name, **kw).validate()


def _run(spec, cache_dir, **kw):
    return runner.run_sweep(spec, device="cpu", cache_dir=str(cache_dir),
                            **kw)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# artifact checksums, quarantine, LRU cap, single-flight table
# ---------------------------------------------------------------------------

def test_checksum_matches_reference_and_quarantines(tmp_path):
    spec = _tiny_spec("res_sum")
    res = _run(spec, tmp_path)
    path = res["cache"]["path"]
    with open(path) as f:
        payload = json.load(f)
    assert payload["checksum"] == artifact_cache._payload_checksum(payload)
    assert payload["checksum"] == JC._payload_checksum(payload)
    assert artifact_cache.load(str(tmp_path), spec.name,
                               fingerprint(spec)) is not None

    raw = _bytes(path)
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])                 # torn write
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert artifact_cache.load(str(tmp_path), spec.name,
                                   fingerprint(spec)) is None
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    again = _run(spec, tmp_path)
    assert again["cache"]["hit"] is False
    assert _bytes(again["cache"]["path"]) == raw
    assert _run(spec, tmp_path)["cache"]["hit"]


def test_checksum_detects_mutation_and_legacy_loads(tmp_path):
    spec = _tiny_spec("res_mut")
    path = _run(spec, tmp_path)["cache"]["path"]
    with open(path) as f:
        payload = json.load(f)
    legacy = {k: v for k, v in payload.items() if k != "checksum"}
    payload["jobs"]["minibatch/d0"]["losses"][0][0] += 1e-9
    with open(path, "w") as f:
        json.dump(payload, f)                        # checksum left stale
    with pytest.warns(RuntimeWarning, match="checksum mismatch"):
        assert artifact_cache.load(str(tmp_path), spec.name,
                                   fingerprint(spec)) is None
    assert os.path.exists(path + ".corrupt")
    with open(path, "w") as f:
        json.dump(legacy, f)                         # no checksum at all
    assert _run(spec, tmp_path)["cache"]["hit"] is True


def test_lru_cap_evicts_least_recently_used(tmp_path, monkeypatch):
    monkeypatch.setattr(artifact_cache, "_EVICTION_WARNED", False)
    d = str(tmp_path)
    paths = []
    for i in range(3):
        paths.append(artifact_cache.store(d, f"a{i}", f"{i:064d}", {"i": i}))
        os.utime(paths[-1], (1000 + i, 1000 + i))
    assert artifact_cache.list_artifacts(d) == paths
    assert artifact_cache.load(d, "a0", f"{0:064d}")["i"] == 0   # bump a0
    with pytest.warns(RuntimeWarning, match="exceeded its cap"):
        newest = artifact_cache.store(d, "a3", f"{3:064d}", {"i": 3},
                                      max_artifacts=2)
    assert sorted(artifact_cache.list_artifacts(d)) == \
        sorted([paths[0], newest])
    # the warning is one-shot; keep= protects the fresh store
    assert artifact_cache.enforce_cap(d, 0, keep=newest) == [paths[0]]
    assert artifact_cache.list_artifacts(d) == [newest]


def test_inflight_table_lease_wait_release():
    table = artifact_cache.InFlightTable()
    assert table.wait("fp") is True                  # nothing in flight
    assert table.lease("fp") is True
    assert table.lease("fp") is False
    assert table.n_inflight == 1
    assert table.wait("fp", timeout=0.01) is False
    woke = []
    t = threading.Thread(target=lambda: woke.append(table.wait("fp", 30)))
    t.start()
    time.sleep(0.05)
    table.release("fp")
    t.join(timeout=30)
    assert not t.is_alive() and woke == [True]
    assert table.n_inflight == 0 and table.lease("fp") is True


# ---------------------------------------------------------------------------
# crash journal
# ---------------------------------------------------------------------------

def test_journal_lines_match_reference_and_skip_torn(tmp_path):
    fp = "f" * 64
    path = journal.journal_path(str(tmp_path), "j", fp)
    assert path == JJ.journal_path(str(tmp_path), "j", fp)
    journal.append_entry(path, fp, "good", {"x": 1.5, "ys": [0.1, 2]})
    ref_path = str(tmp_path / "ref.jsonl")
    JJ.append_entry(ref_path, fp, "good", {"x": 1.5, "ys": [0.1, 2]})
    assert _bytes(path) == _bytes(ref_path)
    journal.append_entry(path, "0" * 64, "foreign", {"x": 2})
    with open(path, "a") as f:
        f.write('{"fingerprint": "' + fp + '", "key": "torn')
    assert journal.read_entries(path, fp) == {"good": {"x": 1.5,
                                                        "ys": [0.1, 2]}}
    assert journal.read_entries(str(tmp_path / "missing"), fp) == {}
    journal.consume(path)
    assert not os.path.exists(path)
    journal.consume(path)                            # idempotent


def test_journal_resume_is_byte_identical(tmp_path, monkeypatch):
    """Crash after job 1 of 2 (a KeyboardInterrupt, which the retry loop
    must not swallow), then re-run: only job 2 computes, its journaled
    neighbour is replayed, and the artifact is byte-identical to an
    uninterrupted run's."""
    spec = _tiny_spec(
        "res_resume",
        jobs=(JobSpec("minibatch", "d0"),
              JobSpec("hogwild", "d0", {"gamma": 0.05}, predict=True)),
        epsilon=EpsilonSpec(probe_m=1, frac=0.7))
    golden = _bytes(_run(spec, tmp_path / "a")["cache"]["path"])
    real = engine.sweep
    calls = []

    def crashing(*args, **kwargs):
        calls.append(args)
        if len(calls) == 2:
            raise KeyboardInterrupt("simulated kill")
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "sweep", crashing)
    with pytest.raises(KeyboardInterrupt):
        _run(spec, tmp_path / "b")
    jpath = journal.journal_path(str(tmp_path / "b"), spec.name,
                                 fingerprint(spec))
    assert len(journal.read_entries(jpath, fingerprint(spec))) == 1

    counted = []
    monkeypatch.setattr(engine, "sweep",
                        lambda *a, **k: counted.append(a) or real(*a, **k))
    seq = RECORDER.snapshot()["seq"]
    resumed = _run(spec, tmp_path / "b")
    assert len(counted) == 1
    assert [e["job"] for e in RECORDER.snapshot(since=seq)["events"]
            if e["kind"] == "job_replayed"] == ["minibatch/d0"]
    assert _bytes(resumed["cache"]["path"]) == golden
    assert not os.path.exists(jpath)


def test_journal_disabled_or_uncached_writes_nothing(tmp_path):
    spec = _tiny_spec("res_noj")
    jpath = journal.journal_path(str(tmp_path), spec.name, fingerprint(spec))
    _run(spec, tmp_path, journal=False)
    runner.run_sweep(spec, device="cpu", use_cache=False,
                     cache_dir=str(tmp_path))
    assert not os.path.exists(jpath)


# ---------------------------------------------------------------------------
# retries and per-job status
# ---------------------------------------------------------------------------

def _flaky(monkeypatch, exc, times):
    real = engine.sweep
    calls = []

    def flaky(*args, **kwargs):
        calls.append(args)
        if len(calls) <= times:
            raise exc
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "sweep", flaky)
    return calls


@pytest.mark.parametrize("exc", [
    RuntimeError("transient device loss"),
    torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")])
def test_transient_failure_retries_to_ok(tmp_path, monkeypatch, exc):
    spec = _tiny_spec("res_retry")
    clean = _run(spec, tmp_path / "clean")
    calls = _flaky(monkeypatch, exc, 1)
    res = _run(spec, tmp_path / "flaky", retry_backoff_s=0.0)
    jr = res["jobs"]["minibatch/d0"]
    assert len(calls) == 2 and jr["status"] == "retried:1"
    assert runner.job_is_healthy(jr)
    assert jr["losses"] == clean["jobs"]["minibatch/d0"]["losses"]


def test_permanent_failure_becomes_structured_stub(tmp_path, monkeypatch):
    spec = _tiny_spec("res_fail", epsilon=EpsilonSpec(probe_m=1))
    _flaky(monkeypatch, RuntimeError("device pool gone"), 99)
    with pytest.warns(RuntimeWarning, match="failed after 2 attempt"):
        res = _run(spec, tmp_path, retry_backoff_s=0.0)
    jr = res["jobs"]["minibatch/d0"]
    assert jr["status"] == "failed" and "device pool gone" in jr["error"]
    assert not runner.job_is_healthy(jr)
    assert "losses" not in jr and "measured_m_max" not in jr
    assert _run(spec, tmp_path)["cache"]["hit"]


def test_device_fault_is_not_retried(tmp_path, monkeypatch):
    """A CUDA error other than running out of memory leaves the context
    unusable: one attempt, then a failed job — never a loop."""
    spec = _tiny_spec("res_fault")
    calls = _flaky(monkeypatch, RuntimeError(
        "CUDA error: an illegal memory access was encountered"), 99)
    with pytest.warns(RuntimeWarning, match="failed after 1 attempt"):
        res = _run(spec, tmp_path, max_retries=3, retry_backoff_s=0.0)
    assert len(calls) == 1
    assert res["jobs"]["minibatch/d0"]["status"] == "failed"


def test_diverged_job_excluded_from_readouts(tmp_path):
    """A diverged cell keeps its curves and a 'diverged' status but stays
    out of the readouts, the predictor and the characters regression; its
    healthy neighbour reads exactly what it reads without it."""
    good = JobSpec("minibatch", "d0", predict=True)
    bad = JobSpec("minibatch", "wide", {"gamma": 0.1}, problem="ridge",
                  label="bad")
    eps = EpsilonSpec(probe_m=1, frac=0.7)
    d0 = DatasetSpec("higgs_like", {"n": 100, "d": 8})
    mixed_spec = _tiny_spec(
        "res_mixed", jobs=(good, bad), iters=120, epsilon=eps,
        datasets={"d0": d0,
                  "wide": DatasetSpec("higgs_like", {"n": 120, "d": 28})})
    clean_spec = _tiny_spec("res_clean", jobs=(good,), iters=120,
                            epsilon=eps, datasets={"d0": d0})
    with pytest.warns(RuntimeWarning, match="non-finite"):
        mixed = _run(mixed_spec, tmp_path, retry_backoff_s=0.0)
    clean = _run(clean_spec, tmp_path)
    jr_bad = mixed["jobs"]["minibatch[bad]+ridge/wide"]
    assert jr_bad["status"] == "diverged" and "losses" in jr_bad
    assert not {"epsilon", "measured_m_max", "predicted"} & set(jr_bad)
    jr_good, jr_ref = mixed["jobs"]["minibatch/d0"], \
        clean["jobs"]["minibatch/d0"]
    assert jr_good["status"] == "ok"
    assert jr_good["measured_m_max"] == jr_ref["measured_m_max"]
    assert jr_good["epsilon"] == jr_ref["epsilon"]
    points = fit.collect_character_points([mixed])
    assert [p["job"] for p in points] == ["minibatch/d0"]


def test_job_status_health():
    assert runner.job_is_healthy({"losses": [[0.1]]})
    assert runner.job_is_healthy({"status": "retried:2"})
    assert not runner.job_is_healthy({"status": "diverged"})
    assert not runner.job_is_healthy({"status": "failed"})


# ---------------------------------------------------------------------------
# single-flight dedup
# ---------------------------------------------------------------------------

def test_concurrent_callers_of_one_fingerprint_compute_once(tmp_path):
    """12 threads race on one fingerprint under a short switch interval:
    exactly one compute, one leader, and every caller reads the same
    artifact."""
    spec = _tiny_spec("res_dedup", jobs=(JobSpec("minibatch", "d0"),
                                         JobSpec("dadm", "d0")))
    before = runner.SWEEP_COMPUTES
    results, errors = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(12)

    def go():
        try:
            barrier.wait(timeout=30)
            r = _run(spec, tmp_path, dedup=True)
            with lock:
                results.append(r)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=go) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert runner.SWEEP_COMPUTES - before == 1
    assert sum(not r["cache"]["hit"] for r in results) == 1
    jobs = {json.dumps(r["jobs"], sort_keys=True) for r in results}
    assert len(jobs) == 1
    assert runner._INFLIGHT.n_inflight == 0
    assert np.isfinite(results[0]["jobs"]["dadm/d0"]["losses"]).all()
