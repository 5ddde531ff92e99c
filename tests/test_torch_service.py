"""The port's advisor service (`repro_torch.service`) against the
reference's: the same ProbeRequests through both services, with the same
cache history, give equal tiers, statuses and integer m_max (analytic
confidence within 1e-6 once it comes from the regression); escalations
dedup to one sweep; overflow is shed; the CLI and the HTTP transport
answer, and ``/metrics`` parses under both packages' strict parsers."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.experiments.spec import DatasetSpec as JDatasetSpec
from repro.service.api import AdvisorService as JService
from repro.service.api import ProbeRequest as JRequest
from repro.telemetry.metrics import parse_prometheus_text as j_parse
from repro_torch.experiments import runner
from repro_torch.experiments.spec import DatasetSpec
from repro_torch.service import __main__ as cli
from repro_torch.service.api import AdvisorService, ProbeRequest
from repro_torch.service.http import ServiceServer
from repro_torch.telemetry import trace
from repro_torch.telemetry.metrics import parse_prometheus_text

RNG = np.random.default_rng(11)
STRATEGIES = ("hogwild", "sync", "dadm", "momentum", "local_sgd", "svrg")
SMALL = dict(sweep_iters=50, sweep_eval_every=10, n_slots=4)


def make_service(tmp_path, **kw):
    kw.setdefault("cache_dir", str(tmp_path / "cache"))
    return AdvisorService(device="cpu", **SMALL, **kw)


def _pair(tmp_path, **kw):
    port = AdvisorService(device="cpu", cache_dir=str(tmp_path / "port"),
                          **SMALL, **kw)
    ref = JService(cache_dir=str(tmp_path / "ref"), **SMALL, **kw)
    return port, ref


def _requests(spec_cls, request_cls, Xs, datasets, escalate=None,
              algorithm="hogwild"):
    reqs = [request_cls(X=X, request_id=f"x{i}") for i, X in enumerate(Xs)]
    reqs += [request_cls(dataset=spec_cls(*d), escalate=escalate,
                         algorithm=algorithm, request_id=f"d{i}")
             for i, d in enumerate(datasets)]
    return reqs


def _assert_same(got, ref, conf_tol=0.0):
    assert [r.request_id for r in got] == [r.request_id for r in ref]
    for g, r in zip(got, ref):
        assert (g.status, g.tier) == (r.status, r.tier), g.request_id
        assert g.confidence == pytest.approx(r.confidence, abs=conf_tol)
        assert g.confidence_detail.get("source") == \
            r.confidence_detail.get("source")
        assert g.note == r.note
        if r.status == "invalid":
            assert g.report == r.report
        elif "predicted_m_max_sync" in r.report:
            for k in ("predicted_m_max_sync", "predicted_m_max_stale"):
                assert g.report[k] == r.report[k], k
        else:
            for strat in STRATEGIES:
                assert g.report[strat]["predicted_m_max"] == \
                    r.report[strat]["predicted_m_max"], (g.request_id, strat)
            assert g.report["recommendation"] == r.report["recommendation"]
        if r.escalation is not None:
            for k in ("measured_m_max", "status", "healthy", "cache_hit",
                      "job_key", "sweep"):
                assert g.escalation[k] == r.escalation[k], k
            assert g.escalation["predicted"]["predicted_m_max"] == \
                r.escalation["predicted"]["predicted_m_max"]


XS = [RNG.normal(size=(40, 6)),
      (RNG.random(size=(30, 70)) > 0.9) * RNG.normal(size=(30, 70)),
      np.full((4, 3), np.nan), np.zeros((1, 3))]
DATASETS = [("higgs_like", {"n": 64, "d": 8}, 0),
            ("realsim_like", {"n": 96, "d": 40, "density": 0.1}, 1)]


def test_analytic_answers_match_reference(tmp_path):
    """Raw, oversize, invalid and spec probes plus a gradient probe in one
    batch: equal tiers, statuses, notes and integer m_max; no sweep."""
    port, ref = _pair(tmp_path)
    grads = [[RNG.normal(size=(6,))] for _ in range(4)]
    before = runner.SWEEP_COMPUTES
    got = port.probe_batch(
        _requests(DatasetSpec, ProbeRequest, XS, DATASETS)
        + [ProbeRequest(grads=grads, request_id="g"),
           ProbeRequest(X=XS[0], escalate=True, request_id="raw-esc")])
    want = ref.probe_batch(
        _requests(JDatasetSpec, JRequest, XS, DATASETS)
        + [JRequest(grads=grads, request_id="g"),
           JRequest(X=XS[0], escalate=True, request_id="raw-esc")])
    _assert_same(got, want)
    assert [r.status for r in got].count("invalid") == 2
    assert "escalation unavailable" in got[-1].note
    assert port.batcher.stats()["fallback"] == 1        # the 30 x 70 probe
    assert runner.SWEEP_COMPUTES == before


def test_escalations_and_regression_confidence_match_reference(tmp_path):
    """Six escalations over distinct datasets give the same measured and
    predicted m_max in both services; with that history in each cache,
    the next analytic answers route the same way at confidences within
    1e-6 from the regression."""
    port, ref = _pair(tmp_path)
    for i in range(6):
        ds = ("higgs_like", {"n": 48 + 8 * i, "d": 8}, i)
        got = port.probe_batch(_requests(DatasetSpec, ProbeRequest, [], [ds],
                                         escalate=True))
        want = ref.probe_batch(_requests(JDatasetSpec, JRequest, [], [ds],
                                         escalate=True))
        _assert_same(got, want)
        assert got[0].tier == "measured" and got[0].escalation["healthy"]
    got = port.probe_batch(_requests(DatasetSpec, ProbeRequest, XS[:2],
                                     DATASETS))
    want = ref.probe_batch(_requests(JDatasetSpec, JRequest, XS[:2],
                                     DATASETS))
    _assert_same(got, want, conf_tol=1e-6)
    assert got[0].confidence_detail["source"] == "regression"
    assert got[0].confidence_detail["n_points"] == 6
    assert port.stats()["tiers"]["model"]["n_points"] == 6


def test_concurrent_shared_fingerprint_runs_one_sweep(tmp_path):
    svc = make_service(tmp_path)
    ds = DatasetSpec("higgs_like", {"n": 64, "d": 8}, seed=3)
    before = runner.SWEEP_COMPUTES
    responses, lock = [], threading.Lock()

    def go():
        r = svc.probe(ProbeRequest(dataset=ds, escalate=True,
                                   algorithm="ecd_psgd"))
        with lock:
            responses.append(r)

    threads = [threading.Thread(target=go) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert [r.tier for r in responses] == ["measured"] * 6
    assert runner.SWEEP_COMPUTES - before == 1
    blobs = {json.dumps(r.escalation["artifact"], sort_keys=True,
                        default=float) for r in responses}
    assert len(blobs) == 1
    assert sum(not r.escalation["cache_hit"] for r in responses) == 1


def test_queue_overflow_sheds_with_structured_response(tmp_path):
    svc = make_service(tmp_path, queue_depth=2)
    responses = svc.probe_batch([ProbeRequest(X=RNG.normal(size=(20, 4)))
                                 for _ in range(5)])
    assert [r.status for r in responses] == ["ok"] * 2 + ["overloaded"] * 3
    for r in responses[2:]:
        assert r.tier is None and "admission queue full" in r.note
    assert svc.probe(ProbeRequest(X=RNG.normal(size=(20, 4)))).status == "ok"
    assert svc.queue.stats()["shed"] == 3


def test_cli_analytic_and_escalated(tmp_path, capsys):
    cache = str(tmp_path / "cli-cache")
    args = ["--device", "cpu", "--generator", "higgs_like", "--n", "64",
            "--d", "8", "--cache-dir", cache, "--sweep-iters", "50"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "tier=analytic" in out and '"sweep_computes"' in out
    assert cli.main(args + ["--requests", "2", "--escalate", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert [r["tier"] for r in payload["responses"]] == ["measured"] * 2
    assert [r["escalation"]["cache_hit"] for r in payload["responses"]] \
        == [False, True]
    assert "artifact" not in payload["responses"][0]["escalation"]


def test_service_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdvisorService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--n", "16", "--d", "4"])


# ---------------------------------------------------------------------------
# HTTP transport
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_roundtrip_and_metrics(tmp_path):
    """Probes over the wire answer what in-process calls answer; bad
    requests get structured 400s; /metrics parses under the port's and
    the reference's strict parsers; /healthz, /flight and /trace serve."""
    svc = make_service(tmp_path)
    # a fresh, empty last tracer: /trace must not serve the spans of a
    # test that traced earlier in this process
    trace.start()
    trace.stop()
    with ServiceServer(svc) as srv:
        X = RNG.normal(size=(40, 6)).tolist()
        status, resp = _post(srv.url + "/probe",
                             {"X": X, "request_id": "wire-1"})
        assert status == 200 and resp["tier"] == "analytic"
        direct = svc.probe(ProbeRequest(X=np.asarray(X))).to_dict()
        for strat in STRATEGIES:
            assert resp["report"][strat]["predicted_m_max"] == \
                direct["report"][strat]["predicted_m_max"]
        status, resp = _post(srv.url + "/probe_batch", {"requests": [
            {"dataset": {"generator": "higgs_like",
                         "kwargs": {"n": 64, "d": 8}},
             "escalate": True, "request_id": "esc"},
            {"X": [[1.0, 2.0]], "request_id": "bad"}]})
        assert status == 200
        esc, bad = resp["responses"]
        assert esc["tier"] == "measured" and "artifact" not in \
            esc["escalation"]
        assert bad["status"] == "invalid"
        for payload, code in [({"X": [[1.0]], "bogus": 1}, 400),
                              ({"dataset": {"generator": "no_such_gen"}},
                               400)]:
            assert _post(srv.url + "/probe", payload)[0] == code
        assert _get(srv.url + "/nope")[0] == 404
        status, headers, body = _get(srv.url + "/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
        text = body.decode()
        fams = parse_prometheus_text(text)
        assert j_parse(text).keys() == fams.keys()
        for family in ("repro_service_admitted_total",
                       "repro_service_escalations_total",
                       "repro_sweep_computes_total",
                       "repro_cache_misses_total",
                       "repro_http_requests_total"):
            assert family in fams, family
        _, _, body = _get(srv.url + "/metrics?prefix=repro_service")
        assert all(f.startswith("repro_service")
                   for f in parse_prometheus_text(body.decode()))
        health = json.loads(_get(srv.url + "/healthz")[2])
        assert health["status"] == "ok" and health["service"] is True
        flight = json.loads(_get(srv.url + "/flight?since=0")[2])
        assert any(e["kind"] == "sweep_stored" for e in flight["events"])
        assert _get(srv.url + "/flight?since=xyz")[0] == 400
        assert json.loads(_get(srv.url + "/trace")[2])["traceEvents"] == []
    with ServiceServer(None) as srv:
        status, resp = _post(srv.url + "/probe", {"X": [[1.0]]})
        assert status == 503 and "metrics-only" in resp["error"]
