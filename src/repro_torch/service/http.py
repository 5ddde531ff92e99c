"""HTTP transport for the advisor service and the process's telemetry
(port of ``repro/service/http.py``, same routes and JSON shapes).

The handler only decodes JSON into `ProbeRequest` and calls the same
`probe` / `probe_batch` in-process callers use, so bounded admission,
batching and single-flight dedup are unchanged underneath.

  ===========  ======  ==================================================
  path         method  serves
  ===========  ======  ==================================================
  /probe       POST    one JSON ProbeRequest -> one ProbeResponse
  /probe_batch POST    {"requests": [...]} -> {"responses": [...]}
  /metrics     GET     Prometheus text v0.0.4 from the port's registry
                       (``?prefix=repro_service`` filters families)
  /healthz     GET     liveness + admission-queue depth/shed state
  /flight      GET     flight-recorder snapshot (``?since=SEQ`` tails)
  /trace       GET     the tracer's Chrome-trace JSON (``?drain=1`` pops
                       the recorded spans)
  ===========  ======  ==================================================

`ServiceServer` wraps `ThreadingHTTPServer` (a thread per request — the
admission queue is the concurrency bound) behind ``start()``/``stop()``
and a context manager; ``port=0`` binds an ephemeral port reported by
``.port``.  ``service=None`` serves the observability plane alone, and
the probe endpoints answer 503.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from repro_torch.experiments.spec import DatasetSpec
from repro_torch.telemetry import metrics, recorder, trace

#: refuse request bodies beyond this (a raw-X probe of service envelope
#: scale is ~1 MB of JSON; anything bigger is abuse, not a probe)
MAX_BODY_BYTES = 16 * 1024 * 1024

_REQUESTS = {}


def _request_counter(method: str, path: str):
    key = (method, path)
    if key not in _REQUESTS:
        _REQUESTS[key] = metrics.counter(
            "repro_http_requests_total",
            help="HTTP requests served by the observability transport",
            labels={"method": method, "path": path})
    return _REQUESTS[key]


_LATENCY = metrics.histogram(
    "repro_http_request_seconds",
    help="HTTP request handling latency")


class _BadRequest(ValueError):
    """Client error — rendered as a structured 400 JSON body."""


def decode_probe_request(payload: Dict) -> "ProbeRequest":
    """JSON dict -> ProbeRequest.  Wire shape (docs/service.md):

    ``{"X": [[...]], "dataset": {"generator", "kwargs", "seed",
    "shuffle_split", "variant"}, "algorithm", "escalate", "kwargs",
    "request_id"}`` — exactly one of ``X`` / ``dataset`` (full SweepSpec
    probes remain in-process-only: a JSON SweepSpec codec is not worth
    its ambiguity, and a DatasetSpec already reaches the measured tier).
    """
    from repro_torch.service.api import ProbeRequest  # cycle: api -> queue

    if not isinstance(payload, dict):
        raise _BadRequest("probe payload must be a JSON object")
    unknown = set(payload) - {"X", "dataset", "algorithm", "escalate",
                              "kwargs", "request_id"}
    if unknown:
        raise _BadRequest(f"unknown probe fields {sorted(unknown)}")
    dataset = None
    if payload.get("dataset") is not None:
        d = payload["dataset"]
        if not isinstance(d, dict) or "generator" not in d:
            raise _BadRequest('"dataset" must be {"generator": ..., '
                              '"kwargs": {...}, ...}')
        bad = set(d) - {"generator", "kwargs", "seed", "shuffle_split",
                        "variant"}
        if bad:
            raise _BadRequest(f"unknown dataset fields {sorted(bad)}")
        try:
            dataset = DatasetSpec(
                generator=d["generator"], kwargs=dict(d.get("kwargs", {})),
                seed=int(d.get("seed", 0)),
                shuffle_split=bool(d.get("shuffle_split", True)),
                variant=d.get("variant"))
            dataset.validate()
        except (KeyError, TypeError, ValueError) as e:
            raise _BadRequest(f"invalid dataset spec: {e}") from e
    escalate = payload.get("escalate")
    if escalate is not None and not isinstance(escalate, bool):
        raise _BadRequest('"escalate" must be true, false, or omitted')
    kw = {"X": payload.get("X"), "dataset": dataset,
          "algorithm": payload.get("algorithm", "hogwild"),
          "escalate": escalate,
          "kwargs": dict(payload.get("kwargs", {}))}
    if payload.get("request_id") is not None:
        kw["request_id"] = str(payload["request_id"])
    return ProbeRequest(**kw)


def encode_probe_response(resp, *, full_artifact: bool = False) -> Dict:
    """ProbeResponse -> wire dict; escalation artifacts are bulky and
    fully identified by path + fingerprint, so they stay server-side
    unless explicitly requested."""
    out = resp.to_dict()
    if out.get("escalation") and not full_artifact:
        out["escalation"].pop("artifact", None)
    return out


class _Handler(BaseHTTPRequestHandler):
    # ThreadingHTTPServer default is HTTP/1.0-style close-per-request;
    # keep that (curl and scrapers reconnect) but answer protocol 1.1
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------
    def log_message(self, fmt, *args):          # noqa: N802 — stdlib name
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload) -> None:
        body = json.dumps(payload, indent=1, default=float).encode()
        self._send(code, body, "application/json; charset=utf-8")

    def _send_error_json(self, code: int, message: str) -> None:
        self._send_json(code, {"error": message})

    def _read_json_body(self):
        length = self.headers.get("Content-Length")
        if length is None:
            raise _BadRequest("Content-Length required")
        n = int(length)
        if n > MAX_BODY_BYTES:
            raise _BadRequest(f"body too large ({n} > {MAX_BODY_BYTES})")
        raw = self.rfile.read(n)
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise _BadRequest(f"invalid JSON body: {e}") from e

    def _route(self, method: str) -> None:
        url = urllib.parse.urlsplit(self.path)
        query = dict(urllib.parse.parse_qsl(url.query))
        t0 = time.perf_counter()
        try:
            handler = getattr(self, f"_{method}_{url.path.strip('/')}",
                              None)
            if handler is None:
                self._send_error_json(
                    404, f"no {method} route {url.path!r}; serving "
                         f"/probe /probe_batch (POST), /metrics /healthz "
                         f"/flight /trace (GET)")
                return
            _request_counter(method, url.path).inc()
            handler(query)
        except _BadRequest as e:
            self._send_error_json(400, str(e))
        except BrokenPipeError:
            pass                                  # client went away
        except Exception as e:                    # noqa: BLE001 — transport
            # must answer, not die: a handler bug becomes a structured 500
            self._send_error_json(
                500, f"{type(e).__name__}: {e}")
        finally:
            _LATENCY.observe(time.perf_counter() - t0)

    def do_GET(self):                             # noqa: N802 — stdlib name
        self._route("GET")

    def do_POST(self):                            # noqa: N802 — stdlib name
        self._route("POST")

    # -- the advisor front end ----------------------------------------------
    def _POST_probe(self, query):                 # noqa: N802
        svc = self.server.service
        if svc is None:
            self._send_error_json(
                503, "no advisor configured: this is a metrics-only "
                     "observability plane; POST probes to a python -m "
                     "repro_torch.service --serve instance")
            return
        req = decode_probe_request(self._read_json_body())
        resp = svc.probe(req)
        self._send_json(200, encode_probe_response(
            resp, full_artifact=query.get("full") == "1"))

    def _POST_probe_batch(self, query):           # noqa: N802
        svc = self.server.service
        if svc is None:
            self._send_error_json(
                503, "no advisor configured: this is a metrics-only "
                     "observability plane")
            return
        payload = self._read_json_body()
        if not isinstance(payload, dict) or \
                not isinstance(payload.get("requests"), list):
            raise _BadRequest('body must be {"requests": [...]}')
        reqs = [decode_probe_request(p) for p in payload["requests"]]
        resps = svc.probe_batch(reqs)
        self._send_json(200, {"responses": [
            encode_probe_response(r, full_artifact=query.get("full") == "1")
            for r in resps]})

    # -- the observability plane --------------------------------------------
    def _GET_metrics(self, query):                # noqa: N802
        text = metrics.REGISTRY.render_prometheus(
            prefix=query.get("prefix", ""))
        self._send(200, (text or "# (registry empty)\n").encode(),
                   "text/plain; version=0.0.4; charset=utf-8")

    def _GET_healthz(self, query):                # noqa: N802
        svc = self.server.service
        qstats = (svc.queue.stats(reset=query.get("reset") == "1")
                  if svc is not None else None)
        overloaded = bool(qstats) and \
            qstats["in_service"] >= qstats["depth"]
        self._send_json(200, {
            "status": "overloaded" if overloaded else "ok",
            "service": svc is not None,
            "uptime_s": time.time() - self.server.t0,
            "queue": qstats,
            "recorder": recorder.RECORDER.stats(),
            "tracing": trace.enabled(),
        })

    def _GET_flight(self, query):                 # noqa: N802
        try:
            since = int(query.get("since", 0))
            limit = int(query["limit"]) if "limit" in query else None
        except ValueError as e:
            raise _BadRequest(f"since/limit must be integers: {e}") from e
        self._send_json(200, recorder.RECORDER.snapshot(
            since=since, limit=limit))

    def _GET_trace(self, query):                  # noqa: N802
        tracer = trace.active() or trace.last()
        if tracer is None:
            payload = {"traceEvents": [], "displayTimeUnit": "ms",
                       "otherData": {"producer": "repro_torch.telemetry",
                                     "note": "no tracer has run"}}
        elif query.get("drain") == "1":
            payload = {"traceEvents": tracer.drain(),
                       "displayTimeUnit": "ms",
                       "otherData": dict(tracer.other_data(),
                                         drained=True)}
        else:
            payload = tracer.payload()
        self._send_json(200, payload)


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 lets concurrent clients past the
    # fifth be reset while the accept loop waits for the interpreter lock
    request_queue_size = 128


class ServiceServer:
    """Owns the ThreadingHTTPServer + its serve thread.

    ``service=None`` serves the observability plane only.  ``port=0``
    binds an ephemeral port (read ``.port`` after construction)."""

    def __init__(self, service=None, *, host: str = "127.0.0.1",
                 port: int = 0, verbose: bool = False):
        self.service = service
        self._httpd = _Server((host, port), _Handler)
        self._httpd.service = service
        self._httpd.verbose = verbose
        self._httpd.t0 = time.time()
        # request threads must not block interpreter exit mid-sweep
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServiceServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-torch-service-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=5)
        self._httpd.server_close()
        self._thread = None

    def __enter__(self) -> "ServiceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
