"""CLI for the port's advisor service — probe a dataset spec through the
tiers (port of ``repro/service/__main__.py``, same flags plus
``--device``).

  PYTHONPATH=src python -m repro_torch.service --generator higgs_like \
      --n 128 --d 16                       # analytic tier (early exit)
  PYTHONPATH=src python -m repro_torch.service --generator realsim_like \
      --n 128 --d 16 --escalate            # force the measured sweep
  PYTHONPATH=src python -m repro_torch.service --generator higgs_like \
      --n 128 --d 16 --requests 4 --escalate   # 4 probes, one sweep
  PYTHONPATH=src python -m repro_torch.service --serve 8787
                                           # HTTP advisor + /metrics

Runs on the GPU by default and fails without one unless ``--device cpu``
is given.  ``--requests K`` issues K probes of the same dataset spec
through `AdvisorService.probe_batch`: their character measurements share
one masked-batch call and, with ``--escalate``, their sweeps share a
fingerprint, so exactly one executes (the stats line reports
``sweep_computes``).  ``--json`` prints the full response payloads.

``--serve PORT`` serves the advisor over HTTP until interrupted
(`repro_torch.service.http.ServiceServer`): ``POST /probe`` and
``/probe_batch``; ``GET /metrics`` / ``/healthz`` / ``/flight`` /
``/trace``.  PORT 0 picks an ephemeral port, printed at startup.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.experiments.spec import DatasetSpec
from repro_torch.service.api import AdvisorService, ProbeRequest
from repro_torch.service.http import ServiceServer


def _summary(resp) -> str:
    line = (f"{resp.request_id}: status={resp.status} tier={resp.tier} "
            f"confidence={resp.confidence:.3f}")
    if resp.tier == "analytic" and resp.report.get("valid"):
        best = {k: resp.report[k]["predicted_m_max"]
                for k in ("hogwild", "sync", "dadm")}
        line += f" predicted_m_max={best}"
    if resp.escalation is not None:
        line += (f" measured_m_max={resp.escalation['measured_m_max']} "
                 f"cache_hit={resp.escalation['cache_hit']}")
    if resp.note:
        line += f"\n    note: {resp.note}"
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="probe the scalability-advisor service")
    p.add_argument("--generator", default="higgs_like",
                   help="dataset generator (see repro_torch.data.synth)")
    p.add_argument("--n", type=int, default=128, help="dataset rows")
    p.add_argument("--d", type=int, default=16, help="dataset features")
    p.add_argument("--algorithm", default="hogwild",
                   help="algorithm whose sweep an escalation runs")
    p.add_argument("--requests", type=int, default=1,
                   help="number of identical probes to batch")
    p.add_argument("--escalate", action="store_true",
                   help="force the measured tier (tier 2)")
    p.add_argument("--no-escalate", action="store_true",
                   help="never escalate, whatever the confidence")
    p.add_argument("--threshold", type=float, default=None,
                   help="analytic-tier confidence gate override")
    p.add_argument("--cache-dir", default=None,
                   help="artifact cache directory (escalations + history)")
    p.add_argument("--cache-cap", type=int, default=None,
                   help="LRU artifact-count cap for the cache dir")
    p.add_argument("--queue-depth", type=int, default=32)
    p.add_argument("--n-slots", type=int, default=8,
                   help="batcher slot count")
    p.add_argument("--sweep-iters", type=int, default=200,
                   help="iterations of an escalated probe sweep")
    p.add_argument("--json", action="store_true",
                   help="print full response payloads as JSON")
    p.add_argument("--serve", metavar="PORT", type=int, default=None,
                   help="serve the advisor over HTTP on this port until "
                        "interrupted (0 = ephemeral port, printed at "
                        "startup) instead of running a one-shot probe")
    p.add_argument("--host", default="127.0.0.1",
                   help="--serve bind address (default 127.0.0.1)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a GPU) or cpu")
    args = p.parse_args(argv)

    kw = {}
    if args.threshold is not None:
        kw["confidence_threshold"] = args.threshold
    service = AdvisorService(
        n_slots=args.n_slots, queue_depth=args.queue_depth,
        cache_dir=args.cache_dir, cache_cap=args.cache_cap,
        sweep_iters=args.sweep_iters, device=args.device, **kw)

    if args.serve is not None:
        server = ServiceServer(service, host=args.host,
                               port=args.serve).start()
        print(f"advisor serving at {server.url} "
              f"(POST /probe /probe_batch; GET /metrics /healthz "
              f"/flight /trace) — ^C to stop", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
        return 0

    escalate = True if args.escalate else (False if args.no_escalate
                                           else None)
    ds = DatasetSpec(args.generator, {"n": args.n, "d": args.d})
    requests = [ProbeRequest(dataset=ds, algorithm=args.algorithm,
                             escalate=escalate)
                for _ in range(max(args.requests, 1))]
    responses = service.probe_batch(requests)

    if args.json:
        payload = {"responses": [r.to_dict() for r in responses],
                   "stats": service.stats()}
        # escalation artifacts are bulky; the path + fingerprint identify
        # them, so keep the JSON output bounded
        for r in payload["responses"]:
            if r.get("escalation"):
                r["escalation"].pop("artifact", None)
        json.dump(payload, sys.stdout, indent=2, default=float)
        print()
    else:
        for r in responses:
            print(_summary(r))
        print(f"stats: {json.dumps(service.stats(), default=float)}")
    return 0 if all(r.status in ("ok", "invalid") for r in responses) else 1


if __name__ == "__main__":
    sys.exit(main())
