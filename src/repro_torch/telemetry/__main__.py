"""``python -m repro_torch.telemetry`` — registry dump, trace summarizer
and live flight-recorder watcher (port of ``repro/telemetry/__main__.py``).

  PYTHONPATH=src python -m repro_torch.telemetry               # registry (prom text)
  PYTHONPATH=src python -m repro_torch.telemetry --format json # registry (JSON)
  PYTHONPATH=src python -m repro_torch.telemetry \\
      --summarize results/trace.json                           # trace phase report
  PYTHONPATH=src python -m repro_torch.telemetry \\
      --watch http://127.0.0.1:8787                            # tail /flight

``--summarize`` loads a Chrome-trace JSON produced by
``repro_torch.experiments.run --trace`` (or `telemetry.trace.export`),
validates the event schema, and prints the span coverage and per-phase
breakdown, the aggregation the analysis report renders
(`trace.phase_breakdown`).  The exit code is non-zero if
``--min-coverage`` is given and the trace's top-level spans attribute
less than that fraction of its wall time.

``--watch URL`` tails a live observability plane (``run --serve PORT``
or ``python -m repro_torch.service --serve PORT``): it polls
``URL/flight?since=CURSOR`` and prints each new flight-recorder event
(sweep/job progress, grid pad waste, race psum rounds) as a one-line
record — a text-mode "what is the sweep doing right now".  Stdlib
urllib; ``--interval`` sets the poll period and ``--max-polls`` bounds
the watch (0 = until interrupted).

The bare registry dump shows *this process's* metrics — mostly zeros
from a fresh CLI process; its real consumers are in-process
(`AdvisorService.stats`, the run CLI's ``--metrics`` flag) or the HTTP
``GET /metrics`` endpoint (`repro_torch.service.http`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request

from repro_torch.telemetry import REGISTRY, trace

_REQUIRED_EVENT_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


def summarize(path: str, root: str = "sweep") -> dict:
    """Load + validate a Chrome-trace JSON; return the phase breakdown."""
    with open(path) as f:
        payload = json.load(f)
    events = payload.get("traceEvents", payload if isinstance(payload, list)
                         else [])
    bad = [e for e in events
           if not all(k in e for k in _REQUIRED_EVENT_KEYS)]
    if bad:
        raise ValueError(
            f"{path}: {len(bad)} event(s) missing required keys "
            f"{_REQUIRED_EVENT_KEYS} (first: {bad[0]!r})")
    overall = trace.phase_breakdown(events)
    scoped = trace.phase_breakdown(events, root=root)
    return {"path": path, "n_events": len(events),
            "overall": overall, "last_" + root: scoped}


def _print_summary(s: dict, root: str) -> None:
    ov = s["overall"]
    print(f"{s['path']}: {s['n_events']} span(s), "
          f"wall {ov['wall_us'] / 1e6:.3f} s, top-level coverage "
          f"{ov['coverage']:.1%}")
    scoped = s["last_" + root]
    if scoped["root"]:
        print(f"last '{root}' span: {scoped['wall_us'] / 1e6:.3f} s, "
              f"child coverage {scoped['coverage']:.1%}")
        phases = scoped["phases"]
    else:
        phases = ov["phases"]
    width = max((len(n) for n in phases), default=4)
    for name, p in sorted(phases.items(),
                          key=lambda kv: -kv[1]["total_us"]):
        print(f"  {name:<{width}}  {p['total_us'] / 1e6:9.3f} s  "
              f"x{p['count']:<5d} {p['frac_of_wall']:6.1%}")


def _format_event(ev: dict) -> str:
    """One flight event -> one log line: time, kind, then the payload
    fields in insertion order."""
    ts = time.strftime("%H:%M:%S", time.localtime(ev.get("t", 0)))
    fields = " ".join(f"{k}={v}" for k, v in ev.items()
                      if k not in ("seq", "t", "kind"))
    return f"{ts} #{ev.get('seq', '?'):<6} {ev.get('kind', '?'):<14} {fields}"


def watch(url: str, interval: float = 1.0, max_polls: int = 0,
          out=None) -> int:
    """Tail ``url``'s ``/flight`` endpoint; returns an exit code."""
    out = out or sys.stdout
    base = url.rstrip("/")
    since, polls = 0, 0
    while True:
        try:
            with urllib.request.urlopen(
                    f"{base}/flight?since={since}", timeout=10) as r:
                snap = json.load(r)
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            print(f"error: {base}/flight unreachable: {e}", file=sys.stderr)
            return 2
        for ev in snap.get("events", []):
            print(_format_event(ev), file=out)
        for sp in snap.get("spans", []):
            print(f"         #{sp.get('seq', '?'):<6} span:{sp['name']:<9} "
                  f"dur={sp['dur'] / 1e3:.1f}ms", file=out)
        out.flush()
        since = snap.get("seq", since)
        polls += 1
        if max_polls and polls >= max_polls:
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="dump the metrics registry / summarize a trace / "
                    "watch a live flight recorder")
    ap.add_argument("--summarize", metavar="TRACE_JSON",
                    help="validate + phase-break a Chrome-trace JSON")
    ap.add_argument("--root", default="sweep",
                    help="span name to scope the phase breakdown to "
                         "(default: sweep)")
    ap.add_argument("--min-coverage", type=float, default=None,
                    help="exit non-zero if top-level span coverage of the "
                         "trace wall-clock is below this fraction")
    ap.add_argument("--format", choices=("prom", "json"), default="prom",
                    help="registry dump format (default: prom text)")
    ap.add_argument("--prefix", default="",
                    help="only dump metrics whose name starts with this")
    ap.add_argument("--watch", metavar="URL",
                    help="tail URL/flight (a run --serve or service --serve "
                         "plane), printing new events per poll")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="--watch poll period in seconds (default 1)")
    ap.add_argument("--max-polls", type=int, default=0,
                    help="--watch: stop after N polls (0 = until ^C)")
    args = ap.parse_args(argv)

    if args.watch:
        return watch(args.watch, interval=args.interval,
                     max_polls=args.max_polls)

    if args.summarize:
        try:
            s = summarize(args.summarize, root=args.root)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        _print_summary(s, args.root)
        if args.min_coverage is not None and \
                s["overall"]["coverage"] < args.min_coverage:
            print(f"FAIL: coverage {s['overall']['coverage']:.1%} < "
                  f"{args.min_coverage:.1%}", file=sys.stderr)
            return 1
        return 0

    if args.format == "json":
        json.dump(REGISTRY.to_dict(prefix=args.prefix), sys.stdout,
                  indent=2, default=float)
        print()
    else:
        out = REGISTRY.render_prometheus(prefix=args.prefix)
        sys.stdout.write(out or "# (registry empty)\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
