"""Bench-trajectory analysis: every ``BENCH_N.json`` as one time series
(the port's copy of ``repro/analysis/trajectory.py``, stdlib only; the
same anchors give the same points, verdicts and markdown).

Each PR lands a ``BENCH_N.json`` anchor (`scripts/bench_engine.py`) with
a point-in-time ``vs_benchM`` comparison against the previous anchor.
Those pairwise blocks answer "did THIS PR regress", but nobody was
reading the *trajectory* — nine anchors deep, a slow 10%-per-PR drift
would pass every pairwise gate and still double the engine's wall-clock.
This module turns the anchors into one series and gates on it:

  * :func:`load_trajectory` parses every ``BENCH_N.json`` in a directory
    (sorted by N) into flat per-anchor points — engine/pr1/vmap
    wall-clocks, cache roundtrip, telemetry on/off tax — tolerating the
    early anchors that predate a section (BENCH_2..8 have no
    ``telemetry`` block; missing values are ``None``).
  * :func:`check_regression` applies the trajectory gates: the newest
    anchor's ``engine_default`` within ``band``x of the previous
    anchor's, and the telemetry-enabled tax (``trace_on / trace_off``)
    within ``band`` — both against the *last anchor that has the
    number*, not blindly N-1.  ``band`` defaults to 2.0: these anchors
    are measured on a shared 2-core CI container where run-to-run noise
    of 30-50% is routine (see docs/observability.md), so the gate
    catches step-function regressions (a quadratic slipped in, tracing
    accidentally always-on), not percentage drift.  The full series is
    rendered precisely so humans can see the drift the gate tolerates.
  * :func:`render_history` writes the series as markdown
    (``docs/bench_history.md``): per-anchor table, unicode sparklines,
    and inline-SVG trend charts via the report's helpers.

``scripts/bench_check.py`` is the CLI; CI runs it on every push and
fails the build when a gate trips.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

_BENCH_RE = re.compile(r"^BENCH_(\d+)\.json$")


def _get(d: Dict, *path):
    """Nested dict get -> None on any missing step (anchors grow
    sections over time; absence is data, not an error)."""
    for k in path:
        if not isinstance(d, dict) or k not in d:
            return None
        d = d[k]
    return d


def load_trajectory(root: str = ".") -> List[Dict]:
    """Parse every ``BENCH_N.json`` under ``root`` into one sorted list
    of flat per-anchor points (``None`` where an anchor predates a
    measurement)."""
    points: List[Dict] = []
    for fname in sorted(os.listdir(root)):
        m = _BENCH_RE.match(fname)
        if not m:
            continue
        path = os.path.join(root, fname)
        with open(path) as f:
            raw = json.load(f)
        trace_off = _get(raw, "telemetry", "results", "trace_off_s")
        trace_on = _get(raw, "telemetry", "results", "trace_on_s")
        tax = (trace_on / trace_off
               if trace_on is not None and trace_off else None)
        points.append({
            "pr": int(m.group(1)),
            "path": path,
            "quick": bool(raw.get("quick", False)),
            "engine_version": raw.get("engine_version"),
            "engine_default": _get(raw, "main", "wall_clock_s",
                                   "engine_default"),
            "pr1": _get(raw, "main", "wall_clock_s", "pr1"),
            "vmap_flat": _get(raw, "main", "wall_clock_s", "vmap_flat"),
            "sequential": _get(raw, "main", "wall_clock_s", "sequential"),
            "speedup_vs_pr1": raw.get("speedup_vs_pr1"),
            "cache_fresh": _get(raw, "cache_roundtrip_s", "fresh"),
            "cache_cached": _get(raw, "cache_roundtrip_s", "cached"),
            "trace_off_s": trace_off,
            "trace_on_s": trace_on,
            "telemetry_tax": tax,
            "metrics_scrape_ms": _get(raw, "observability", "results",
                                      "metrics_scrape_ms"),
            "flight_scrape_ms": _get(raw, "observability", "results",
                                     "flight_scrape_ms"),
        })
    points.sort(key=lambda p: p["pr"])
    return points


def _last_with(points: List[Dict], key: str, *, before: int) -> Optional[Dict]:
    """Newest point earlier than index ``before`` that carries ``key``."""
    for p in reversed(points[:before]):
        if p.get(key) is not None:
            return p
    return None


def check_regression(points: List[Dict], *, band: float = 2.0) -> Dict:
    """Trajectory gates over the newest anchor.  Returns
    ``{"ok", "band", "checks": [{"name", "ok", "value", "limit",
    "detail"}, ...]}`` — ``ok`` is the AND of every applicable check;
    gates whose inputs are missing are reported ``ok`` with a detail
    saying why (an early trajectory must not fail CI)."""
    checks: List[Dict] = []
    if len(points) < 2:
        return {"ok": True, "band": band,
                "checks": [{"name": "trajectory", "ok": True,
                            "value": len(points), "limit": 2,
                            "detail": "fewer than 2 anchors — nothing to "
                                      "compare yet"}]}
    last = points[-1]

    # gate 1: engine_default vs the previous anchor that measured it
    prev = _last_with(points, "engine_default", before=len(points) - 1)
    if last["engine_default"] is None or prev is None:
        checks.append({"name": "engine_default", "ok": True, "value": None,
                       "limit": band,
                       "detail": "engine_default missing from an anchor"})
    else:
        ratio = last["engine_default"] / prev["engine_default"]
        checks.append({
            "name": "engine_default", "ok": ratio <= band,
            "value": round(ratio, 3), "limit": band,
            "detail": f"BENCH_{last['pr']} {last['engine_default']:.2f}s vs "
                      f"BENCH_{prev['pr']} {prev['engine_default']:.2f}s "
                      f"(ratio {ratio:.2f}, gate {band:.1f}x)"})

    # gate 2: the telemetry-enabled tax of the newest measuring anchor
    if last["telemetry_tax"] is None:
        checks.append({"name": "telemetry_tax", "ok": True, "value": None,
                       "limit": band,
                       "detail": "no telemetry section in the newest "
                                 "anchor"})
    else:
        checks.append({
            "name": "telemetry_tax", "ok": last["telemetry_tax"] <= band,
            "value": round(last["telemetry_tax"], 3), "limit": band,
            "detail": f"trace_on {last['trace_on_s']:.2f}s / trace_off "
                      f"{last['trace_off_s']:.2f}s = "
                      f"{last['telemetry_tax']:.2f} (gate {band:.1f}x)"})

    # gate 3: the traced-off baseline vs the previous telemetry anchor —
    # the disabled contract must not quietly become the enabled one
    prev_t = _last_with(points, "trace_off_s", before=len(points) - 1)
    if last["trace_off_s"] is None or prev_t is None:
        checks.append({"name": "trace_off_baseline", "ok": True,
                       "value": None, "limit": band,
                       "detail": "needs two anchors with telemetry "
                                 "sections"})
    else:
        ratio = last["trace_off_s"] / prev_t["trace_off_s"]
        checks.append({
            "name": "trace_off_baseline", "ok": ratio <= band,
            "value": round(ratio, 3), "limit": band,
            "detail": f"BENCH_{last['pr']} {last['trace_off_s']:.2f}s vs "
                      f"BENCH_{prev_t['pr']} {prev_t['trace_off_s']:.2f}s "
                      f"(ratio {ratio:.2f}, gate {band:.1f}x)"})

    return {"ok": all(c["ok"] for c in checks), "band": band,
            "checks": checks}


def _fmt(v, spec: str = "{:.2f}") -> str:
    return spec.format(v) if v is not None else "—"


def render_history(points: List[Dict], verdict: Optional[Dict] = None,
                   ) -> str:
    """The trajectory as markdown (docs/bench_history.md)."""
    # report carries the shared presentation helpers; imported here, not
    # at module top, so that loading the trajectory imports no torch
    from repro_torch.analysis.report import sparkline, svg_timeseries

    lines = [
        "# Bench trajectory",
        "",
        "Every `BENCH_N.json` anchor as one time series — regenerate with",
        "`PYTHONPATH=src python scripts/bench_check.py` (CI runs it per",
        "push and fails on the gates below; see docs/observability.md for",
        "the noise band these anchors carry).",
        "",
        "| bench | engine_default s | pr1 s | vmap_flat s | cache hit s | "
        "trace off s | trace on s | tax |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for p in points:
        lines.append(
            f"| BENCH_{p['pr']} | {_fmt(p['engine_default'])} | "
            f"{_fmt(p['pr1'])} | {_fmt(p['vmap_flat'])} | "
            f"{_fmt(p['cache_cached'], '{:.3f}')} | "
            f"{_fmt(p['trace_off_s'])} | {_fmt(p['trace_on_s'])} | "
            f"{_fmt(p['telemetry_tax'])} |")
    lines.append("")

    def series(key):
        return [p[key] for p in points]

    labels = [str(p["pr"]) for p in points]
    for key, title in (("engine_default",
                        "engine_default wall-clock (s) per bench anchor"),
                       ("vmap_flat",
                        "vmap_flat wall-clock (s) per bench anchor")):
        vals = [v for v in series(key) if v is not None]
        if len(vals) >= 2:
            lines += [f"`{key}`: `{sparkline(vals)}` "
                      f"({vals[0]:.1f}s → {vals[-1]:.1f}s)", "",
                      svg_timeseries(labels, series(key), title=title,
                                     fmt="{:.1f}s"), ""]
    taxes = [v for v in series("telemetry_tax") if v is not None]
    if taxes:
        lines += ["`telemetry_tax` (trace_on / trace_off): " +
                  ", ".join(f"{t:.2f}" for t in taxes), ""]

    if verdict is not None:
        lines += [f"## Gates (band {verdict['band']:.1f}x)", ""]
        for c in verdict["checks"]:
            mark = "PASS" if c["ok"] else "**FAIL**"
            lines.append(f"- {mark} `{c['name']}`: {c['detail']}")
        lines.append("")
    return "\n".join(lines) + "\n"
