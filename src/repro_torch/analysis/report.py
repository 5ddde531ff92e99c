"""``python -m repro_torch.analysis.report`` — the paper's tables and
figures as a seed-replicated markdown report (port of
``repro/analysis/report.py``).

Every number that a single-seed sweep gives as a point estimate is
rendered as a seed-replicated mean with a bootstrap CI
(`repro_torch.analysis.stats`), the scalability bound also as a fitted
parameter of the Thm-2 cost law beside the theory-side prediction
(`repro_torch.analysis.fit`), and the thesis itself — dataset characters
decide m_max — as a regression across every cached sweep.

Sections (1-5 render exactly as the reference's do for the same
artifacts):

  1. **Table II, replicated** — ``upper_bound`` with a seed batch: per-m
     cost mean +- std, bootstrap-CI measured m_max, fitted and predicted
     m_max, a loss-curve sparkline per worker count and an inline SVG
     cost curve with its CI band.
  2. **Character surface** — ``character_surface``: the (variance x
     density x duplication) knob grid with measured / fitted / predicted
     m_max per cell.
  3. **Critical-parameter surface** — ``critical_params``: momentum lr x
     local-SGD sync window x async-SVRG anchor period at two character
     settings, with each knob's m_max cliff and its shift.
  4. **Fault tolerance** — ``fault_tolerance``: Hogwild! and local SGD
     under seeded delivery-fault rates, m_max degradation per cell.
  5. **characters -> m_max regression** — fitted coefficients and R^2
     across every artifact in the port's cache directory (diverged and
     failed jobs are excluded by their ``status``).
  6. **where the time went** — the report's own sweeps run under the span
     tracer (`repro_torch.telemetry`); the last computed sweep's phase
     breakdown (datasets, jobs, grids, buckets and their device-synced
     ``execute`` spans, journal and cache IO, the kernels' first-use
     ``compile``) is rendered as a table.  All-cache-hit renders have
     nothing to attribute and say so.

Results come from the port's artifact cache when fingerprints match (a
re-render is then pure formatting) or from a fresh run on ``--device``
(default the GPU); ``--quick``, ``--iters``, ``--n`` and ``--seeds``
scale the sweeps as the run CLI does.  The report never reads or writes
the reference's cache or report.

  PYTHONPATH=src python -m repro_torch.analysis.report
  PYTHONPATH=src python -m repro_torch.analysis.report --device cpu \\
      --quick --iters 60 --n 160
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Optional

from repro_torch.analysis import fit, stats
from repro_torch.experiments import cache as artifact_cache
from repro_torch.experiments import registry, runner
from repro_torch.experiments.spec import ENGINE_VERSION, JobSpec
from repro_torch.telemetry import trace

#: specs the report runs; upper_bound ships single-seed, so the report
#: replicates it with this many seeds unless --seeds overrides
REPORT_SPECS = ("upper_bound", "character_surface", "critical_params",
                "fault_tolerance")
DEFAULT_SEEDS = {"quick": 3, "full": 8}
DEFAULT_OUT = os.path.join("results", "analysis_report_torch.md")

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values) -> str:
    """Unicode block sparkline, per-curve normalized."""
    vals = [float(v) for v in values]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[min(int((v - lo) / span * len(_SPARK)),
                              len(_SPARK) - 1)] for v in vals)


def _fmt_ci(point: int, lo: int, hi: int) -> str:
    return f"{point}" if lo == hi == point else f"{point} [{lo}, {hi}]"


def svg_cost_curve(ms, mean, lo, hi, *, title: str) -> str:
    """Minimal inline SVG: the per-worker cost curve (one series — no
    legend, the title names it) with its bootstrap-CI band.  Neutral ink
    line over a light gray band, muted text, no chart junk."""
    w, h, pad = 380, 140, 34
    xs = [math.log2(m) for m in ms]
    x0, x1 = min(xs), max(xs)
    ymin = min(lo)
    ymax = max(hi) or 1.0
    yspan = (ymax - ymin) or 1.0

    def X(v):
        return pad + (v - x0) / ((x1 - x0) or 1.0) * (w - 2 * pad)

    def Y(v):
        return h - pad - (v - ymin) / yspan * (h - 2 * pad)

    band = " ".join(f"{X(x):.1f},{Y(u):.1f}" for x, u in zip(xs, hi))
    band += " " + " ".join(f"{X(x):.1f},{Y(u):.1f}"
                           for x, u in zip(reversed(xs), reversed(lo)))
    line = " ".join(f"{X(x):.1f},{Y(v):.1f}" for x, v in zip(xs, mean))
    ticks = "".join(
        f'<text x="{X(x):.1f}" y="{h - pad + 14}" font-size="9" '
        f'fill="#6b7280" text-anchor="middle">{m}</text>'
        for x, m in zip(xs, ms))
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
        f'viewBox="0 0 {w} {h}" role="img" aria-label="{title}">'
        f'<text x="{pad}" y="14" font-size="10" fill="#374151">{title}'
        f' &#8212; cost/worker vs m (band: bootstrap CI)</text>'
        f'<line x1="{pad}" y1="{h - pad}" x2="{w - pad}" y2="{h - pad}" '
        f'stroke="#e5e7eb" stroke-width="1"/>'
        f'<polygon points="{band}" fill="#d1d5db" fill-opacity="0.55"/>'
        f'<polyline points="{line}" fill="none" stroke="#1f2937" '
        f'stroke-width="2" stroke-linejoin="round"/>'
        f'{ticks}'
        f'<text x="{w - pad}" y="{Y(mean[-1]) - 6:.1f}" font-size="9" '
        f'fill="#374151" text-anchor="end">{mean[-1]:.0f}</text>'
        f'</svg>')


def svg_timeseries(labels, values, *, title: str,
                   fmt: str = "{:.1f}") -> str:
    """Minimal inline SVG for an ordered series (one point per label,
    e.g. wall-clock per bench anchor).  Same visual language as
    `svg_cost_curve`: one neutral ink line, muted ticks, no chart junk.
    ``None`` values are skipped (a bench that predates the measurement);
    the last point is annotated with ``fmt``."""
    w, h, pad = 380, 140, 34
    pts = [(i, float(v)) for i, v in enumerate(values) if v is not None]
    if not pts:
        return ""
    ymin = min(v for _, v in pts)
    ymax = max(v for _, v in pts)
    yspan = (ymax - ymin) or 1.0
    x1 = max(len(labels) - 1, 1)

    def X(i):
        return pad + i / x1 * (w - 2 * pad)

    def Y(v):
        return h - pad - (v - ymin) / yspan * (h - 2 * pad)

    line = " ".join(f"{X(i):.1f},{Y(v):.1f}" for i, v in pts)
    dots = "".join(f'<circle cx="{X(i):.1f}" cy="{Y(v):.1f}" r="2.5" '
                   f'fill="#1f2937"/>' for i, v in pts)
    ticks = "".join(
        f'<text x="{X(i):.1f}" y="{h - pad + 14}" font-size="9" '
        f'fill="#6b7280" text-anchor="middle">{lab}</text>'
        for i, lab in enumerate(labels))
    last_i, last_v = pts[-1]
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
        f'viewBox="0 0 {w} {h}" role="img" aria-label="{title}">'
        f'<text x="{pad}" y="14" font-size="10" fill="#374151">{title}'
        f'</text>'
        f'<line x1="{pad}" y1="{h - pad}" x2="{w - pad}" y2="{h - pad}" '
        f'stroke="#e5e7eb" stroke-width="1"/>'
        f'<polyline points="{line}" fill="none" stroke="#1f2937" '
        f'stroke-width="2" stroke-linejoin="round"/>'
        f'{dots}{ticks}'
        f'<text x="{X(last_i):.1f}" y="{Y(last_v) - 6:.1f}" font-size="9" '
        f'fill="#374151" text-anchor="end">{fmt.format(last_v)}</text>'
        f'</svg>')


# ---------------------------------------------------------------------------
# section renderers
# ---------------------------------------------------------------------------

def _eps_of(result: Dict):
    eps = (result.get("spec") or {}).get("epsilon") or {}
    return eps.get("probe_m"), eps.get("frac")


def render_upper_bound(result: Dict, *, svg: bool = True) -> List[str]:
    probe_m, frac = _eps_of(result)
    lines = ["## 1. Table II, replicated (`upper_bound`)", ""]
    spec = result["spec"]
    lines += [f"m grid {list(spec['ms'])}, iters {spec['iters']}, "
              f"{spec.get('n_seeds', 1)} seed replicate(s) per job; costs "
              f"are iterations/worker to the per-seed probe epsilon "
              f"(probe m={probe_m}, frac={frac}).", ""]
    ms = list(next(iter(result["jobs"].values()))["ms"])
    head = (["job", "epsilon (seed 0)"]
            + [f"cost m={m}" for m in ms]
            + ["measured m_max [CI]", "fitted m_max [CI]", "predicted"])
    rows = []
    figs: List[str] = []
    for key, jr in result["jobs"].items():
        boot = stats.mmax_bootstrap(jr, probe_m=probe_m, frac=frac)
        law = fit.fit_job(jr, probe_m=probe_m, frac=frac)
        cm, cs = boot["cost_mean"], boot["cost_std"]
        pred = (jr.get("predicted") or {}).get("predicted_m_max", "-")
        rows.append(
            [key, f"{jr['epsilon']:.4f}"]
            + [f"{m_:.0f} &#177; {s_:.0f}" for m_, s_ in zip(cm, cs)]
            + [_fmt_ci(boot["m_max"], boot["lo"], boot["hi"]),
               _fmt_ci(law["fitted_m_max"], law["fitted_m_max_lo"],
                       law["fitted_m_max_hi"]) + f" (R&#178;={law['r2']:.2f})",
               str(pred)])
        if svg:
            band_lo = [m_ - s_ for m_, s_ in zip(cm, cs)]
            band_hi = [m_ + s_ for m_, s_ in zip(cm, cs)]
            figs.append(svg_cost_curve(jr["ms"], cm, band_lo, band_hi,
                                       title=key))
    lines += _table(head, rows)
    lines += ["", "Loss curves (seed-mean, one sparkline per worker "
              "count; final loss mean &#177; std):", ""]
    for key, jr in result["jobs"].items():
        cs_ = stats.curve_stats(jr)
        mean = cs_["mean"]
        std = cs_["std"]
        per_m = "  ".join(
            f"m{m}:{sparkline(mean[i])} {mean[i][-1]:.3f}&#177;"
            f"{std[i][-1]:.3f}" for i, m in enumerate(cs_["ms"]))
        lines.append(f"- `{key}` {per_m}")
    if figs:
        lines += [""] + figs
    return lines + [""]


def render_character_surface(result: Dict) -> List[str]:
    probe_m, frac = _eps_of(result)
    lines = ["## 2. Character surface (`character_surface`)", ""]
    lines += ["One generator (`character_knob`), three knobs, one cell per "
              "combination: the paper's thesis as a surface.  `measured` "
              "is the bootstrap point estimate over seed replicates, "
              "`fitted` the Thm-2 law's bound on the seed-mean cost curve, "
              "`predicted` the theory-side character bound.", ""]
    head = ["variance", "density", "dup", "measured m_max [CI]",
            "fitted m_max [CI]", "predicted", "fit R&#178;"]
    rows = []
    for key, jr in result["jobs"].items():
        ds = result["spec"]["datasets"][jr["dataset"]]["kwargs"]
        boot = stats.mmax_bootstrap(jr, probe_m=probe_m, frac=frac)
        law = fit.fit_job(jr, probe_m=probe_m, frac=frac)
        pred = (jr.get("predicted") or {}).get("predicted_m_max", "-")
        rows.append([f"{ds.get('variance', 1.0):g}",
                     f"{ds.get('density', 1.0):g}",
                     f"{ds.get('duplication', 0.0):g}",
                     _fmt_ci(boot["m_max"], boot["lo"], boot["hi"]),
                     _fmt_ci(law["fitted_m_max"], law["fitted_m_max_lo"],
                             law["fitted_m_max_hi"]),
                     str(pred), f"{law['r2']:.2f}"])
    return lines + _table(head, rows) + [""]


def render_critical_params(result: Dict) -> List[str]:
    probe_m, frac = _eps_of(result)
    lines = ["## 3. Critical-parameter surface (`critical_params`)", ""]
    lines += ["Three optimizer classes, one critical knob each — the "
              "momentum step size, the local-SGD sync window `H`, the "
              "async-SVRG anchor period `A` — swept at two "
              "`character_knob` settings.  The worker grid is the batch "
              "axis for the synchronous pair and the staleness axis "
              "(tau_max = m) for async-SVRG; the question is whether the "
              "m_max cliff moves with the knob AND with the dataset "
              "characters.", ""]
    head = ["algorithm", "knob", "dataset", "var", "density", "dup",
            "measured m_max [CI]", "fitted m_max [CI]", "predicted"]
    rows = []
    # fitted/measured bounds per (algorithm, knob) across the character
    # settings, in spec dataset order — the cliff shift spelled out below
    shifts: Dict[str, Dict[str, tuple]] = {}
    for j in result["spec"]["jobs"]:
        key = JobSpec(**j).key
        jr = result["jobs"][key]
        ds = result["spec"]["datasets"][jr["dataset"]]["kwargs"]
        boot = stats.mmax_bootstrap(jr, probe_m=probe_m, frac=frac)
        law = fit.fit_job(jr, probe_m=probe_m, frac=frac)
        pred = (jr.get("predicted") or {}).get("predicted_m_max", "-")
        knob = j.get("label") or "-"
        rows.append([j["algorithm"], knob, jr["dataset"],
                     f"{ds.get('variance', 1.0):g}",
                     f"{ds.get('density', 1.0):g}",
                     f"{ds.get('duplication', 0.0):g}",
                     _fmt_ci(boot["m_max"], boot["lo"], boot["hi"]),
                     _fmt_ci(law["fitted_m_max"], law["fitted_m_max_lo"],
                             law["fitted_m_max_hi"]),
                     str(pred)])
        shifts.setdefault(f"{j['algorithm']}[{knob}]", {})[
            jr["dataset"]] = (boot["m_max"], law["fitted_m_max"])
    lines += _table(head, rows)
    lines += ["", "m_max cliff across the character settings "
              "(measured, fitted in parentheses):", ""]
    for cell, per_ds in shifts.items():
        path = " &#8594; ".join(
            f"{name} {m} ({f_})" for name, (m, f_) in per_ds.items())
        lines.append(f"- `{cell}`: {path}")
    return lines + [""]


def render_fault_tolerance(result: Dict) -> List[str]:
    probe_m, frac = _eps_of(result)
    lines = ["## 4. Fault tolerance (`fault_tolerance`)", ""]
    # the prose names the fault model's home in the reference, whose
    # streams the port draws bit for bit: sections 1-5 read as the
    # reference's do
    lines += ["Deterministic fault injection (`repro.resilience.faults`) "
              "as a sweep axis: each cell runs under a seeded stream of "
              "straggling (extra staleness, capped at tau = m) and "
              "sign-flipped updates at the row's rate.  The fault seed is "
              "pinned, so every cell is bit-reproducible and the seed "
              "replicates share the fault schedule.  `measured` is the "
              "bootstrap m_max point estimate; degradation is relative "
              "to the same cell's clean (rate 0) run.", ""]
    head = ["algorithm", "fault rate", "dataset", "var", "dup",
            "status", "measured m_max [CI]", "vs clean"]
    rows = []
    # (algorithm, dataset) -> {rate: bootstrap m_max}, spec job order
    cells: Dict[tuple, Dict[float, int]] = {}
    for j in result["spec"]["jobs"]:
        key = JobSpec(**j).key
        jr = result["jobs"][key]
        ds = result["spec"]["datasets"][jr["dataset"]]["kwargs"]
        rate = float((j["kwargs"].get("fault") or {})
                     .get("straggle_rate", 0.0))
        status = str(jr.get("status", "ok"))
        if status == "ok" or status.startswith("retried"):
            boot = stats.mmax_bootstrap(jr, probe_m=probe_m, frac=frac)
            cell = cells.setdefault((j["algorithm"], jr["dataset"]), {})
            cell[rate] = boot["m_max"]
            clean = cell.get(0.0)
            vs = ("-" if not clean or rate == 0.0
                  else f"{boot['m_max'] / clean:.0%}")
            measured = _fmt_ci(boot["m_max"], boot["lo"], boot["hi"])
        else:
            # a diverged/failed cell still renders — as its status, not
            # as a number pretending to be one
            vs, measured = "-", "-"
        rows.append([j["algorithm"], f"{rate:g}", jr["dataset"],
                     f"{ds.get('variance', 1.0):g}",
                     f"{ds.get('duplication', 0.0):g}",
                     status, measured, vs])
    lines += _table(head, rows)
    lines += ["", "m_max degradation at the top fault rate (bootstrap "
              "estimate, relative to the clean cell):", ""]
    for (algo, ds_name), byrate in cells.items():
        clean = byrate.get(0.0)
        top = max(byrate)
        if not clean or top == 0.0:
            continue
        kept = byrate[top] / clean
        lines.append(f"- `{algo}` on `{ds_name}`: {clean} &#8594; "
                     f"{byrate[top]} at rate {top:g} "
                     f"({kept:.0%} of clean m_max)")
    return lines + [""]


def render_regression(results: List[Dict]) -> List[str]:
    points = fit.collect_character_points(results)
    lines = ["## 5. characters &#8594; m_max regression", ""]
    reg = fit.characters_regression(points)
    if reg is None:
        return lines + [f"not enough cost-readout points "
                        f"({len(points)}) to regress.", ""]
    lines += [f"log2(m_max) ~ intercept + log10(variance) + sparsity + "
              f"diversity_ratio over **{reg['n_points']} sweep cells** "
              f"(every cached sweep with a cost readout contributes):", ""]
    head = ["coefficient", "value"]
    rows = [[k, f"{v:+.3f}"] for k, v in reg["coef"].items()]
    rows.append(["R&#178;", f"{reg['r2']:.3f}"])
    return lines + _table(head, rows) + [""]


def render_telemetry(events: List[Dict]) -> List[str]:
    """Section 6: phase breakdown of the report's last *computed* sweep
    (cache hits execute nothing, so an all-hit render has no phases)."""
    lines = ["## 6. where the time went (span trace)", ""]
    bd = trace.phase_breakdown(events, root="sweep")
    if bd["root"] is None:
        return lines + ["every sweep above was served from the artifact "
                        "cache — nothing was computed, so there is no "
                        "compute to attribute (`--force` recomputes and "
                        "fills this section).", ""]
    lines += [f"last computed sweep: **{bd['wall_us'] / 1e6:.2f} s** "
              f"wall-clock, {bd['coverage']:.0%} attributed to child "
              f"phases (`repro_torch.telemetry.trace`; re-run any spec "
              f"with `repro_torch.experiments.run --trace` for the full "
              f"Perfetto-loadable timeline).", ""]
    head = ["phase", "total (s)", "spans", "% of sweep"]
    rows = [[name, f"{p['total_us'] / 1e6:.3f}", p["count"],
             f"{p['frac_of_wall']:.1%}"]
            for name, p in sorted(bd["phases"].items(),
                                  key=lambda kv: -kv[1]["total_us"])]
    return lines + _table(head, rows) + [""]


def _table(head: List[str], rows: List[List[str]]) -> List[str]:
    out = ["| " + " | ".join(head) + " |",
           "|" + "|".join("---" for _ in head) + "|"]
    out += ["| " + " | ".join(str(c) for c in r) + " |" for r in rows]
    return out


def load_cached_results(cache_dir: str) -> List[Dict]:
    """Every readable artifact in the port's sweep cache directory (the
    regression's point pool); malformed files are skipped."""
    if not os.path.isdir(cache_dir):
        return []
    out = []
    for name in sorted(os.listdir(cache_dir)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(cache_dir, name)) as f:
                out.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.report",
        description="render the seed-replicated scalability report")
    ap.add_argument("--quick", action="store_true",
                    help="CI-scale sweeps (and 3 seed replicates)")
    ap.add_argument("--iters", type=int, help="override iteration budget")
    ap.add_argument("--n", type=int, help="override dataset size")
    ap.add_argument("--seeds", type=int,
                    help="seed replicates per job (default: 3 quick / 8)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"report path (default {DEFAULT_OUT})")
    ap.add_argument("--cache-dir",
                    help="the port's sweep artifact cache directory "
                         f"(default {artifact_cache.DEFAULT_CACHE_DIR})")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--force", action="store_true",
                    help="recompute sweeps even on cache hits")
    ap.add_argument("--no-svg", action="store_true",
                    help="tables + sparklines only")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    cache_dir = args.cache_dir or artifact_cache.DEFAULT_CACHE_DIR
    seeds = args.seeds or DEFAULT_SEEDS["quick" if args.quick else "full"]

    results = {}
    # the report traces its own sweep executions; section 6 renders the
    # phase breakdown of the last computed one (hits trace only lookups)
    tracer = trace.start()
    try:
        for name in REPORT_SPECS:
            spec = registry.get_spec(name, quick=args.quick,
                                     iters=args.iters, n=args.n,
                                     seeds=seeds)
            if args.verbose:
                print(f"[report] running {name} "
                      f"(n_seeds={spec.n_seeds}) ...", flush=True)
            results[name] = runner.run_sweep(spec, device=args.device,
                                             cache_dir=cache_dir,
                                             force=args.force,
                                             verbose=args.verbose)
    finally:
        trace.stop()

    lines = ["# Scalability report — seed-replicated statistics",
             "",
             f"engine version {ENGINE_VERSION}; "
             f"{seeds} seed replicate(s) per job; bootstrap "
             f"{int(stats.CI * 100)}% CIs over {stats.N_BOOT} resamples.",
             ""]
    lines += render_upper_bound(results["upper_bound"], svg=not args.no_svg)
    lines += render_character_surface(results["character_surface"])
    lines += render_critical_params(results["critical_params"])
    lines += render_fault_tolerance(results["fault_tolerance"])
    lines += render_regression(load_cached_results(cache_dir))
    lines += render_telemetry(tracer.events)

    md = "\n".join(lines) + "\n"
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md)

    for name, result in results.items():
        src = "cache" if result["cache"]["hit"] else \
            f"{result.get('elapsed_s', 0.0):.1f}s"
        print(f"[report] {name}: {len(result['jobs'])} jobs ({src})")
    print(f"[report] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
