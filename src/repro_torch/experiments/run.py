"""CLI for the port's sweep engine.

  PYTHONPATH=src python -m repro_torch.experiments.run --list
  PYTHONPATH=src python -m repro_torch.experiments.run --spec upper_bound
  PYTHONPATH=src python -m repro_torch.experiments.run --spec \\
      variance_sparsity --quick --iters 100 --n 300 --device cpu --no-cache
  PYTHONPATH=src python -m repro_torch.experiments.run --spec diversity \\
      --quick --problem hinge

Runs on the GPU by default and fails without one unless ``--device cpu``
is given.  ``--list`` prints the registered specs, algorithms, problems
and dataset generators.  ``--n`` overrides a spec's dataset size.
``--problem`` re-points every job at another registered objective and
keeps each job's kwargs, so a step size tuned for the original objective
may not suit the new one's curvature (the runner marks a job whose curve
is not finite ``"diverged"``).  Repeated runs of an unchanged spec are
served from the port's artifact cache (``--force`` recomputes,
``--no-cache`` bypasses it).  The report ends with the
measured-vs-predicted m_max comparison.

``--devices`` (default ``auto``: every CUDA device, or the one CPU)
shards every job's buckets over a device mesh (`repro_torch.distributed`);
the mesh is printed at startup.  Curves and cache keys are the same on
any mesh.  ``--seq`` runs each worker count alone (never sharded).

``--trace out.json`` records the run as nested spans (sweep -> job ->
grid -> bucket -> execute, journal and cache IO) and writes Chrome-trace
JSON (load it at https://ui.perfetto.dev, or summarize it with
``python -m repro_torch.telemetry --summarize out.json``).
``--metrics`` prints the process metrics registry (Prometheus text)
after the run.  ``--serve PORT`` exposes ``/metrics``, ``/healthz``,
``/flight`` and ``/trace`` over HTTP while the sweep runs (watch it with
``python -m repro_torch.telemetry --watch URL``).  All three only
observe: the artifact bytes are the same with or without them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.core import problems as problems_mod
from repro_torch.core.algorithms import base as alg_base
from repro_torch.data import synth
from repro_torch.distributed import get_mesh
from repro_torch.experiments import registry, runner
from repro_torch.telemetry import metrics as metrics_mod
from repro_torch.telemetry import trace


def _print_report(result: dict) -> None:
    spec = result["spec"]
    print("=" * 72)
    print(f"sweep {result['name']}: {spec['description']}")
    print(f"  m grid={list(spec['ms'])}  iters={spec['iters']}  "
          f"eval_every={spec['eval_every']}  seeds={spec['n_seeds']}")
    print("=" * 72)
    for name, info in result["datasets"].items():
        c = info["characters"]
        csim = f"  C_sim={info['csim']:.2f}" if "csim" in info else ""
        print(f"dataset {name:10s} n={info['n']} d={info['d']}{csim}  "
              f"var={c['mean_feature_variance']:.3f} "
              f"sparsity={c['sparsity']:.3f} div={c['diversity_ratio']:.2f} "
              f"csim_async={c['csim_async']:.2f} "
              f"csim_sync={c['csim_sync']:.2f}")
    print()
    comparisons = []
    for key, jr in result["jobs"].items():
        curves = runner.curves_by_m(jr)
        finals = "  ".join(f"m{m}={c[-1]:.4f}" for m, c in curves.items())
        print(f"{key:28s} final loss: {finals}")
        if "costs" in jr:
            costs = "  ".join(f"m{m}={c:.0f}"
                              for m, c in zip(jr["ms"], jr["costs"]))
            print(f"{'':28s} cost/worker (eps={jr['epsilon']:.4f}): {costs}")
            print(f"{'':28s} measured m_max = {jr['measured_m_max']}")
        if "predicted" in jr:
            print(f"{'':28s} predicted m_max = "
                  f"{jr['predicted']['predicted_m_max']}")
        if "measured_m_max" in jr and "predicted" in jr:
            comparisons.append((key, jr["measured_m_max"],
                                jr["predicted"]["predicted_m_max"]))
    if comparisons:
        print("\nmeasured vs predicted scalability upper bound:")
        for key, meas, pred in comparisons:
            print(f"  {key:28s} measured={meas:<6d} predicted={pred}")
    cache = result.get("cache", {})
    exe = result["execution"]
    src = ("cache hit" if cache.get("hit")
           else f"computed in {result.get('elapsed_s', 0.0):.2f}s")
    if exe.get("sharded"):
        src += f" sharded over {exe['devices']} devices"
    print(f"\n[{src} on {exe['device_name']}] "
          f"artifact: {cache.get('path')}")


def _print_registries() -> None:
    print("registered sweep specs:")
    for name in registry.SPEC_IDS:
        spec = registry.get_spec(name, quick=True)
        print(f"  {name:20s} {spec.description}")
    print("\nregistered algorithms (core.algorithms):")
    for name in sorted(alg_base.ALGORITHMS):
        cls = alg_base.ALGORITHMS[name]
        flags = ["async"] if cls.asynchronous else []
        flags.append("flat" if cls.force_flat
                     else ("bucketed" if cls.bucketed_default
                           else "flat-default"))
        print(f"  {name:20s} predictor={cls.predictor:9s} "
              f"[{', '.join(flags)}]")
    print("\nregistered problems (core.problems):")
    for name in sorted(problems_mod.PROBLEMS):
        doc = (problems_mod.PROBLEMS[name].__doc__ or "").split("\n")[0]
        print(f"  {name:20s} {doc}")
    print("\nregistered dataset generators (data.synth):")
    for name in sorted(synth.GENERATORS):
        doc = (synth.GENERATORS[name].__doc__ or "").split("\n")[0]
        print(f"  {name:20s} {doc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.run",
        description="run a registered scalability sweep on the PyTorch port")
    ap.add_argument("--spec", help=f"spec name; one of {registry.SPEC_IDS}")
    ap.add_argument("--list", action="store_true",
                    help="list registered specs, algorithms, problems and "
                         "dataset generators, then exit")
    ap.add_argument("--problem",
                    help="re-point every job at this registered problem "
                         "(e.g. ridge, hinge); job kwargs are kept")
    ap.add_argument("--quick", action="store_true",
                    help="CI-scale iteration counts")
    ap.add_argument("--iters", type=int, help="override iteration budget")
    ap.add_argument("--n", type=int, help="override dataset size")
    ap.add_argument("--seeds", type=int,
                    help="override the spec's n_seeds (seed replicates)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--cache-dir", help="artifact cache directory")
    ap.add_argument("--no-cache", action="store_true",
                    help="neither read nor write the artifact cache")
    ap.add_argument("--force", action="store_true",
                    help="recompute even on a cache hit")
    ap.add_argument("--devices", default="auto",
                    help="device mesh for sharded execution: 'auto' (every "
                         "device of --device's type, the default) or an "
                         "int; results and cache keys are mesh-invariant")
    ap.add_argument("--seq", action="store_true",
                    help="run each worker count alone instead of the "
                         "batched buckets (never sharded)")
    ap.add_argument("--json", help="also write the full result to this path")
    ap.add_argument("--trace", metavar="TRACE_JSON",
                    help="record the run as spans and write Chrome-trace "
                         "JSON here (observational only)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the process metrics registry (Prometheus "
                         "text) after the run")
    ap.add_argument("--serve", metavar="PORT", type=int, default=None,
                    help="expose /metrics /healthz /flight /trace over HTTP "
                         "on this port while the sweep runs (0 = "
                         "ephemeral; observational only)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        _print_registries()
        return 0
    if not args.spec:
        ap.error("--spec is required (or --list)")
    spec = registry.get_spec(args.spec, quick=args.quick, iters=args.iters,
                             n=args.n, seeds=args.seeds)
    if args.problem:
        problems_mod.get_problem(args.problem)    # fail fast if unknown
        spec = dataclasses.replace(spec, jobs=tuple(
            dataclasses.replace(j, problem=args.problem)
            for j in spec.jobs)).validate()
    devices = args.devices
    if devices != "auto":
        try:
            devices = int(devices)
        except ValueError:
            ap.error(f"--devices must be an int or 'auto', got {devices!r}")
    # an invalid request must still serve cached artifacts, so the runner
    # resolves the mesh only on a miss; this startup report is best-effort
    try:
        print(get_mesh(devices, device=args.device).describe())
    except ValueError as e:
        print(f"mesh: not resolvable here ({e}); cached artifacts still "
              f"serve, a fresh compute will fail")
    # the tracer brackets run_sweep tightly, so the root "sweep" span
    # covers nearly all of the traced wall time
    if args.trace:
        trace.start()
    server = None
    if args.serve is not None:
        # the observability plane only: no advisor behind it, so the probe
        # endpoints answer 503 (imported here: the plain CLI stays
        # http-free)
        from repro_torch.service.http import ServiceServer
        server = ServiceServer(None, port=args.serve).start()
        print(f"observability plane at {server.url} (GET /metrics "
              f"/healthz /flight /trace; watch: python -m "
              f"repro_torch.telemetry --watch {server.url})", flush=True)
    try:
        result = runner.run_sweep(spec, device=args.device,
                                  use_cache=not args.no_cache,
                                  force=args.force, cache_dir=args.cache_dir,
                                  verbose=args.verbose, per_m=args.seq,
                                  mesh=devices)
    finally:
        if server is not None:
            server.stop()
        if args.trace:
            trace.stop()
            trace.export(args.trace)
            print(f"wrote trace {args.trace} (summarize: python -m "
                  f"repro_torch.telemetry --summarize {args.trace})")
    _print_report(result)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1, default=float)
        print(f"wrote {args.json}")
    if args.metrics:
        print()
        print(metrics_mod.REGISTRY.render_prometheus(prefix="repro_"),
              end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
