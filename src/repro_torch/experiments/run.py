"""CLI for the port's sweep engine.

  PYTHONPATH=src python -m repro_torch.experiments.run --spec upper_bound
  PYTHONPATH=src python -m repro_torch.experiments.run --spec upper_bound \\
      --quick --device cpu --no-cache

Runs on the GPU by default and fails without one unless ``--device cpu``
is given.  Repeated runs of an unchanged spec are served from the port's
artifact cache (``--force`` recomputes, ``--no-cache`` bypasses it).
The report ends with the measured-vs-predicted m_max comparison.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.experiments import registry, runner


def _print_report(result: dict) -> None:
    spec = result["spec"]
    print("=" * 72)
    print(f"sweep {result['name']}: {spec['description']}")
    print(f"  m grid={list(spec['ms'])}  iters={spec['iters']}  "
          f"eval_every={spec['eval_every']}  seeds={spec['n_seeds']}")
    print("=" * 72)
    for name, info in result["datasets"].items():
        c = info["characters"]
        print(f"dataset {name:10s} n={info['n']} d={info['d']}  "
              f"var={c['mean_feature_variance']:.3f} "
              f"sparsity={c['sparsity']:.3f} div={c['diversity_ratio']:.2f} "
              f"csim_async={c['csim_async']:.2f} "
              f"csim_sync={c['csim_sync']:.2f}")
    print()
    comparisons = []
    for key, jr in result["jobs"].items():
        curves = runner.curves_by_m(jr)
        finals = "  ".join(f"m{m}={c[-1]:.4f}" for m, c in curves.items())
        print(f"{key:20s} final loss: {finals}")
        if "costs" in jr:
            costs = "  ".join(f"m{m}={c:.0f}"
                              for m, c in zip(jr["ms"], jr["costs"]))
            print(f"{'':20s} cost/worker (eps={jr['epsilon']:.4f}): {costs}")
            print(f"{'':20s} measured m_max = {jr['measured_m_max']}")
        if "predicted" in jr:
            print(f"{'':20s} predicted m_max = "
                  f"{jr['predicted']['predicted_m_max']}")
        if "measured_m_max" in jr and "predicted" in jr:
            comparisons.append((key, jr["measured_m_max"],
                                jr["predicted"]["predicted_m_max"]))
    if comparisons:
        print("\nmeasured vs predicted scalability upper bound:")
        for key, meas, pred in comparisons:
            print(f"  {key:20s} measured={meas:<6d} predicted={pred}")
    cache = result.get("cache", {})
    src = ("cache hit" if cache.get("hit")
           else f"computed in {result.get('elapsed_s', 0.0):.2f}s")
    print(f"\n[{src} on {result['execution']['device_name']}] "
          f"artifact: {cache.get('path')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.run",
        description="run a registered scalability sweep on the PyTorch port")
    ap.add_argument("--spec", required=True,
                    help=f"spec name; one of {registry.SPEC_IDS}")
    ap.add_argument("--quick", action="store_true",
                    help="CI-scale iteration counts")
    ap.add_argument("--iters", type=int, help="override iteration budget")
    ap.add_argument("--seeds", type=int,
                    help="override the spec's n_seeds (seed replicates)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--cache-dir", help="artifact cache directory")
    ap.add_argument("--no-cache", action="store_true",
                    help="neither read nor write the artifact cache")
    ap.add_argument("--force", action="store_true",
                    help="recompute even on a cache hit")
    ap.add_argument("--json", help="also write the full result to this path")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    spec = registry.get_spec(args.spec, quick=args.quick, iters=args.iters,
                             seeds=args.seeds)
    result = runner.run_sweep(spec, device=args.device,
                              use_cache=not args.no_cache, force=args.force,
                              cache_dir=args.cache_dir, verbose=args.verbose)
    _print_report(result)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1, default=float)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
