"""The paper, end-to-end, in the PyTorch port: build the Table-I-style
datasets, measure their characters, run all four parallel algorithms
across worker counts, compare the measured scalability against the
characters' predictions, all through the port's sweep engine (spec:
``scalability_study``); the port's counterpart of
examples/paper_scalability_study.py, printing the same tables.

  PYTHONPATH=src python examples/torch_paper_scalability_study.py   (quick)
  PYTHONPATH=src python examples/torch_paper_scalability_study.py --full
  PYTHONPATH=src python examples/torch_paper_scalability_study.py \\
      --device cpu

Artifacts go to the port's cache, ``results/sweep_cache_torch/``
(``REPRO_TORCH_SWEEP_CACHE`` redirects it).  On the GPU the characters
run the L0 kernels (K1, K2) and ECD-PSGD's steps the fused compression
kernel.
"""

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.experiments import curves_by_m, get_spec, run_sweep

DISPLAY = {"higgs_like": "higgs_like(dense)",
           "realsim_like": "realsim_like(sparse)"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="recompute even if the sweep artifact is cached")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = get_spec("scalability_study", quick=not args.full)
    res = run_sweep(spec, force=args.force, device=dev)

    print("=" * 72)
    print("dataset characters (paper §IV)")
    print("=" * 72)
    for ds_name, info in res["datasets"].items():
        name = DISPLAY[ds_name]
        c = info["characters"]
        print(f"{name:24s} var={c['mean_feature_variance']:.3f} "
              f"sparsity={c['sparsity']:.3f} div={c['diversity_ratio']:.2f} "
              f"csim={c['csim_async']:.1f}")
        hw = res["jobs"][f"hogwild/{ds_name}"]["predicted"]
        sy = res["jobs"][f"minibatch/{ds_name}"]["predicted"]
        print(f"{'':24s} predicted m_max: hogwild={hw['predicted_m_max']} "
              f"sync={sy['predicted_m_max']}")

    print()
    print("=" * 72)
    print("measured scalability (gap between m=1 and m=8 convergence curves)")
    print("=" * 72)
    for ds_name in res["datasets"]:
        name = DISPLAY[ds_name]
        for algo in ("minibatch", "hogwild", "ecd_psgd", "dadm"):
            curves = curves_by_m(res["jobs"][f"{algo}/{ds_name}"])
            gap = float(np.mean(np.array(curves[1]) - np.array(curves[8])))
            print(f"{name:24s} {algo:10s} gap(m1->m8)={gap:+.4f} "
                  f"final(m8)={curves[8][-1]:.4f}")
    print()
    print("paper conclusion check: dense/high-variance should show the big "
          "minibatch/ecd gaps; sparse should show ~zero Hogwild! penalty.")
    cache = res.get("cache", {})
    if cache.get("hit"):
        print(f"(served from sweep cache: {cache['path']})")


if __name__ == "__main__":
    main()
