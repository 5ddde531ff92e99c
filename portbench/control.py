"""The upper readings of a cell's compared numbers, at the cell's own size
on the card: the reference put in the program's place, against the
reference itself, computed

  fp8        with every matrix product's operands rounded to float8 e4m3
             (the precision below the configuration's bfloat16: the
             control, which has to come out as not correct)
  half       on batches whose second half repeats the first (half of the
             batch left out, the mean over the rest)

A step that returns its state unchanged reads 1 on every change number
and needs no run.  The benchmark's own runs never run this.

  python3 portbench/control.py --workload <cell> --seeds 11 12 13

prints one JSON line per seed and variant with the gaps
(``harness.compare.gaps``) and whether the cell's limits pass them.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from portbench.harness import cells, compare, inputs, train  # noqa: E402


def readings(cell, seed, device, variants=("fp8", "half")):
    """{variant: {number: gap}} against the float32 reference."""
    cfg, tr = cell.cfg, cell.traffic
    pool = inputs.batches(tr, cfg["vocab_size"], seed, device)
    batches = pool[:tr["checked_steps"]]
    t0 = time.perf_counter()
    base = train.reference(cfg, tr, batches, seed, device)
    out = {"reference_s": time.perf_counter() - t0}
    for v in variants:
        # hand the last reference's cached blocks back first: kept, they
        # split the memory that the next one needs (the fp8 control ran out
        # of the card's 80 GB after the float32 reference without this)
        gc.collect()
        torch.cuda.empty_cache()
        other = train.reference(
            cfg, tr, [inputs.halve(*b) for b in batches] if v == "half"
            else batches, seed, device, fp8=v == "fp8")
        out[v] = {"gaps": {k: g for k, (g, _) in
                           compare.gaps(other, base).items()},
                  "details": compare.details(other, base)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", choices=("fp8", "half"),
                    default=["fp8", "half"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    for seed in args.seeds:
        got = readings(cell, seed, "cuda", args.variants)
        took = got.pop("reference_s")
        for v, r in got.items():
            fails = {k: g > cell.limits[k] for k, g in r["gaps"].items()
                     if k in cell.limits}
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": v, "reference_s": took,
                              "gaps": r["gaps"], "fails_limits": fails,
                              "details": r["details"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
