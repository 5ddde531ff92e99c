#!/usr/bin/env python3
"""Time K1, K2 and K4 of the PyTorch port in one or more checkouts, on one
GPU.

    python3 scripts/time_kernels.py TREE [TREE ...] [--out FILE]

For each TREE in turn (give a tree twice to see the spread; for two
versions run A B B A), a fresh process imports ``TREE/src/repro_torch``,
builds its CUDA kernels into ``TREE/build/`` and times, with this
checkout's ``chip_smoke.py`` helpers (CUDA-graph replays over input
copies past the L2):

- K2's whole call (``kernels.csim.l0_shift_sum``) at
  ``chip_smoke.L0_SHIFT_TIMED``;
- ``core.metrics.row_l0`` (K1 as the main path calls it, from one input)
  at every shape the paths give it (``chip_smoke.ROW_L0_TIMED``,
  ``SPEC_ROW_L0_TIMED``, ``SERVICE_ROW_L0_TIMED``), beside
  ``torch.count_nonzero``, and K1's two-input form at 4000 x 400;
- K4 (``kernels.quantize.dequantize_rows``) at the gossip step's leaves
  (``chip_smoke.GOSSIP_QUANT_TIMED``, int8) and at 32 x 28, beside
  ``torch.mul(q, scale[:, None])``, the one PyTorch call that computes it;
- an empty kernel, the launch floor.

Any checkout of the port has all of these.  Prints the card's name and
power limit, then one JSON line per run, and writes all runs to ``--out``
(default ``results/time_kernels.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, sys
root, tree = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
sys.path.insert(0, tree + "/src")
import torch
import chip_smoke as cs
from repro_torch.core import compression, metrics
from repro_torch.kernels import csim as kc
from repro_torch.kernels import quantize as kq
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(5)
shift = [{"shape": [nb, b, d, r], "ms": cs._timed(
    lambda t, r=r: kc.l0_shift_sum(t, r), None,
    (cs.l0_input(gen, (nb, b, d)),), nb * b * d * 4 + nb * 8)[0]}
    for (nb, b, d), r in cs.L0_SHIFT_TIMED]
rows = []
for n, d in (cs.ROW_L0_TIMED + cs.SPEC_ROW_L0_TIMED
             + cs.SERVICE_ROW_L0_TIMED):
    ms, library_ms = cs._timed(
        metrics.row_l0, None, (cs.l0_input(gen, (n, d)),), n * d * 4 + n * 4,
        library=lambda t: torch.count_nonzero(t, dim=1))
    rows.append({"shape": [n, d], "ms": ms, "library_ms": library_ms})
x = cs.l0_input(gen, (4000, 400))
two = {"shape": [4000, 400], "ms": cs._timed(
    kc.l0_rows, None, (x, torch.zeros_like(x)), 2 * x.numel() * 4 + 16000)[0]}
dequant = []
for r, d in cs.GOSSIP_QUANT_TIMED + [(32, 28)]:
    xq = (torch.rand(r, d, generator=gen, device=dev) - 0.5) * 0.3
    scale = compression.row_scales(xq, 8)
    q = kq.quantize_rows(xq, torch.rand(r, d, generator=gen, device=dev),
                         scale, 8)
    del xq
    ms, library_ms = cs._timed(
        kq.dequantize_rows, None, (q, scale), r * d * 5 + r * 4, reps=2,
        library=lambda q, s: torch.mul(q, s[:, None]))
    dequant.append({"shape": [r, d, 8], "ms": ms, "library_ms": library_ms})
    del q
    torch.cuda.empty_cache()
print(json.dumps({"l0_shift_sum": shift, "row_l0": rows, "l0_rows_two": two,
                  "dequantize_rows": dequant,
                  "empty_ms": cs._graph_ms([lambda: kc.empty_launch(dev)])}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "time_kernels.json"))
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for tree in args.trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", CHILD, ROOT, tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        run = {"tree": os.path.relpath(tree, ROOT), "card": card, **result}
        runs.append(run)
        print(json.dumps(run), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
