#!/usr/bin/env python3
"""Time K1 and K2 of the PyTorch port in one or more checkouts, on one GPU.

    python3 scripts/time_l0.py TREE [TREE ...] [--out FILE]

For each TREE in turn (give a tree twice to see the spread; for two
versions run A B B A), a fresh process imports ``TREE/src/repro_torch``,
builds its CUDA kernels into ``TREE/build/`` and times, with this
checkout's ``chip_smoke.py`` helpers (CUDA-graph replays over input
copies past the L2), K2's whole call (``kernels.csim.l0_shift_sum``) at
``chip_smoke.L0_SHIFT_TIMED`` and ``core.metrics.row_l0`` (K1 as the
main path calls it) at ``chip_smoke.ROW_L0_TIMED``.  Any checkout of the
port has both.  Prints the card's name and power limit, then one JSON
line per run, and writes all runs to ``--out`` (default
``results/time_l0.json``).
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
from repro_torch.core import metrics
from repro_torch.kernels import csim as kc
gen = torch.Generator(device="cuda").manual_seed(5)
shift = [{"shape": [nb, b, d, r], "ms": cs._timed(
    lambda t, r=r: kc.l0_shift_sum(t, r), None,
    (cs.l0_input(gen, (nb, b, d)),), nb * b * d * 4 + nb * 8)[0]}
    for (nb, b, d), r in cs.L0_SHIFT_TIMED]
rows = [{"shape": [n, d], "ms": cs._timed(
    metrics.row_l0, None, (cs.l0_input(gen, (n, d)),), n * d * 4 + n * 4)[0]}
    for n, d in cs.ROW_L0_TIMED]
print(json.dumps({"l0_shift_sum": shift, "row_l0": rows}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "time_l0.json"))
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
