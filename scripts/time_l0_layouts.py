#!/usr/bin/env python3
"""Time layouts of K1's one-input form against the port's K1, on one GPU.

    python3 scripts/time_l0_layouts.py [--out FILE]

``scripts/l0_layouts.cu`` holds one template of the row-support count
(``sum_k [|x_ik| > 0]`` over rows of at most 512 floats, 16-byte loads,
every load of a warp's rows issued before the first compare) and
fourteen instances of it: blocks of 32 to 256 threads, 1, 2 or 4 rows a
warp in flight, 16 or 32 lanes a row, with or without an ``L2::256B``
prefetch hint on the loads.  The script builds it with ``nvcc`` into
``build/l0_layouts/``, checks every instance against
``kernels.csim.l0_rows_plain``, and times each, ``core.metrics.row_l0``
(the port's K1) before and after them, and an empty kernel, with
``chip_smoke.py``'s CUDA-graph timer over input copies past the L2, at
512 x 400, 512 x 300, 800 x 400, 2000 x 400 and 4000 x 400.  Prints the
card's name and power limit and one line per shape (microseconds), and
writes all times (ms) to ``--out`` (default
``results/time_l0_layouts.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(512, 400), (512, 300), (800, 400), (2000, 400), (4000, 400)]
LAYOUTS = 14            # instances in l0_layouts.cu's VARIANTS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "time_l0_layouts.json"))
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.core import metrics
    from repro_torch.kernels import csim as kc
    from torch.utils.cpp_extension import CUDA_HOME

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    build = os.path.join(ROOT, "build", "l0_layouts")
    os.makedirs(build, exist_ok=True)
    lib_path = os.path.join(build, "l0_layouts.so")
    subprocess.run([os.path.join(CUDA_HOME or "/usr/local/cuda", "bin",
                                 "nvcc"),
                    "-gencode=arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(ROOT, "scripts", "l0_layouts.cu")],
                   check=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.k1var.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                          ctypes.c_void_p]
    dev = torch.device("cuda", 0)

    def layout(v):
        def run(x):
            out = torch.empty(x.shape[0], device=x.device)
            err = lib.k1var(v, x.data_ptr(), out.data_ptr(), x.shape[0],
                            x.shape[1], 0.0,
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"layout {v}: cudaError {err}")
            return out
        return run

    gen = torch.Generator(device=dev).manual_seed(5)
    result = {"card": card,
              "empty_ms": cs._graph_ms([lambda: kc.empty_launch(dev)])}
    for n, d in SHAPES:
        x = cs.l0_input(gen, (n, d))
        want = kc.l0_rows_plain(x)
        nbytes = n * d * 4 + n * 4
        row = {"row_l0": cs._timed(metrics.row_l0, None, (x,), nbytes)[0]}
        for v in range(LAYOUTS):
            if not torch.equal(layout(v)(x), want):
                raise AssertionError(f"layout {v} differs at {n} x {d}")
            row[str(v)] = cs._timed(layout(v), None, (x,), nbytes)[0]
        row["row_l0_again"] = cs._timed(metrics.row_l0, None, (x,),
                                        nbytes)[0]
        result[f"{n}x{d}"] = row
        print(n, d, {k: round(t * 1e3, 3) for k, t in row.items()},
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
