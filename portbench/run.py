"""Run one cell of the port's benchmark on this machine's card.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window of a few steps.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (``breakdown`` when traced) and, last,
``checks``: every number the run compared with its limit, which the last
lines of standard error repeat.  Without a CUDA device, or without the
program, or if JAX or the JAX package is loaded, the run prints no result
and exits with a code other than 0.

Caches of the program's builds stay inside the checkout: the port builds
its kernels into ``build/torch_kernels``; ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` point into ``build/portbench``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
EXIT_NO_DEVICE, EXIT_NO_PROGRAM, EXIT_FORBIDDEN = 2, 3, 4


def _environment():
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark's process may
    not hold, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _say(msg):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def result_line(res, cell, checks, dev_info, traced):
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if traced:
        names = [m["name"] for m in cell.per_layer]
        values = res["metrics"]
    else:
        names = [m["name"] for m in cell.end_to_end]
        values = dict(res["metrics"], setup_s=res["setup_s"],
                      peak_mem_gb=res["memory_peak_bytes"] / 1e9)
    for name in names:
        if name in values:
            metrics[name] = {"value": values[name], "unit": units[name]}
    out = {"correct": all(c["ok"] for c in checks.values())
           and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev_info}
    if traced:
        out["breakdown"] = res["breakdown"]
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        _say("the program (src/repro_torch) is not in this checkout")
        return EXIT_NO_PROGRAM
    import torch
    from portbench.harness import cells, compare, train
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _say(f"{args.workload} needs {cell.chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             f" available")
        return EXIT_NO_DEVICE
    torch.set_num_threads(4)
    traced = bool(args.trace)
    readers = {m["name"]: cells.reader(m["name"]) for m in cell.per_layer} \
        if traced else None
    res = train.run(cell, args.seed, args.seconds, traced, "cuda", T0,
                    peaks=cells.peaks(), readers=readers)
    checks = compare.checks(res["values"], cell.limits)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if traced:
        dev["busy_s"], dev["window_s"] = res["busy_s"], res["window_s"]
    bad = forbidden_modules()
    if bad:
        _say(f"the process holds {bad}: no result")
        return EXIT_FORBIDDEN
    line = result_line(res, cell, checks, dev, traced)
    for d in res["details"]:
        _say(d)
    _say("values " + json.dumps(res["values"]))
    _say(f"window_s {res['window_s']!r} reference_s {res['reference_s']!r}")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
