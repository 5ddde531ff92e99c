#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA extension from ``src/repro_torch/kernels/csrc``, printing the
   build time.
2. Holds each kernel K1-K4 against its plain PyTorch version on the card
   at the shapes the ``upper_bound`` path gives it and at ragged ones:
   K1-K3 must agree exactly, K4 within one float32 ulp.  Each kernel's
   time, its plain version's time and its bound are measured at the main
   path's largest shape (CUDA-graph replays timed with CUDA events).
3. Runs the ``upper_bound`` spec (paper Table II) on the GPU at its
   published iteration count, with every launch counter set to 0 just
   before and read just after: each kernel must have launched.
4. Checks the output: a short ``upper_bound`` run on the GPU must agree
   with the same run on the CPU (the plain versions) — characters to
   1e-6 relative, curves to 1e-5, every value finite; ECD-PSGD, whose
   quantizer turns an ulp into a quantum, within the reference's own
   2e-2 envelope for execution-order differences.
5. Prints one JSON line with each kernel's numbers, then the final line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a GPU, outside a checkout of
the repository, or when any phase fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# published peaks of one H100 SXM (dense, no sparsity) used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _graph_ms(calls, reps: int = 64) -> float:
    """Device time of one call: ``reps`` calls, cycling through ``calls``
    (closures over separate copies of the inputs, enough of them to
    exceed the 50 MB L2 cache so each call reads device memory), captured
    in a CUDA graph; the graph is replayed and timed with CUDA events."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    reps = max(reps, len(calls))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _copies(nbytes: int) -> int:
    """Input copies that together exceed twice the L2 cache."""
    return max(1, min(256, math.ceil(100e6 / max(nbytes, 1))))


def _timed(kernel, plain, inputs, nbytes):
    """(kernel ms, plain ms) over rotating copies of ``inputs``."""
    sets = [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(_copies(nbytes) - 1)]
    return (_graph_ms([lambda a=a: kernel(*a) for a in sets]),
            _graph_ms([lambda a=a: plain(*a) for a in sets]))


def _bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev):
    """Phase 2: every kernel against its plain version; returns the
    per-kernel records (without launch counts)."""
    import torch
    from repro_torch import random as R
    from repro_torch.core import compression
    from repro_torch.kernels import csim as kc
    from repro_torch.kernels import quantize as kq

    def data(shape, seed, density=0.7):
        key = R.PRNGKey(seed, device=dev)
        k1, k2 = R.split(key)
        X = R.uniform(k1, shape)
        return torch.where(R.bernoulli(k2, density, shape), X,
                           torch.zeros_like(X)).contiguous()

    records = {}

    # K1: the main path calls it on (rows, d) against zeros for the row
    # supports; ragged shapes and perturbed copies exercise tol
    err = 0.0
    for i, (n, d) in enumerate([(4000, 400), (512, 400), (512, 28),
                                (512, 300), (257, 1025), (33, 7), (1, 1)]):
        x = data((n, d), i)
        y = x + (data((n, d), 100 + i, density=0.3) * 0.5)
        for other in (torch.zeros_like(x), y.contiguous()):
            for tol in (0.0, 0.25):
                got = kc.l0_rows(x, other, tol)
                want = kc.l0_rows_plain(x, other, tol)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"K1 l0_rows differs at n={n} "
                                         f"d={d} tol={tol}")
                err = max(err, float((got - want).abs().max()))
    x = data((4000, 400), 0)
    z = torch.zeros_like(x)
    n, d = x.shape
    nbytes = 2 * n * d * 4 + n * 4
    bound, by = _bound_ms(nbytes, 3 * n * d)
    ms, plain_ms = _timed(kc.l0_rows, kc.l0_rows_plain, (x, z), nbytes)
    records["l0_rows"] = {
        "name": "l0_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l0.cu",
        "replaces": "src/repro/kernels/csim.py:24",
        "max_abs_err": err, "shape": [n, d], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None}

    # K2: csim (nb=1, b=rows, r=8) and the LS_sync pair scan (r=b-1)
    err = 0.0
    cases = [((1, 512, 400), 8), ((64, 8, 400), 7), ((64, 8, 28), 7),
             ((64, 8, 300), 7)]
    cases += [((3, 37, 129), r) for r in range(1, 17)]
    for i, (shape, r) in enumerate(cases):
        X = data(shape, 200 + i, density=0.4)
        for tol in (0.0, 0.5):
            got = kc.l0_shift_sum(X, r, tol)
            want = kc.l0_shift_sum_plain(X, r, tol)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K2 l0_shift_sum differs at "
                                     f"{shape} r={r} tol={tol}")
            err = max(err, float((got - want).abs().max()))
    X = data((1, 512, 400), 200)
    nb, b, d = X.shape
    nbytes = nb * b * d * 4 + nb * 8
    bound, by = _bound_ms(nbytes, 3 * nb * b * d * 8)
    ms, plain_ms = _timed(lambda t: kc.l0_shift_sum(t, 8),
                          lambda t: kc.l0_shift_sum_plain(t, 8), (X,), nbytes)
    records["l0_shift_sum"] = {
        "name": "l0_shift_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l0.cu",
        "replaces": "src/repro/kernels/csim.py:64",
        "max_abs_err": err, "shape": [nb, b, d, 8], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}

    # K3/K4: ECD-PSGD quantizes (members * m_pad, d) rows per step; the
    # upper_bound buckets give 8, 32 and 24 rows of d = 28
    err3 = err4 = 0.0
    for i, (r, d) in enumerate([(8, 28), (32, 28), (24, 28), (5, 1000),
                                (1, 112000), (3, 1)]):
        key = R.PRNGKey(300 + i, device=dev)
        k1, k2 = R.split(key)
        x = (R.uniform(k1, (r, d), -4.0, 3.0)
             * torch.arange(1, r + 1, device=dev)[:, None]).contiguous()
        u = R.uniform(k2, (r, d))
        for bits in (4, 8, 16):
            scale = compression.row_scales(x, bits)
            q = kq.quantize_rows(x, u, scale, bits)
            qp = kq.quantize_rows_plain(x, u, scale, bits)
            dq = kq.dequantize_rows(q, scale)
            dqp = kq.dequantize_rows_plain(q, scale)
            torch.cuda.synchronize()
            if q.dtype != qp.dtype or not torch.equal(q, qp):
                raise AssertionError(f"K3 quantize_rows differs at "
                                     f"r={r} d={d} bits={bits}")
            up = torch.nextafter(dqp, torch.full_like(dqp, math.inf))
            ulp = torch.abs(up - dqp)
            if not bool((torch.abs(dq - dqp) <= ulp).all()):
                raise AssertionError(f"K4 dequantize_rows differs by more "
                                     f"than 1 ulp at r={r} d={d} bits={bits}")
            err3 = max(err3, float((q.int() - qp.int()).abs().max()))
            err4 = max(err4, float((dq - dqp).abs().max()))
    key = R.PRNGKey(400, device=dev)
    k1, k2 = R.split(key)
    x = R.uniform(k1, (32, 28), -4.0, 3.0).contiguous()
    u = R.uniform(k2, (32, 28))
    scale = compression.row_scales(x, 8)
    q = kq.quantize_rows(x, u, scale, 8)
    r, d = x.shape
    nbytes = r * d * (4 + 4 + 1) + r * 4
    bound, by = _bound_ms(nbytes, 5 * r * d)
    ms, plain_ms = _timed(lambda *a: kq.quantize_rows(*a, 8),
                          lambda *a: kq.quantize_rows_plain(*a, 8),
                          (x, u, scale), nbytes)
    records["quantize_rows"] = {
        "name": "quantize_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:25",
        "max_abs_err": err3, "shape": [r, d, 8], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}
    nbytes = r * d * (1 + 4) + r * 4
    bound, by = _bound_ms(nbytes, r * d)
    ms, plain_ms = _timed(kq.dequantize_rows, kq.dequantize_rows_plain,
                          (q, scale), nbytes)
    records["dequantize_rows"] = {
        "name": "dequantize_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:34",
        "max_abs_err": err4, "shape": [r, d, 8], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}
    return records


def _close(a, b, rel):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


def _max_diff(a, b) -> float:
    if len(a) != len(b):
        raise AssertionError("curve grids differ")
    diff = 0.0
    for row_a, row_b in zip(a, b):
        if len(row_a) != len(row_b) or not all(
                math.isfinite(v) for v in row_a + row_b):
            raise AssertionError("malformed or non-finite curve")
        diff = max(diff, max(abs(x - y) for x, y in zip(row_a, row_b)))
    return diff


def check_against_cpu(iters: int = 60):
    """Phase 4: the same short upper_bound run on the GPU and on the CPU
    (plain versions) must agree: characters to 1e-6 relative, curves to
    1e-5.  ECD-PSGD's floor turns an ulp of summation order into a whole
    quantum, so its curves are held to the reference's envelope for
    execution-order differences, the 2e-2 class of tests/test_core.py
    (ECD-PSGD divergence envelope)."""
    from repro_torch.experiments import registry, runner
    spec = registry.get_spec("upper_bound", iters=iters)
    gpu = runner.run_sweep(spec, device="cuda", use_cache=False)
    cpu = runner.run_sweep(spec, device="cpu", use_cache=False)
    for name, info in cpu["datasets"].items():
        for k, want in info["characters"].items():
            got = gpu["datasets"][name]["characters"][k]
            exact = k in ("n", "d", "diversity", "diversity_ratio")
            if (got != want) if exact else not _close(got, want, 1e-6):
                raise AssertionError(f"{name}.{k}: gpu {got} cpu {want}")
    report = {}
    for key, jc in cpu["jobs"].items():
        jg = gpu["jobs"][key]
        tol = 2e-2 if jc["algorithm"] == "ecd_psgd" else 1e-5
        diff = _max_diff(jg["losses"], jc["losses"])
        if diff > tol:
            raise AssertionError(f"{key}: GPU and CPU curves differ by "
                                 f"{diff} > {tol}")
        report[key] = {"max_abs_diff": diff, "tol": tol,
                       "measured_m_max_gpu_cpu": [jg.get("measured_m_max"),
                                                  jc.get("measured_m_max")]}
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return _fail("no CUDA GPU is available")
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        return _fail(f"no repro_torch package under {src}")
    sys.path.insert(0, src)
    from repro_torch import kernels
    from repro_torch.device import resolve_device
    from repro_torch.experiments import registry, runner
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    build.extension()
    print(f"phase build: ok in {time.perf_counter() - t0:.2f}s", flush=True)

    t0 = time.perf_counter()
    records = check_kernels(dev)
    print(f"phase kernels: ok in {time.perf_counter() - t0:.2f}s", flush=True)
    for rec in records.values():
        print(f"  {rec['name']:16s} shape={rec['shape']} "
              f"ms={rec['ms']:.6f} plain_ms={rec['plain_ms']:.6f} "
              f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}) "
              f"max_abs_err={rec['max_abs_err']}", flush=True)

    spec = registry.get_spec("upper_bound")
    with tempfile.TemporaryDirectory(dir=root) as cache_dir:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = runner.run_sweep(spec, device="cuda", cache_dir=cache_dir,
                                  force=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        stored = os.path.exists(result["cache"]["path"])
    print(f"phase upper_bound: iters={spec.iters} wall_s={wall:.3f} "
          f"artifact_stored={stored} launches={launches}", flush=True)
    print(f"  timings_s {json.dumps(result['timings'])}", flush=True)
    for name, info in result["datasets"].items():
        print(f"  dataset {name} n={info['n']} d={info['d']} characters "
              f"{json.dumps(info['characters'])}", flush=True)
    for key, jr in result["jobs"].items():
        pred = jr.get("predicted", {}).get("predicted_m_max")
        print(f"  job {key}: status={jr['status']} "
              f"epsilon={jr.get('epsilon')} "
              f"measured_m_max={jr.get('measured_m_max')} "
              f"predicted_m_max={pred} costs={jr.get('costs')}", flush=True)
        if jr["status"] != "ok" or "measured_m_max" not in jr:
            return _fail(f"upper_bound job {key} did not finish cleanly")
    if not stored:
        return _fail("the upper_bound artifact was not stored")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        return _fail(f"kernels never launched on the main path: {missing}")

    t0 = time.perf_counter()
    agreement = check_against_cpu()
    print(f"phase gpu-vs-cpu: ok in {time.perf_counter() - t0:.2f}s "
          f"{json.dumps(agreement)}", flush=True)

    for name, rec in records.items():
        rec["launches"] = launches[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
