"""Tests of the port that need the card (marked ``cuda``; they skip on a
host without a GPU).  This file imports neither JAX nor the reference, so
it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.core import compression
from repro_torch.kernels import csim as kc
from repro_torch.kernels import quantize as kq


@pytest.fixture
def cuda_device():
    """Skips, at run time, on hosts without a GPU: a CUDA kernel has no
    CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """K1-K3 exact against their plain versions, K4 within one ulp, and
    each launch counted."""
    kernels.reset_launch_counts()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for n, d in [(4000, 400), (257, 1025), (1, 1)]:
        x = torch.rand(n, d, device=cuda_device, generator=g)
        y = torch.where(torch.rand(n, d, device=cuda_device, generator=g)
                        < 0.5, x, x + 0.3)
        for tol in (0.0, 0.25):
            assert torch.equal(kc.l0_rows(x, y, tol),
                               kc.l0_rows_plain(x, y, tol))
    for shape, r in [((1, 512, 400), 8), ((64, 8, 28), 7),
                     ((3, 37, 129), 16)]:
        X = torch.rand(*shape, device=cuda_device, generator=g).round()
        assert torch.equal(kc.l0_shift_sum(X, r), kc.l0_shift_sum_plain(X, r))
    for r, d in [(32, 28), (5, 1000)]:
        x = torch.randn(r, d, device=cuda_device, generator=g)
        u = torch.rand(r, d, device=cuda_device, generator=g)
        for bits in (4, 8, 16):
            s = compression.row_scales(x, bits)
            q = kq.quantize_rows(x, u, s, bits)
            assert torch.equal(q, kq.quantize_rows_plain(x, u, s, bits))
            a, b = kq.dequantize_rows(q, s), kq.dequantize_rows_plain(q, s)
            ulp = torch.abs(torch.nextafter(b, torch.full_like(b, math.inf))
                            - b)
            assert bool((torch.abs(a - b) <= ulp).all())
    assert kernels.launch_counts() == {
        "l0_rows": 6, "l0_shift_sum": 3, "quantize_rows": 6,
        "dequantize_rows": 6}


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda_device):
    x = torch.rand(4, 5, device=cuda_device)
    with pytest.raises(TypeError):
        kc.l0_rows(x.double(), x.double())
    with pytest.raises(ValueError):
        kc.l0_rows(x, x[:3])
    with pytest.raises(ValueError):
        kc.l0_shift_sum(x, 2)
    with pytest.raises(ValueError):
        kq.quantize_rows(x, x, torch.ones(5, device=cuda_device))


@pytest.mark.cuda
def test_upper_bound_gpu_matches_cpu(cuda_device):
    """A short upper_bound run on the GPU launches every kernel and agrees
    with the CPU run (plain versions): characters to 1e-6, curves to 1e-5
    (ECD-PSGD within the reference's 2e-2 envelope)."""
    from repro_torch.experiments import registry, runner
    spec = registry.get_spec("upper_bound", iters=40)
    kernels.reset_launch_counts()
    gpu = runner.run_sweep(spec, device=cuda_device, use_cache=False)
    assert all(v > 0 for v in kernels.launch_counts().values())
    cpu = runner.run_sweep(spec, device="cpu", use_cache=False)
    for name, info in cpu["datasets"].items():
        for k, v in info["characters"].items():
            assert gpu["datasets"][name]["characters"][k] == pytest.approx(
                v, rel=1e-6), (name, k)
    for key, jc in cpu["jobs"].items():
        tol = 2e-2 if jc["algorithm"] == "ecd_psgd" else 1e-5
        for a, b in zip(gpu["jobs"][key]["losses"], jc["losses"]):
            assert a == pytest.approx(b, abs=tol), key
