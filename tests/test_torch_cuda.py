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
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import quantize as kq
from repro_torch.kernels import rmsnorm as krms


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
        "dequantize_rows": 6, "ecd_compress_rows": 0, "rmsnorm": 0,
        "flash_attention": 0}


# K2 at the six shapes of the main path, ub's whole dataset, r >= b,
# b = 1, r = 1, d = 1, 7 and not a multiple of 4, the feature-tiled path
# (d = 20000), many batches; "unaligned" views X off 16 bytes with odd d,
# "nonfinite" plants NaN and +-inf
SHIFT_SUM_CASES = [
    ((1, 512, 400), 8, ""), ((64, 8, 400), 7, ""), ((1, 512, 28), 8, ""),
    ((64, 8, 28), 7, ""), ((1, 512, 300), 8, ""), ((64, 8, 300), 7, ""),
    ((1, 4000, 400), 8, ""), ((3, 5, 7), 13, ""), ((2, 8, 16), 8, ""),
    ((4, 1, 9), 3, ""), ((2, 37, 129), 1, ""), ((2, 9, 1), 4, ""),
    ((3, 11, 7), 5, ""), ((2, 33, 130), 6, ""), ((1, 40, 20000), 8, ""),
    ((5000, 8, 28), 7, ""), ((3, 37, 129), 16, "unaligned"),
    ((64, 8, 27), 7, "unaligned"), ((1, 512, 400), 8, "nonfinite"),
    ((64, 8, 300), 7, "nonfinite"), ((2, 6, 5), 9, "nonfinite"),
    # the character_knob specs, ls's measure_csim, scalability_study
    ((1, 1536, 48), 8, ""), ((192, 8, 48), 7, ""), ((1, 400, 28), 8, ""),
    ((1, 400, 200), 8, ""), ((1, 800, 400), 8, ""), ((100, 8, 400), 7, "")]


def _shift_input(dev, shape, kind, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(shape)
    flat = torch.rand(n + 1, device=dev, generator=g)
    flat = torch.where(torch.rand(n + 1, device=dev, generator=g) < 0.5,
                       flat, torch.zeros_like(flat))
    X = (flat[1:] if kind == "unaligned" else flat[:n]).view(shape)
    if kind == "nonfinite":
        X = X.clone()
        X.view(-1)[::7] = math.nan
        X.view(-1)[3::11] = math.inf
        X.view(-1)[5::13] = -math.inf
    return X


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r,kind", SHIFT_SUM_CASES)
def test_l0_shift_sum_kernel_matches_plain(shape, r, kind, cuda_device):
    """K2 equals its plain version exactly, one launch per call."""
    X = _shift_input(cuda_device, shape, kind, sum(shape) + r)
    assert X.is_contiguous()
    if kind == "unaligned":
        assert X.data_ptr() % 16 != 0
    kernels.reset_launch_counts()
    for tol in (0.0, 0.5):
        got = kc.l0_shift_sum(X, r, tol)
        want = kc.l0_shift_sum_plain(X, r, tol)
        assert got.dtype == torch.int64 and got.shape == (shape[0],)
        assert torch.equal(got, want), (got - want).abs().max()
    assert kernels.launch_counts()["l0_shift_sum"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 1000), (1, 64, 20000)])
def test_l0_shift_sum_totals_beyond_40_bits(shape, cuda_device):
    """r = 2^31 - 1: totals past 2^40 take the unpacked counters
    (accumulator, fence, ticket), exact over 10 launches in a row;
    r = q b + rem gives q times all offsets plus offsets 1..rem."""
    X = _shift_input(cuda_device, shape, "", 7)
    r = 2 ** 31 - 1
    plan = kc.shift_sum_plan(*shape, r)
    assert not plan.packed and plan.blocks > shape[0]
    q, rem = divmod(r, shape[1])
    want = (q * kc.l0_shift_sum_plain(X, shape[1])
            + kc.l0_shift_sum_plain(X, rem))
    assert int(want.max()) >= 2 ** 40
    outs = [kc.l0_shift_sum(X, r) for _ in range(10)]
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.cuda
def test_l0_shift_sum_back_to_back_launches(cuda_device):
    """100 launches in a row on one stream, each compared: the counters
    that meet a batch's blocks return to zero after every launch."""
    shapes = [((1, 512, 400), 8), ((64, 8, 28), 7), ((1, 4000, 400), 8),
              ((3, 37, 129), 16)]
    inputs = [(_shift_input(cuda_device, s, "", i), r)
              for i, (s, r) in enumerate(shapes)]
    outs = [kc.l0_shift_sum(*inputs[i % len(inputs)]) for i in range(100)]
    for i, got in enumerate(outs):
        X, r = inputs[i % len(inputs)]
        assert torch.equal(got, kc.l0_shift_sum_plain(X, r)), i


@pytest.mark.cuda
def test_l0_shift_sum_on_two_streams_and_in_a_graph(cuda_device):
    """Launches on two streams at once and replays of a captured graph
    give the plain totals: each stream and each capture has counters of
    its own."""
    X1 = _shift_input(cuda_device, (1, 512, 400), "", 1)
    X2 = _shift_input(cuda_device, (64, 8, 300), "", 2)
    want1, want2 = kc.l0_shift_sum_plain(X1, 8), kc.l0_shift_sum_plain(X2, 7)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for k, (s, X, r) in enumerate(zip(streams, (X1, X2), (8, 7))):
            with torch.cuda.stream(s):
                outs[k].append(kc.l0_shift_sum(X, r))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want1) for o in outs[0])
    assert all(torch.equal(o, want2) for o in outs[1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g1 = kc.l0_shift_sum(X1, 8)
        g2 = kc.l0_shift_sum(X2, 7)
    for _ in range(3):
        graph.replay()
        eager = kc.l0_shift_sum(X1, 8)
        torch.cuda.synchronize()
        assert torch.equal(g1, want1) and torch.equal(g2, want2)
        assert torch.equal(eager, want1)


@pytest.mark.cuda
def test_l0_shift_sum_captures_keep_one_counter_buffer(cuda_device):
    """Graphs captured one after another each replay the plain totals,
    while the wrapper holds counters for the latest capture only: what
    it keeps does not grow with the number of captures."""
    X = _shift_input(cuda_device, (1, 512, 400), "", 3)
    want = kc.l0_shift_sum_plain(X, 8)
    kc.l0_shift_sum(X, 8)
    torch.cuda.synchronize()
    eager = dict(kc._counters)
    graphs, outs = [], []
    for _ in range(8):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(kc.l0_shift_sum(X, 8))
        graphs.append(graph)
        assert len(kc._capture_counters) == 1
    assert kc._counters.keys() == eager.keys()
    for _ in range(2):
        for graph, out in zip(graphs, outs):
            out.zero_()
            graph.replay()
            assert torch.equal(kc.l0_shift_sum(X, 8), want)
            assert torch.equal(out, want)


@pytest.mark.cuda
def test_l0_shift_sum_is_one_device_kernel(cuda_device):
    """Under the profiler one call is one device kernel: no fill, no
    copy."""
    from torch.profiler import ProfilerActivity, profile
    X = _shift_input(cuda_device, (1, 512, 400), "", 0)
    kc.l0_shift_sum(X, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kc.l0_shift_sum(X, 8)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "l0_shift_sum" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(512, 400), (4000, 400), (512, 28),
                                 (33, 7), (1, 1), (1536, 48), (800, 400)])
def test_l0_rows_against_zero_matches_plain(n, d, cuda_device):
    """K1 from one input (row supports) equals its plain version, NaN and
    inf included; metrics.row_l0 launches it once and no zero tensor."""
    from repro_torch.core import metrics
    x = _shift_input(cuda_device, (n, d), "", n + d)
    x.view(-1)[::5] = math.nan
    x.view(-1)[1::9] = -math.inf
    kernels.reset_launch_counts()
    for tol in (0.0, 0.25):
        assert torch.equal(kc.l0_rows(x, None, tol),
                           kc.l0_rows_plain(x, None, tol))
    assert torch.equal(metrics.row_l0(x), kc.l0_rows_plain(x))
    assert kernels.launch_counts()["l0_rows"] == 3


def _tail_inputs(dev, r, d, seed, offset=0):
    """grads, x_half, xs, ys, u (r, d) on the card; row 0 of the first
    three zero when r > 1; ``offset`` floats leave rows unaligned."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = [torch.randn(offset + r * d, generator=g, device=dev) * s
            for s in (0.5, 0.2, 0.2, 0.1)]
    flat.append(torch.rand(offset + r * d, generator=g, device=dev))
    ins = [a[offset:].view(r, d) for a in flat]
    if r > 1:
        for a in ins[:3]:
            a[0] = 0.0
    return ins


# the sweep's 8, 32 and 24 rows of d = 28, ragged shapes, the scalar-load
# path (d % 4 != 0, or rows off 16 bytes), 32 floats a lane (d = 999),
# the widest warp row (1024) and the two-pass kernel (d > 1024)
ECD_TAIL_CASES = [(8, 28, 0), (32, 28, 0), (24, 28, 0), (5, 1000, 0),
                  (1, 112000, 0), (3, 1, 0), (7, 30, 0), (3, 999, 0),
                  (4, 1024, 0), (2, 1025, 0), (32, 28, 1), (5, 1000, 1),
                  # d = 400 of variance_sparsity and scalability_study
                  (1, 400, 0), (4, 400, 0), (8, 400, 0), (16, 400, 0),
                  (1, 28, 0), (16, 28, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,d,offset", ECD_TAIL_CASES)
def test_ecd_compress_kernel_matches_plain(r, d, offset, cuda_device):
    """The fused ECD-PSGD compression tail equals its plain version in
    x_new and y_new, bit for bit, for 4, 8 and 16 bits at t = 0, 1, 2999."""
    kernels.reset_launch_counts()
    ins = _tail_inputs(cuda_device, r, d, r * d + offset, offset)
    for bits in (4, 8, 16):
        for t in (0, 1, 2999):
            got = kq.ecd_compress_rows(*ins, 0.1, t, bits)
            want = kq.ecd_compress_rows_plain(*ins, 0.1, t, bits)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (bits, t)
    assert kernels.launch_counts()["ecd_compress_rows"] == 9


@pytest.mark.cuda
def test_ecd_compress_kernel_propagates_nan(cuda_device):
    """A NaN gradient and an inf model make their rows' y_new NaN, as the
    plain version's torch.amax makes them."""
    ins = _tail_inputs(cuda_device, 8, 28, 3)
    ins[0][2, 5] = math.nan
    ins[2][4, 7] = math.inf
    for bits in (4, 8, 16):
        got = kq.ecd_compress_rows(*ins, 0.1, 7, bits)
        want = kq.ecd_compress_rows_plain(*ins, 0.1, 7, bits)
        for a, b in zip(got, want):
            assert bool(((a == b) | (a.isnan() & b.isnan())).all())
        assert bool(got[1][[2, 4]].isnan().all())
        assert bool(got[1][[0, 1, 3, 5, 6, 7]].isfinite().all())


@pytest.mark.cuda
def test_ecd_psgd_steps_do_not_sync(cuda_device):
    """ECD-PSGD steps through alg.step never synchronise with the host:
    torch.cuda.set_sync_debug_mode("error") raises at any call that does."""
    from repro_torch import random as R
    from repro_torch.core import problems
    from repro_torch.core.algorithms import base as alg_base
    from repro_torch.data import synth
    from repro_torch.experiments import engine
    data = synth.get_generator("higgs_like")(
        R.PRNGKey(0, device=cuda_device), n=400, d=28)
    alg = alg_base.get_algorithm("ecd_psgd")()
    prob = problems.resolve_problem("logistic")
    draws = alg.make_draws(R.PRNGKey(1, device=cuda_device), 400, 30, 16, 28)
    ctx, state, per_elem = engine.prepare_bucket(alg, prob, data, (8, 16),
                                                 16, [draws])
    batches = [alg_base.map_draws(lambda a: a[t], per_elem)
               for t in range(30)]
    state = alg.step(prob, data, ctx, state, batches[0], 0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 30):
            state = alg.step(prob, data, ctx, state, batches[t], t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ecd_compress_rows"] == 29
    assert all(bool(torch.isfinite(s).all()) for s in state)


def _bf16_ulp(x):
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.cuda
def test_rmsnorm_kernel_matches_plain(cuda_device):
    """K5 against its plain version: float32 within the reference's 1e-6
    (assert_allclose's rtol 1e-7 beside it), bfloat16 within one ulp."""
    kernels.reset_launch_counts()
    g = torch.Generator(device=cuda_device).manual_seed(5)
    cases = [((8192, 1152), torch.bfloat16), ((4, 1152), torch.bfloat16),
             ((5, 1152), torch.float32), ((300, 128), torch.float32)]
    for (n, d), dtype in cases:
        x = torch.randn(n, d, device=cuda_device, generator=g).to(dtype)
        w = torch.randn(d, device=cuda_device, generator=g).to(dtype)
        a = krms.rmsnorm_2d(x, w).float()
        b = krms.rmsnorm_plain(x, w).float()
        bound = (1e-6 + 1e-7 * b.abs() if dtype == torch.float32
                 else _bf16_ulp(b))
        assert bool(((a - b).abs() <= bound).all()), (n, d, dtype)
    assert kernels.launch_counts()["rmsnorm"] == len(cases)


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain(cuda_device):
    """K6 against its plain version at the reference's sweep shapes and
    gemma3-1b's: float32 within 2e-5, bfloat16 within 2e-2."""
    kernels.reset_launch_counts()
    g = torch.Generator(device=cuda_device).manual_seed(6)
    cases = [(1, 64, 2, 2, 32, 0), (2, 128, 4, 2, 64, 0),
             (2, 200, 4, 1, 64, 0), (1, 256, 8, 8, 128, 0),
             (2, 128, 4, 2, 64, 32), (1, 96, 6, 3, 48, 16),
             (1, 1100, 4, 1, 256, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, KV, D, window in cases:
            q, k, v = (torch.randn(B, S, n, D, device=cuda_device,
                                   generator=g).to(dtype)
                       for n in (H, KV, KV))
            a = kfa.flash_attention(q, k, v, True, window).float()
            b = kfa.attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), True,
                                    window).transpose(1, 2).float()
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            assert bool(((a - b).abs() <= tol + tol * b.abs()).all()), \
                (B, S, H, KV, D, window, dtype)
    assert kernels.launch_counts()["flash_attention"] == 2 * len(cases)


# the bf16 tensor-core kernel's edges: phi3's D = 96, D = 128 with GQA 8:1,
# a causal S (1000) and a window (100) off its 64-column k tile and 128-row
# q tile, and S shorter than one k tile
BF16_EDGE_CASES = [
    (1, 300, 4, 4, 96, 0),
    (2, 256, 16, 2, 128, 0),
    (1, 1000, 8, 1, 128, 0),
    (1, 1000, 4, 1, 256, 100),
    (2, 1000, 8, 1, 96, 100),
    (2, 40, 4, 2, 64, 0),
    (1, 17, 2, 1, 256, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,window", BF16_EDGE_CASES)
def test_flash_attention_bf16_edges_match_plain(B, S, H, KV, D, window,
                                                cuda_device):
    """The bf16 K6 (wgmma, P rounded to bf16) within 2e-2 of the plain
    version, the same bound as at gemma3-1b's shapes."""
    kernels.reset_launch_counts()
    g = torch.Generator(device=cuda_device).manual_seed(S * D + window)
    q, k, v = (torch.randn(B, S, n, D, device=cuda_device,
                           generator=g).to(torch.bfloat16)
               for n in (H, KV, KV))
    a = kfa.flash_attention(q, k, v, True, window).float()
    b = kfa.attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), True,
                            window).transpose(1, 2).float()
    assert bool(torch.isfinite(a).all())
    assert bool(((a - b).abs() <= 2e-2 + 2e-2 * b.abs()).all()), \
        float((a - b).abs().max())
    assert kernels.launch_counts()["flash_attention"] == 1


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
    with pytest.raises(ValueError):
        kq.ecd_compress_rows(x, x, x, x, x[:3], 0.1, 0)
    with pytest.raises(ValueError):
        kq.ecd_compress_rows(x, x, x, x, x.cpu(), 0.1, 0)
    with pytest.raises(TypeError):
        kq.ecd_compress_rows(x, x, x, x, x.double(), 0.1, 0)
    with pytest.raises(TypeError):
        kq.ecd_compress_rows(x, x, x, x, torch.rand(5, 4,
                                                    device=cuda_device).t(),
                             0.1, 0)
    with pytest.raises(TypeError):
        krms.rmsnorm_2d(x.half(), torch.ones(5, device=cuda_device).half())
    with pytest.raises(ValueError):
        krms.rmsnorm_2d(x.t(), torch.ones(4, device=cuda_device))
    q = torch.rand(1, 2, 8, 32, device=cuda_device)
    kv = torch.rand(1, 1, 8, 32, device=cuda_device)
    with pytest.raises(ValueError):
        kfa.flash_attention_bhsd(q, kv[..., :16], kv[..., :16])
    with pytest.raises(ValueError):
        kfa.flash_attention_bhsd(q[..., :30], kv[..., :30], kv[..., :30])
    with pytest.raises(TypeError):
        kfa.flash_attention_bhsd(q.double(), kv.double(), kv.double())
    # D = 36: the float32 kernel takes it, the bf16 one (D % 16) does not
    q36 = torch.rand(1, 2, 8, 36, device=cuda_device)
    kv36 = torch.rand(1, 1, 8, 36, device=cuda_device)
    out = kfa.flash_attention_bhsd(q36, kv36, kv36)
    torch.cuda.synchronize()
    assert out.shape == q36.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError):
        kfa.flash_attention_bhsd(q36.bfloat16(), kv36.bfloat16(),
                                 kv36.bfloat16())
    # bf16 rows that do not start on 16 bytes
    qb = torch.rand(1, 2, 8, 40, device=cuda_device).bfloat16()
    kvb = torch.rand(1, 1, 8, 40, device=cuda_device).bfloat16()
    with pytest.raises(ValueError):
        kfa.flash_attention_bhsd(qb[..., 4:36], kvb[..., 4:36],
                                 kvb[..., 4:36])


@pytest.mark.cuda
def test_upper_bound_gpu_matches_cpu(cuda_device):
    """A short upper_bound run on the GPU launches every kernel and agrees
    with the CPU run (plain versions): characters to 1e-6, curves to 1e-5
    (ECD-PSGD within the reference's 2e-2 envelope)."""
    from repro_torch.experiments import registry, runner
    spec = registry.get_spec("upper_bound", iters=40)
    kernels.reset_launch_counts()
    gpu = runner.run_sweep(spec, device=cuda_device, use_cache=False)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("l0_rows", "l0_shift_sum"))
    # one fused launch per ECD-PSGD step (three buckets), none of K3/K4
    assert counts["ecd_compress_rows"] == 3 * 40
    assert counts["quantize_rows"] == counts["dequantize_rows"] == 0
    cpu = runner.run_sweep(spec, device="cpu", use_cache=False)
    for name, info in cpu["datasets"].items():
        for k, v in info["characters"].items():
            assert gpu["datasets"][name]["characters"][k] == pytest.approx(
                v, rel=1e-6), (name, k)
    for key, jc in cpu["jobs"].items():
        tol = 2e-2 if jc["algorithm"] == "ecd_psgd" else 1e-5
        for a, b in zip(gpu["jobs"][key]["losses"], jc["losses"]):
            assert a == pytest.approx(b, abs=tol), key


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("ls_sequence", {"n": 2400, "d": 28, "mutate_frac": 0.1}),
    ("ls_sequence", {"n": 2400, "d": 200, "mutate_frac": 0.9,
                     "density": 0.05, "lo": 0, "hi": 1}),
    ("one_sample", {"n": 100, "d": 16}),
    ("label_noise", {"base": "higgs_like", "flip_frac": 0.2, "n": 2000,
                     "d": 28}),
    ("character_knob", {"n": 1536, "d": 48, "variance": 0.25,
                        "density": 0.5, "duplication": 0.75}),
    ("heavy_tailed", {"n": 2000, "d": 28, "df": 3.0})])
def test_generators_on_the_card_equal_the_cpu(name, kw, cuda_device):
    """The new generators draw on the key's device, bit-identical to the
    CPU (their samplers use only correctly rounded operations)."""
    from repro_torch import random as R
    from repro_torch.data import synth
    gen = synth.get_generator(name)
    got = gen(R.PRNGKey(3, device=cuda_device), **kw)
    want = gen(R.PRNGKey(3), **kw)
    assert got.X.device.type == "cuda"
    assert torch.equal(got.X.cpu(), want.X)
    assert torch.equal(got.y.cpu(), want.y)


@pytest.mark.cuda
def test_samplers_on_the_card_equal_the_cpu(cuda_device):
    from repro_torch import random as R
    for fn in (lambda k: R.normal(k, (3000, 28)),
               lambda k: R.gamma(k, 1.5, (3000, 28)),
               lambda k: R.t(k, 3.0, (3000, 28)),
               lambda k: R.log_f32(R.uniform(k, (5000,), 1e-6, 40.0)),
               lambda k: R.erf_inv_f32(R.uniform(k, (5000,), -1.0, 1.0))):
        assert torch.equal(fn(R.PRNGKey(5, device=cuda_device)).cpu(),
                           fn(R.PRNGKey(5)))


@pytest.mark.cuda
@pytest.mark.parametrize("alg,kw", [
    ("momentum", {"gamma": 0.02}),
    ("momentum", {"gamma": 0.02, "nesterov": True}),
    ("local_sgd", {"gamma": 0.1, "sync_every": 4}),
    ("local_sgd", {"gamma": 0.1, "sync_every": 2, "fault": {
        "straggle_rate": 0.25, "straggle_rounds": 8, "corrupt_rate": 0.125,
        "corrupt_kind": "sign_flip", "seed": 7}}),
    ("async_svrg", {"gamma": 0.1, "anchor_every": 25}),
    ("hogwild", {"gamma": 0.05, "fault": {
        "straggle_rate": 0.5, "straggle_rounds": 8, "corrupt_rate": 0.25,
        "corrupt_kind": "sign_flip", "seed": 7}})])
def test_new_algorithms_on_the_card_match_the_cpu(alg, kw, cuda_device):
    """300 steps of each new algorithm (and of the faulted Hogwild! and
    local SGD) over the grid on the card agree with the CPU within 1e-5."""
    from repro_torch import random as R
    from repro_torch.data import synth
    from repro_torch.experiments import engine

    def run(dev):
        data = synth.get_generator("character_knob")(
            R.PRNGKey(0, device=dev), n=600, d=48, variance=1.0,
            density=0.5, duplication=0.25)
        tr, te = data.split(key=R.PRNGKey(1, device=dev))
        return engine.sweep(alg, tr, te, [1, 2, 4, 8, 16], iters=300,
                            eval_every=30, n_seeds=2, **kw)

    gpu, cpu = run(cuda_device), run(torch.device("cpu"))
    for a, b in zip(gpu["losses_seeds"], cpu["losses_seeds"]):
        for ca, cb in zip(a, b):
            assert ca == pytest.approx(cb, abs=1e-5)


@pytest.mark.cuda
def test_slot_batch_k1_matches_plain(cuda_device):
    """The slot batch's characters on the card: one K1 launch over the
    flattened (n_slots * R, D) batch, every character equal to the plain
    version's within 1e-6 (the counts exactly), an empty slot all
    zeros."""
    import numpy as np
    from repro_torch.core import advisor
    rng = np.random.default_rng(0)
    S, R_, D = 8, 512, 64
    Xp = np.zeros((S, R_, D), np.float32)
    rm = np.zeros((S, R_), np.float32)
    cm = np.zeros((S, D), np.float32)
    for s, (r, c) in enumerate([(512, 28), (400, 64), (2, 1), (37, 13),
                                (512, 64), (100, 5), (300, 40)]):
        Xp[s, :r, :c] = (rng.random((r, c)) > 0.6) * rng.normal(size=(r, c))
        rm[s, :r] = 1.0
        cm[s, :c] = 1.0
    inputs = [torch.tensor(a) for a in (Xp, rm, cm)]
    kernels.reset_launch_counts()
    got = advisor.masked_dataset_characters(
        *(t.to(cuda_device) for t in inputs))
    assert kernels.launch_counts()["l0_rows"] == 1
    want = advisor.masked_dataset_characters(*inputs)
    for k in ("n", "d", "omega", "sparsity", "density"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for k, v in want.items():
        assert torch.allclose(got[k].cpu(), v, rtol=0, atol=1e-6), k
        assert float(got[k][7]) == (1.0 if k == "density" else 0.0), k


@pytest.mark.cuda
def test_l0_shift_sum_from_concurrent_threads(cuda_device):
    """K2 from eight threads at once, with shapes whose batch counts
    differ (one beyond the counter buffer's first size): every total
    equals the plain version's and every launch is counted."""
    import threading
    shapes = [((1, 512, 400), 8), ((64, 8, 28), 7), ((3000, 8, 20), 7),
              ((1, 1536, 48), 8)] * 2
    g = torch.Generator(device=cuda_device).manual_seed(1)
    inputs = [torch.rand(*s, device=cuda_device, generator=g).round()
              for s, _ in shapes]
    want = [kc.l0_shift_sum_plain(x, r) for x, (_, r) in zip(inputs, shapes)]
    kernels.reset_launch_counts()
    got, errors = [None] * len(shapes), []

    def run(i):
        try:
            for _ in range(20):
                got[i] = kc.l0_shift_sum(inputs[i], shapes[i][1])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(shapes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kernels.launch_counts()["l0_shift_sum"] == 20 * len(shapes)


@pytest.mark.cuda
def test_service_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """The advisor service on the card answers what it answers on the
    CPU: tiers, statuses and integer m_max of an analytic batch (slot
    batch and oversize fallback, one K1 launch each) and of a measured
    escalation."""
    import numpy as np
    from repro_torch.experiments.spec import DatasetSpec
    from repro_torch.service.api import AdvisorService, ProbeRequest

    def probes():
        X = np.random.default_rng(0).normal(size=(40, 6))
        return ([ProbeRequest(X=X, request_id="raw"),
                 ProbeRequest(X=np.full((3, 3), np.nan), request_id="bad")]
                + [ProbeRequest(dataset=DatasetSpec("higgs_like",
                                                    {"n": 600, "d": 28}, s),
                                request_id=f"h{s}") for s in range(3)]
                + [ProbeRequest(dataset=DatasetSpec(
                    "realsim_like", {"n": 600, "d": 200, "density": 0.05}),
                    request_id="wide")])

    out = {}
    for dev in (cuda_device, "cpu"):
        svc = AdvisorService(device=dev, cache_dir=str(tmp_path / str(dev)),
                             sweep_iters=60, sweep_eval_every=20)
        kernels.reset_launch_counts()
        resp = svc.probe_batch(probes())
        if dev == cuda_device:
            assert kernels.launch_counts()["l0_rows"] == 2
        esc = svc.probe(ProbeRequest(
            dataset=DatasetSpec("higgs_like", {"n": 400, "d": 28}),
            escalate=True, algorithm="minibatch"))
        out[str(dev)] = resp + [esc]
    for g, c in zip(out[str(cuda_device)], out["cpu"]):
        assert (g.status, g.tier) == (c.status, c.tier)
        if g.status == "ok" and g.tier == "analytic":
            for strat in ("hogwild", "sync", "dadm", "momentum",
                          "local_sgd", "svrg"):
                assert g.report[strat]["predicted_m_max"] == \
                    c.report[strat]["predicted_m_max"]
    assert out[str(cuda_device)][-1].escalation["measured_m_max"] == \
        out["cpu"][-1].escalation["measured_m_max"]


# K3/K4 as the gossip step gives them: the R replicas of one leaf as rows;
# gemma3-1b's tied embedding at R = 2, and an odd width
@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(2, 262144 * 1152), (3, 1000003)])
def test_quantize_at_gossip_shapes_match_plain(rows, d, cuda_device):
    """K3 and K4 equal their plain versions bit for bit at widths of 10^8
    elements a row (the grid-stride loop's int64 indexing), one launch
    each."""
    from repro_torch import random as R
    keys = torch.stack([R.PRNGKey(11 + i, device=cuda_device)
                        for i in range(rows)])
    x = (R.uniform(keys, (d,), -0.2, 0.2)
         * torch.arange(1, rows + 1, device=cuda_device)[:, None])
    u = R.uniform(R.fold_in(keys, 1), (d,))
    scale = compression.row_scales(x, 8)
    kernels.reset_launch_counts()
    q = kq.quantize_rows(x, u, scale, 8)
    deq = kq.dequantize_rows(q, scale)
    assert kernels.launch_counts()["quantize_rows"] == 1
    assert kernels.launch_counts()["dequantize_rows"] == 1
    qp = kq.quantize_rows_plain(x, u, scale, 8)
    assert torch.equal(q, qp)
    del x, u, qp
    assert torch.equal(deq, kq.dequantize_rows_plain(q, scale))


def _reduced_gemma3_on(dev):
    """Reduced gemma3-1b with the same float32 weights on the CPU and on
    ``dev``."""
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    cfg = get_arch("gemma3-1b").reduced()
    lm = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tree = interop.lm_tree(lm)
    return cfg, lm, interop.lm_params(cfg, tree, dev)


@pytest.mark.cuda
def test_sync_train_steps_on_the_card_match_the_cpu(cuda_device):
    """Three sync AdamW steps at reduced gemma3-1b (float32, TF32 off):
    the card's losses within 1e-5 of the CPU's."""
    from repro_torch.launch.train import train_loop
    cfg, cpu_lm, gpu_lm = _reduced_gemma3_on(cuda_device)
    kw = dict(steps=3, batch_size=4, seq_len=64, lr=2e-3, log_every=1000)
    _, want, _ = train_loop(cfg, params=cpu_lm, device="cpu", **kw)
    _, got, _ = train_loop(cfg, params=gpu_lm, device=cuda_device, **kw)
    assert gpu_lm.embed["table"].device.type == "cuda"
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                               rtol=1e-5, atol=0)
    assert got[-1] < got[0]


@pytest.mark.cuda
def test_gossip_step_on_the_card_matches_the_cpu(cuda_device):
    """One ECD-PSGD gossip step at R = 2: C(.) through K3/K4 on the card
    (one launch each per leaf and compression) against the plain versions
    on the CPU.  The first compression sees equal inputs and draws the
    same noise, so the new parameters agree within 1e-5 of each leaf's
    largest magnitude; y = C(z) may sit one quantum off on at most 0.1 %
    of elements where z's last bits differ."""
    from repro_torch import tree as T
    from repro_torch.train import steps as S
    cfg, cpu_lm, gpu_lm = _reduced_gemma3_on(cuda_device)
    g = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    step = S.make_gossip_step(cfg, replicas=2, lr=2e-3)
    want, _ = step(S.init_gossip_state(cfg, 2, params=cpu_lm), batch)
    kernels.reset_launch_counts()
    got, metrics = step(S.init_gossip_state(cfg, 2, params=gpu_lm),
                        {k: v.to(cuda_device) for k, v in batch.items()})
    n_leaves = len(T.flatten(want["y"])[0])
    counts = kernels.launch_counts()
    assert counts["quantize_rows"] == counts["dequantize_rows"] == 2 * n_leaves
    assert counts["ecd_compress_rows"] == 0
    assert bool(torch.isfinite(metrics["loss"]))
    off = total = 0
    for (path, x), (_, xw), (_, y), (_, yw) in zip(
            T.flatten_with_path(got["params"]),
            T.flatten_with_path(want["params"]),
            T.flatten_with_path(got["y"]), T.flatten_with_path(want["y"])):
        x, y = x.cpu(), y.cpu()
        assert (x - xw).abs().max() <= 1e-5 * xw.abs().max(), path
        quantum = xw.reshape(2, -1).abs().amax(dim=1) / 127.0
        diff = (y - yw).abs().reshape(2, -1)
        assert bool((diff <= quantum[:, None] * (1 + 1e-5)).all()), path
        off += int((diff > quantum[:, None] * 1e-3).sum())
        total += diff.numel()
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.cuda
def test_mesh_path_on_the_card(cuda_device):
    """upper_bound's buckets sharded over 4 shards of the card hold every
    curve to 1e-5 of mesh=None (ECD-PSGD 2e-2) with every m_max equal; a
    one-shard mesh is bit-exact; each shard launches the fused tail once
    a step; the race at m = 4 on 4 shards holds the staleness oracle."""
    from repro_torch.data import synth
    from repro_torch import random as R
    from repro_torch.distributed import from_devices, run_hogwild_sharded
    from repro_torch.experiments import engine, registry, runner
    spec = registry.get_spec("upper_bound", iters=60, seeds=2)
    base = runner.run_sweep(spec, device=cuda_device, use_cache=False)
    kernels.reset_launch_counts()
    sharded = runner.run_sweep(spec, device=cuda_device, use_cache=False,
                               mesh=from_devices([cuda_device] * 4))
    assert kernels.launch_counts()["ecd_compress_rows"] == 4 * 3 * 60
    one = runner.run_sweep(spec, device=cuda_device, use_cache=False,
                           mesh=from_devices([cuda_device]))
    assert sharded["execution"]["sharded"] and sharded["execution"][
        "devices"] == 4
    for key, jb in base["jobs"].items():
        js, jo = sharded["jobs"][key], one["jobs"][key]
        tol = 2e-2 if jb["algorithm"] == "ecd_psgd" else 1e-5
        for a, b in zip(js["losses_seeds"], jb["losses_seeds"]):
            for ca, cb in zip(a, b):
                assert ca == pytest.approx(cb, abs=tol), key
        assert js["measured_m_max"] == jb["measured_m_max"]
        assert jo["losses_seeds"] == jb["losses_seeds"]
    ds = synth.get_generator("higgs_like")(R.PRNGKey(0, device=cuda_device),
                                           n=400, d=16)
    tr, te = ds.split(key=R.PRNGKey(0, device=cuda_device))
    kw = dict(iters=800, gamma=0.05, eval_every=200)
    race = run_hogwild_sharded(tr, te, m=4, mesh=from_devices(
        [cuda_device] * 4), **kw)
    oracle = engine.sweep("hogwild", tr, te, [4], **kw)["losses"][0]
    assert race["psum_rounds"] == 800 // 4 + 4
    for a, b in zip(race["losses"], oracle):
        assert a == pytest.approx(b, abs=1e-5)


@pytest.mark.cuda
def test_traced_sweep_on_the_card(cuda_device, tmp_path):
    """Under a tracer every bucket span on the card has an execute child
    and the artifact bytes equal an untraced run's."""
    from repro_torch.experiments import registry, runner
    from repro_torch.telemetry import trace
    spec = registry.get_spec("upper_bound", iters=40)
    plain = runner.run_sweep(spec, device=cuda_device,
                             cache_dir=str(tmp_path / "plain"))
    trace.start()
    try:
        traced = runner.run_sweep(spec, device=cuda_device,
                                  cache_dir=str(tmp_path / "traced"))
    finally:
        tracer = trace.stop()
    with open(plain["cache"]["path"], "rb") as a, \
            open(traced["cache"]["path"], "rb") as b:
        assert a.read() == b.read()
    events = tracer.events
    buckets = [e for e in events if e["name"] == "bucket"]
    executes = [e for e in events if e["name"] == "execute"]
    assert buckets and len(executes) >= len(buckets)
    for b in buckets:
        assert any(x["tid"] == b["tid"] and x["ts"] >= b["ts"] - 1e-3
                   and x["ts"] + x["dur"] <= b["ts"] + b["dur"] + 1e-3
                   for x in executes)
    assert trace.phase_breakdown(events, root="sweep")["coverage"] >= 0.95


# K6 at the families' shapes, cut to 512 rows: zamba2's shared attention
# (32:32, D = 64) and arctic's GQA 56:8 (a group of 7, D = 128)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,KV,D", [(32, 32, 64), (56, 8, 128)])
def test_flash_attention_at_family_shapes(H, KV, D, dtype, cuda_device):
    kernels.reset_launch_counts()
    g = torch.Generator(device=cuda_device).manual_seed(H + D)
    q, k, v = (torch.randn(2, 512, n, D, device=cuda_device,
                           generator=g).to(dtype) for n in (H, KV, KV))
    a = kfa.flash_attention(q, k, v, True, 0).float()
    b = kfa.attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), True, 0).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert bool(((a - b.float()).abs() <= tol + tol * b.float().abs()).all())
    assert kernels.launch_counts()["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gated_norm_through_k5(dtype, cuda_device):
    """The SSM blocks' gated norm: through K5 on the card (one launch)
    and through K5's plain version, within K5's own tolerances."""
    from repro_torch.models import ssm
    g = torch.Generator(device=cuda_device).manual_seed(8)
    x, z = (torch.randn(4, 256, 4096, device=cuda_device,
                        generator=g).to(dtype) for _ in range(2))
    scale = torch.randn(4096, device=cuda_device, generator=g).to(dtype)
    kernels.reset_launch_counts()
    a = ssm._gated_rmsnorm(x, z, scale, use_kernel=True).float()
    assert kernels.launch_counts()["rmsnorm"] == 1
    b = ssm._gated_rmsnorm(x, z, scale, use_kernel=False).float()
    assert kernels.launch_counts()["rmsnorm"] == 1
    bound = (1e-6 + 1e-7 * b.abs() if dtype == torch.float32
             else _bf16_ulp(b))
    assert bool(((a - b).abs() <= bound).all())


# per prefill (and per decode step for K5) on the reduced configs:
# xlstm (mLSTM, sLSTM; LayerNorm elsewhere), zamba2 (Mamba2, shared
# attention), arctic (2 MoE attention layers)
REDUCED_FAMILY_LAUNCHES = {"xlstm-350m": (2, 0), "zamba2-1.2b": (5, 1),
                           "arctic-480b": (5, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(REDUCED_FAMILY_LAUNCHES))
def test_families_on_the_card_match_the_cpu(arch, cuda_device):
    """Reduced float32 models from the same weights: the card (K5, K6)
    against the CPU (plain versions), prefill and decode logits within
    1e-4, with the predicted K5/K6 launches."""
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    cfg = get_arch(arch).reduced()
    lm = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    on_card = interop.lm_params(cfg, interop.lm_tree(lm), cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(4))
    k5, k6 = REDUCED_FAMILY_LAUNCHES[arch]
    kernels.reset_launch_counts()
    got, aux = M.forward(on_card, cfg, {"tokens": tokens.to(cuda_device)})
    assert (kernels.launch_counts()["rmsnorm"],
            kernels.launch_counts()["flash_attention"]) == (k5, k6)
    want, want_aux = M.forward(lm, cfg, {"tokens": tokens})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux["load_balance_loss"].cpu(),
                               want_aux["load_balance_loss"], atol=1e-5,
                               rtol=1e-5)
    states = {"cpu": M.init_decode_state(cfg, 2, 48, device="cpu"),
              "cuda": M.init_decode_state(cfg, 2, 48, device=cuda_device)}
    kernels.reset_launch_counts()
    for t in range(8):
        a, states["cuda"] = M.decode_step(
            on_card, cfg, tokens[:, t:t + 1].to(cuda_device), states["cuda"])
        b, states["cpu"] = M.decode_step(lm, cfg, tokens[:, t:t + 1],
                                         states["cpu"])
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    assert (kernels.launch_counts()["rmsnorm"],
            kernels.launch_counts()["flash_attention"]) == (8 * k5, 0)


@pytest.mark.cuda
def test_moe_ties_and_drops_on_the_card(cuda_device):
    """Equal router logits on the card: ties go to the lower experts and
    the same assignments are dropped as on the CPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    cfg = get_arch("arctic-480b").reduced()
    p = moe.init_moe(torch.Generator().manual_seed(2), cfg, torch.float32,
                     "cpu")
    p["router"] = torch.zeros_like(p["router"])
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    on_card = {k: ({j: w.to(cuda_device) for j, w in v.items()}
                   if isinstance(v, dict) else v.to(cuda_device))
               for k, v in p.items()}
    for dropless in (False, True):
        want, want_aux = moe.moe_forward(p, cfg, x, dropless=dropless)
        got, aux = moe.moe_forward(on_card, cfg, x.to(cuda_device),
                                   dropless=dropless)
        scale = float(want.pow(2).mean().sqrt())
        torch.testing.assert_close(got.cpu() / scale, want / scale,
                                   atol=1e-4, rtol=1e-4)
        for k in want_aux:
            torch.testing.assert_close(aux[k].cpu(), want_aux[k], atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.cuda
def test_flash_attention_at_whisper_shape(cuda_device):
    """K6 in bfloat16 at whisper-small's decoder prefill, (4, 12, 448, 64)
    causal: 448 rows are ragged against the 128-row q tiles."""
    kernels.reset_launch_counts()
    g = torch.Generator(device=cuda_device).manual_seed(448)
    q, k, v = (torch.randn(4, 448, 12, 64, device=cuda_device,
                           generator=g).to(torch.bfloat16) for _ in range(3))
    a = kfa.flash_attention(q, k, v, True, 0).float()
    b = kfa.attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), True, 0).transpose(1, 2)
    b = b.float()
    assert bool(((a - b).abs() <= 2e-2 + 2e-2 * b.abs()).all())
    assert kernels.launch_counts()["flash_attention"] == 1


# per prefill on the reduced configs: whisper (LayerNorm, 2 causal decoder
# layers; the encoder and cross-attention are plain), qwen2-vl (2 layers)
REDUCED_MULTIMODAL_LAUNCHES = {"whisper-small": (0, 2),
                               "qwen2-vl-72b": (5, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(REDUCED_MULTIMODAL_LAUNCHES))
def test_multimodal_prefill_on_the_card_matches_the_cpu(arch, cuda_device):
    """Reduced float32 models from the same weights, with whisper's frames
    or qwen2-vl's vision embeddings and grid positions: the card (K5, K6)
    against the CPU (plain versions), prefill logits within 1e-4, with
    the predicted K5/K6 launches."""
    from _torch_mrope import grid_positions
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    cfg = get_arch(arch).reduced()
    lm = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    on_card = interop.lm_params(cfg, interop.lm_tree(lm), cuda_device)
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                     generator=g)}
    if cfg.encoder_layers:
        batch["frames"] = 0.1 * torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                            generator=g)
    if cfg.vision_tokens:
        batch["vision_embeds"] = 0.02 * torch.randn(
            2, cfg.vision_tokens, cfg.d_model, generator=g)
        batch["positions"] = grid_positions(2, 40, cfg.vision_tokens)
    kernels.reset_launch_counts()
    got, _ = M.forward(on_card, cfg,
                       {k: v.to(cuda_device) for k, v in batch.items()})
    assert (kernels.launch_counts()["rmsnorm"],
            kernels.launch_counts()["flash_attention"]) \
        == REDUCED_MULTIMODAL_LAUNCHES[arch]
    want, _ = M.forward(lm, cfg, batch)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
