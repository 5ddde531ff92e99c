"""K1-K4: the plain versions against the reference's Pallas kernels
(``repro.kernels.ops``, interpret mode on the CPU), exactly.  The CUDA
kernels are held against the plain versions in test_torch_cuda.py."""

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch import kernels
from repro_torch import random as R
from repro_torch.core import compression
from repro_torch.kernels import csim as kc
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import quantize as kq
from repro_torch.kernels import rmsnorm as krms


def _pair(n, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d)) < 0.6) * rng.random((n, d))
    y = x + (rng.random((n, d)) < 0.3) * rng.random((n, d)) * 0.5
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("n,d", [(512, 400), (33, 7), (300, 600), (1, 1)])
@pytest.mark.parametrize("tol", [0.0, 0.25])
def test_l0_rows_plain_matches_pallas(n, d, tol):
    x, y = _pair(n, d, n + d)
    ref = np.asarray(ops.l0_rows(x, y, tol))
    got = kc.l0_rows_plain(torch.tensor(x), torch.tensor(y), tol)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("n,d,rng", [(128, 40, 8), (37, 9, 1), (20, 5, 16)])
@pytest.mark.parametrize("tol", [0.0, 0.25])
def test_l0_shift_sum_plain_matches_pallas_csim(n, d, rng, tol):
    x, _ = _pair(n, d, rng)
    ref = float(ops.csim(x, rng, tol))
    total = int(kc.l0_shift_sum_plain(torch.tensor(x)[None], rng, tol)[0])
    assert ref * n * rng == pytest.approx(total, abs=0.5)
    from repro_torch.core import metrics
    assert metrics.csim(torch.tensor(x), rng, tol) == ref


def test_l0_shift_sum_plain_matches_per_shift_l0_rows():
    """K2 with r = b - 1 replaces the per-shift l0_rows calls of
    _pairwise_l0_means (metrics.py:140)."""
    x, _ = _pair(64 * 8, 30, 2)
    batches = x.reshape(64, 8, 30)
    cols = np.arange(8)
    want = np.zeros(64)
    for s in range(1, 8):
        rolled = batches[:, (cols + s) % 8].reshape(-1, 30)
        want += np.asarray(ops.l0_rows(x, rolled)).reshape(64, 8).sum(1)
    got = kc.l0_shift_sum_plain(torch.tensor(batches), 7)
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("n,d", [(512, 400), (33, 7), (1, 1)])
@pytest.mark.parametrize("tol", [0.0, 0.25])
def test_l0_rows_against_zero_matches_pallas(n, d, tol):
    """K1's one-input form (y=None) equals the reference's l0_rows against
    a zero tensor, and metrics.row_l0 goes through it."""
    from repro_torch.core import metrics
    x, _ = _pair(n, d, n * d)
    x[0, 0] = -0.0
    ref = np.asarray(ops.l0_rows(x, np.zeros_like(x), tol))
    np.testing.assert_array_equal(
        ref, kc.l0_rows_plain(torch.tensor(x), None, tol).numpy())
    np.testing.assert_array_equal(
        ref, metrics.row_l0(torch.tensor(x), tol).numpy())


def _plan_blocks(plan, b, d):
    """The blocks of a K2 launch for one batch, decoded as csrc/l0.cu's
    kernel decodes blockIdx.x: (first row, owned rows, first feature,
    features, first offset, offsets, gap, staged rows)."""
    per_batch = plan.tiles * plan.chunks * plan.slices
    for blk in range(per_batch):
        slice_, rest = blk % plan.slices, blk // plan.slices
        chunk, i0 = rest % plan.chunks, rest // plan.chunks * plan.rows
        f0 = slice_ * plan.width
        s0 = plan.s_lo + chunk * plan.chunk
        cn = min(plan.chunk, plan.s_lo + plan.n_off - s0)
        gap = max(s0 - plan.rows, 0)
        yield (i0, min(plan.rows, b - i0), f0, min(plan.width, d - f0), s0,
               cn, gap, s0 + cn + plan.rows - 1 - gap)


# the main path's six shapes, ub's whole dataset, r >= b, b = 1, r = 1,
# d = 1 and 7, wide rows (feature slices), many batches, long batches
# whose offsets come in chunks
PLAN_CASES = [(1, 512, 400, 8), (64, 8, 400, 7), (1, 512, 28, 8),
              (64, 8, 28, 7), (1, 512, 300, 8), (64, 8, 300, 7),
              (1, 4000, 400, 8), (3, 5, 7, 13), (2, 8, 16, 8), (4, 1, 9, 3),
              (2, 37, 129, 1), (2, 9, 1, 4), (3, 11, 7, 5), (1, 40, 20000, 8),
              (5000, 8, 20000, 7), (1, 4000, 400, 3999), (1, 3000, 20000, 40),
              (2, 6, 3, 0)]


@pytest.mark.parametrize("nb,b,d,r", PLAN_CASES)
def test_shift_sum_plan_covers_each_row_and_shift_once(nb, b, d, r):
    """Every (row, shift j) pair of a batch is counted with weight equal
    to the shifts j in 1..r that reach it, and the slices cover every
    feature exactly once (blocks are every tile x chunk x slice); the
    staged rows hold what the counting loop reads; shared
    memory stays within the static 48 KB (so within 227 KB); the main
    path's shapes launch at least 128 blocks, or at d = 28, too narrow
    to slice, one block per 8 rows."""
    plan = kc.shift_sum_plan(nb, b, d, r)
    assert plan.smem_bytes <= kc.SMEM_BYTES < 48 * 1024 <= 227 * 1024
    # a packed counter word: the total below bit 40, tickets above
    assert plan.packed == (b * d * r < 2 ** 40)
    assert plan.blocks == nb * plan.tiles * plan.chunks * plan.slices
    if (b, r) in ((512, 8), (8, 7)):
        assert plan.blocks >= 128 or (d <= kc.MIN_WIDTH
                                      and plan.blocks == nb * b // 8)
    mult = np.zeros((b, b), dtype=np.int64)      # (row i, offset s)
    for j in range(1, r + 1):
        mult[np.arange(b), j % b] += 1
    cover = np.zeros((b, b), dtype=np.int64)
    features = np.zeros(d, dtype=np.int64)
    for i0, own, f0, fw, s0, cn, gap, nstage in _plan_blocks(plan, b, d):
        assert 0 < own and 0 <= fw and nstage <= plan.stage_rows
        if i0 == 0 and s0 == plan.s_lo:
            features[f0:f0 + fw] += 1
        if f0:
            continue
        # the kernel reads row t at local t and its partner at local
        # t + s - gap, staged from row i0 + u, u = l (+ gap past the rows)
        t = np.arange(own)[:, None]
        s = np.arange(s0, s0 + cn)[None, :]
        local = t + s - gap
        assert ((local < nstage) & ((local >= plan.rows) | (gap == 0))).all()
        u = np.where(local < plan.rows, local, local + gap)
        np.testing.assert_array_equal((i0 + u) % b, (i0 + t + s) % b)
        cover[i0:i0 + own, s0:s0 + cn] += plan.q + ((1 <= s)
                                                     & (s <= plan.rem))
    np.testing.assert_array_equal(cover, mult)
    np.testing.assert_array_equal(features, np.ones(d, dtype=np.int64))


@pytest.mark.parametrize("shape,r,smem", [((2, 5, 7), 13, None),
                                          ((3, 37, 129), 16, None),
                                          ((1, 300, 40), 299, 2048),
                                          ((2, 100, 9), 250, 2048)])
def test_shift_sum_plan_blocks_sum_to_plain(shape, r, smem, monkeypatch):
    """The kernel's block decomposition, run in numpy, gives the plain
    totals exactly, NaN, inf and a negative tol included; a small shared
    memory forces offset chunks and feature slices."""
    if smem:
        monkeypatch.setattr(kc, "SMEM_BYTES", smem)
    rng = np.random.default_rng(r)
    X = ((rng.random(shape) < 0.5) * rng.random(shape)).astype(np.float32)
    X.reshape(-1)[::17] = np.nan
    X.reshape(-1)[5::23] = np.inf
    nb, b, d = shape
    plan = kc.shift_sum_plan(nb, b, d, r)
    if smem:
        assert plan.chunks > 1 and plan.smem_bytes <= smem
    for tol in (0.0, 0.5, -1.0):
        got = np.zeros(nb, dtype=np.int64)
        for i0, own, f0, fw, s0, cn, gap, nstage in _plan_blocks(plan, b, d):
            rows = [(i0 + (l if l < plan.rows else l + gap)) % b
                    for l in range(nstage)]
            staged = X[:, rows, f0:f0 + fw]
            for s in range(s0, s0 + cn):
                weight = plan.q + (1 <= s <= plan.rem)
                y = staged[:, s - gap:s - gap + own]
                with np.errstate(invalid="ignore"):
                    hit = np.abs(staged[:, :own] - y) > tol
                got += weight * hit.sum(axis=(1, 2))
        want = kc.l0_shift_sum_plain(torch.tensor(X), r, tol).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,d", [(48, 28), (1, 7)])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_plain_matches_pallas(n, d, bits):
    """ops.quantize_stochastic draws u = uniform(key, (n, d)) (no padding
    below the 256 x 512 tile) and reduces one scale in its wrapper; given
    that scale as the one-row case, K3's and K4's plain versions give the
    reference's integers and values exactly."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(n * d + bits)
    q_ref, s_ref = ops.quantize_stochastic(x, key, bits=bits)
    u = R.uniform(R.PRNGKey(n * d + bits), (n, d)).reshape(1, -1)
    scale = torch.tensor([float(s_ref)], dtype=torch.float32)
    q = kq.quantize_rows_plain(torch.tensor(x).reshape(1, -1), u, scale,
                               bits)
    assert q.dtype == {4: torch.int8, 8: torch.int8, 16: torch.int16}[bits]
    np.testing.assert_array_equal(np.asarray(q_ref), q.reshape(n, d).numpy())
    np.testing.assert_array_equal(
        np.asarray(ops.dequantize(q_ref, s_ref)),
        kq.dequantize_rows_plain(q, scale).reshape(n, d).numpy())


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_stochastic_matches_reference(bits):
    """The port's C(.) — scale, integers and values — against the
    reference's jnp operator (compression.py:15)."""
    from repro.core import compression as jc
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((40, 28)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    q_ref, s_ref = jc.quantize_stochastic(x, key, bits=bits)
    q, s = compression.quantize_stochastic(
        torch.tensor(x), R.uniform(R.PRNGKey(bits), (40, 28)), bits=bits)
    assert float(s_ref) == float(s)
    np.testing.assert_array_equal(np.asarray(q_ref), q.numpy())
    np.testing.assert_array_equal(np.asarray(jc.dequantize(q_ref, s_ref)),
                                  compression.dequantize(q, s).numpy())


def test_row_scales_match_per_row_reference():
    """Each row quantized alone by the reference equals that row of one
    batched per-row call (ECD-PSGD's vmapped C(.), ecd_psgd.py:76)."""
    from repro.core import compression as jc
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((24, 28)) * np.arange(1, 25)[:, None]
         ).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 24)
    u = R.uniform(R.split(R.PRNGKey(4), 24), (28,))
    q, s = compression.quantize_rows_stochastic(torch.tensor(z), u)
    cz = compression.dequantize_rows(q, s)
    for i in range(24):
        qi, si = jc.quantize_stochastic(z[i], keys[i])
        np.testing.assert_array_equal(np.asarray(qi), q[i].numpy())
        np.testing.assert_array_equal(np.asarray(jc.dequantize(qi, si)),
                                      cz[i].numpy())


def test_cpu_route_counts_no_launch():
    kernels.reset_launch_counts()
    x = torch.rand(4, 5)
    kc.l0_rows(x, x)
    kc.l0_shift_sum(x[None], 2)
    q = kq.quantize_rows(x, x, torch.ones(4))
    kq.dequantize_rows(q, torch.ones(4))
    kq.ecd_compress_rows(x, x, x, x, x, 0.1, 0)
    krms.rmsnorm_2d(x, torch.ones(5))
    kfa.flash_attention_bhsd(x.reshape(1, 1, 4, 5), x.reshape(1, 1, 4, 5),
                             x.reshape(1, 1, 4, 5))
    assert kernels.launch_counts() == {
        "l0_rows": 0, "l0_shift_sum": 0, "quantize_rows": 0,
        "dequantize_rows": 0, "ecd_compress_rows": 0, "rmsnorm": 0,
        "flash_attention": 0}


def test_other_devices_raise():
    x = torch.empty(4, 5, device="meta")
    with pytest.raises(ValueError):
        kc.l0_rows(x, x)
    with pytest.raises(ValueError):
        kc.l0_shift_sum(x[None], 2)
    with pytest.raises(ValueError):
        kq.quantize_rows(x, x, torch.empty(4, device="meta"))
    with pytest.raises(ValueError):
        krms.rmsnorm_2d(x, torch.empty(5, device="meta"))
    with pytest.raises(ValueError):
        kfa.flash_attention_bhsd(x[None, None], x[None, None], x[None, None])
