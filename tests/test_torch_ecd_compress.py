"""ECD-PSGD's fused compression tail (``kernels.quantize.ecd_compress_rows``)
and ``compression.quantize_error`` on the CPU.

The plain fused tail equals, bit for bit, the step's sequence of PyTorch
operations from before the fusion (copied below), and the engine's
ECD-PSGD curves are unchanged by it; the port's ECD-PSGD at 4 and 16 bits
stays inside the reference's 1e-3 envelope at 60 iterations
(tests/test_core.py::test_ecd_psgd_divergence_envelope); the wrapper
rejects what the kernel does not take; ``quantize_error`` equals the
reference's given the reference's noise.  The CUDA kernel is held against
the plain version in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.data import synth as JS
from repro.experiments import engine as JEng
from repro_torch import interop, kernels
from repro_torch.core import compression
from repro_torch.core.algorithms import ecd_psgd as TE
from repro_torch.core.numerics import fma
from repro_torch.experiments import engine as TEng
from repro_torch.kernels import quantize as kq


def _inline_tail(grads, x_half, xs, ys, u, gamma, t, bits):
    """The ECD-PSGD step after the gradient, as the step wrote it before
    the fused entry point, on (r, d) rows."""
    tf = np.float32(t + 1)
    half = float(tf / np.float32(2.0))
    two_t = np.float32(2.0) / tf
    x_new = fma(-gamma, grads, x_half)
    z = fma(1.0 - half, xs, half * x_new)
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = torch.clamp_min(torch.abs(z).amax(dim=1), 1e-12) \
        / torch.tensor(qmax, dtype=torch.float32)
    q = torch.clamp(torch.floor(z / scale[:, None] + u), -qmax - 1.0, qmax)
    q = q.to(torch.int8 if bits <= 8 else torch.int16)
    cz = q.to(torch.float32) * scale[:, None]
    y_new = fma(float(np.float32(1.0) - two_t), ys, float(two_t) * cz)
    return x_new, y_new


def _rows(r, d, seed):
    """grads, x_half, xs, ys, u as (r, d) float32 from numpy; row 0 of
    grads, x_half and xs is zero when r > 1, so its z is all zeros."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((r, d)) * s for s in (0.5, 0.2, 0.2, 0.1)]
    out.append(rng.random((r, d)))
    if r > 1:
        for a in out[:3]:
            a[0] = 0.0
    return [torch.tensor(a.astype(np.float32)) for a in out]


SHAPES = [(8, 28), (32, 28), (24, 28), (5, 1000), (1, 112000), (3, 1)]


@pytest.mark.parametrize("t", [0, 1, 2999])
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("r,d", SHAPES)
def test_plain_fused_tail_equals_inline_step(r, d, bits, t):
    ins = _rows(r, d, r * d + bits + t)
    want = _inline_tail(*ins, 0.1, t, bits)
    for fn in (kq.ecd_compress_rows_plain, kq.ecd_compress_rows):
        got = fn(*ins, 0.1, t, bits)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.shape == (r, d)
            assert torch.equal(a, b), (fn.__name__, r, d, bits, t)


class _InlineEcdPsgd(TE.EcdPsgd):
    """ECD-PSGD with the step's former tail, the fusion's oracle."""

    def step(self, problem, data, ctx, state, batch, t):
        xs, ys = state
        x_half = torch.bmm(ctx.W, ys)
        idx = batch["order"]
        grads = problem.point_grad(xs, data.X[idx], data.y[idx])
        B, m_pad, d = xs.shape
        out = _inline_tail(*(a.reshape(B * m_pad, d) for a in
                             (grads, x_half, xs, ys, batch["u"])),
                           self.gamma, t, self.compress_bits)
        return tuple(a.reshape(B, m_pad, d) for a in out)


def _split(gen, kw):
    key = jax.random.PRNGKey(0)
    tr, te = JS.get_generator(gen)(key, **kw).split(key=key)
    return tr, te, interop.split((tr.X, tr.y), (te.X, te.y))


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_engine_curves_unchanged_by_fusion(bits):
    """The bucketed engine's ECD-PSGD curves through the fused entry point
    equal, bit for bit, those of the former step on the CPU."""
    _, _, (tr, te) = _split("higgs_like", {"n": 400, "d": 12})
    kw = dict(iters=60, eval_every=6)
    ms = [1, 2, 4, 8]
    got = TEng.sweep(TE.EcdPsgd(compress_bits=bits), tr, te, ms, **kw)
    want = TEng.sweep(_InlineEcdPsgd(compress_bits=bits), tr, te, ms, **kw)
    assert got["losses"] == want["losses"]


@pytest.mark.parametrize("bits", [4, 16])
def test_ecd_psgd_bits_match_reference(bits):
    """ECD-PSGD at 4 and 16 bits (8 is in test_torch_algorithms.py) against
    the reference engine inside its 1e-3 envelope at 60 iterations."""
    jtr, jte, (tr, te) = _split("higgs_like", {"n": 400, "d": 12})
    ms = [1, 2, 4, 8]
    ref = JEng.run_algorithm_sweep("ecd_psgd", jtr, jte, ms, iters=60,
                                   eval_every=6, compress_bits=bits)
    got = TEng.sweep("ecd_psgd", tr, te, ms, iters=60, eval_every=6,
                     compress_bits=bits)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=1e-3)


def _bad_inputs(case):
    g, xh, xs, ys, u = _rows(4, 8, 0)
    if case == "shape":
        return (g, xh, xs[:3], ys, u), 8, ValueError
    if case == "rank":
        return (g[0], xh[0], xs[0], ys[0], u[0]), 8, ValueError
    if case == "empty":
        return tuple(a[:, :0] for a in (g, xh, xs, ys, u)), 8, ValueError
    if case == "dtype":
        return (g.double(), xh, xs, ys, u), 8, TypeError
    if case == "strided":
        return (g, xh, xs, ys, torch.rand(8, 4).t()), 8, TypeError
    if case == "bits":
        return (g, xh, xs, ys, u), 3, ValueError
    if case == "meta":
        return tuple(torch.empty(4, 8, device="meta")
                     for _ in range(5)), 8, ValueError
    if case == "mixed":
        return (g, xh, xs, ys, torch.empty(4, 8, device="meta")), 8, \
            ValueError
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["shape", "rank", "empty", "dtype",
                                  "strided", "bits", "meta", "mixed"])
def test_ecd_compress_rows_rejects_bad_inputs(case):
    ins, bits, exc = _bad_inputs(case)
    kernels.reset_launch_counts()
    with pytest.raises(exc):
        kq.ecd_compress_rows(*ins, 0.1, 5, bits)
    assert kernels.launch_counts()["ecd_compress_rows"] == 0


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("shape", [(40, 28), (7,), (1,)])
def test_quantize_error_matches_reference(shape, bits):
    """compression.quantize_error against the reference's
    (repro/core/compression.py:34), with the noise the reference draws
    from its key handed to the port."""
    rng = np.random.default_rng(bits + len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    want = np.asarray(jc.quantize_error(x, key, bits=bits))
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    got = compression.quantize_error(torch.tensor(x), torch.tensor(u),
                                     bits=bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
