"""K5 (RMSNorm) and K6 (flash attention): the plain versions against the
reference's Pallas kernels (``repro.kernels.ops``, interpret mode on the
CPU) and its pure-jnp oracles (``repro.kernels.ref``).  Tolerances are the
reference's own (tests/test_kernels.py): RMSNorm 1e-6 in float32 and one
bf16 ulp in bfloat16; attention 2e-5 in float32 and 2e-2 in bfloat16.
The CUDA kernels are held against the plain versions in
test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import rmsnorm as krms

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype):
    """One float32 numpy array as a JAX and a torch array of ``dtype``
    (the same values: bf16 rounding is to nearest even in both)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(x):
    """The spacing of bfloat16 at |x| (2**-133 below the normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(8, 64), (300, 128), (5, 1152)])
def test_rmsnorm_plain_matches_pallas_and_ref(n, d, dtype):
    rng = np.random.default_rng(n * d)
    xj, xt = _both(rng.standard_normal((n, d), dtype=np.float32), dtype)
    gj, gt = _both(rng.standard_normal(d, dtype=np.float32), dtype)
    got = krms.rmsnorm_plain(xt, gt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert torch.equal(krms.rmsnorm(xt, gt), got)   # CPU: the plain version
    assert torch.equal(krms.rmsnorm_2d(xt, gt), got)
    for want in (ops.rmsnorm(xj, gj), ref.rmsnorm_ref(xj, gj)):
        w, g = _np(want), _np(got)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-6)
        else:
            assert np.all(np.abs(g - w) <= _bf16_ulp(w)), \
                np.max(np.abs(g - w))


def test_rmsnorm_any_rank():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 3, 5, 32), dtype=np.float32))
    g = torch.tensor(rng.standard_normal(32, dtype=np.float32))
    out = krms.rmsnorm(x, g)
    assert out.shape == x.shape
    assert torch.equal(out[1, 2], krms.rmsnorm_2d(x[1, 2], g))


ATTN_CASES = [
    (1, 64, 2, 2, 32, 0),
    (2, 128, 4, 2, 64, 0),
    (2, 200, 4, 1, 64, 0),        # ragged seq
    (1, 256, 8, 8, 128, 0),       # MHA
    (2, 128, 4, 2, 64, 32),       # sliding window
    (1, 96, 6, 3, 48, 16),        # odd head dim / window
    (1, 160, 4, 1, 256, 48),      # gemma3's head dim, GQA 4:1, window
    (1, 100, 4, 4, 96, 0),        # phi3's head dim
    (1, 72, 16, 2, 128, 0),       # GQA 8:1
    (1, 150, 2, 1, 64, 20),       # S and window off the 64-column k tile
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,window", ATTN_CASES)
def test_attention_plain_matches_pallas_and_ref(B, S, H, KV, D, window,
                                                dtype):
    rng = np.random.default_rng(B * S + H * D + window)
    qj, qt = _both(rng.standard_normal((B, S, H, D), dtype=np.float32),
                   dtype)
    kj, kt = _both(rng.standard_normal((B, S, KV, D), dtype=np.float32),
                   dtype)
    vj, vt = _both(rng.standard_normal((B, S, KV, D), dtype=np.float32),
                   dtype)
    got = kfa.flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    plain = kfa.attention_plain(qt.transpose(1, 2), kt.transpose(1, 2),
                                vt.transpose(1, 2), True, window)
    assert torch.equal(got, plain.transpose(1, 2))
    pallas = ops.flash_attention(qj, kj, vj, causal=True, window=window,
                                 bq=64, bk=64)
    oracle = ref.attention_ref(qj.transpose(0, 2, 1, 3),
                               kj.transpose(0, 2, 1, 3),
                               vj.transpose(0, 2, 1, 3), causal=True,
                               window=window).transpose(0, 2, 1, 3)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_attention_plain_not_causal():
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, 40, 32), dtype=np.float32)
               for _ in range(3))
    got = kfa.attention_plain(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=False)
    want = ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype,D,ok", [
    (torch.bfloat16, 256, True), (torch.bfloat16, 96, True),
    (torch.bfloat16, 48, True), (torch.bfloat16, 16, True),
    (torch.bfloat16, 36, False), (torch.bfloat16, 40, False),
    (torch.bfloat16, 272, False), (torch.float32, 36, True),
    (torch.float32, 256, True), (torch.float32, 30, False),
    (torch.float32, 260, False)])
def test_head_dim_rule_per_kernel(dtype, D, ok):
    """The bf16 tensor-core kernel takes D a multiple of 16 up to 256, the
    float32 CUDA-core kernel a multiple of 4 up to 256; every head
    dimension of the configs fits the bf16 rule."""
    if ok:
        kfa.check_head_dim(D, dtype)
    else:
        with pytest.raises(ValueError):
            kfa.check_head_dim(D, dtype)


def test_config_head_dims_fit_the_bf16_kernel():
    from repro_torch.configs.registry import ARCH_IDS, get_arch
    for name in ARCH_IDS:
        kfa.check_head_dim(get_arch(name).resolved_head_dim, torch.bfloat16)
