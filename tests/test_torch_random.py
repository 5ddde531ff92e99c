"""The port's threefry samplers against jax.random, bit for bit, at the
shapes of the call sites the upper_bound slice uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as R

from _torch_threads import one_torch_thread  # noqa: F401


def _same(ref, got):
    ref = np.asarray(ref)
    if ref.dtype == np.uint32:
        ref = ref.astype(np.int64)
    got = got.numpy()
    assert ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2 ** 31 - 1])
def test_prngkey_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed, device="cpu")
    _same(jk, tk)
    _same(jax.random.split(jk), R.split(tk))
    _same(jax.random.split(jk, 24), R.split(tk, 24))
    for data in (0, 1, 5, 2999):
        _same(jax.random.fold_in(jk, data), R.fold_in(tk, data))


@pytest.mark.parametrize("shape,lo,hi", [
    ((4000, 400), 0.0, 1.0),        # upper_bound values, synth.py:165-167
    ((4000, 28), -4.0, 3.0),        # higgs_like, synth.py:105-107
    ((1000, 300), 0.0, 1.0),        # realsim_like values, synth.py:97-99
    ((7,), 0.0, 1.0),
])
def test_uniform(shape, lo, hi):
    _same(jax.random.uniform(jax.random.PRNGKey(3), shape,
                             minval=lo, maxval=hi),
          R.uniform(R.PRNGKey(3, device="cpu"), shape, lo, hi))


@pytest.mark.parametrize("p,shape", [(0.7, (4000, 400)),
                                     (0.05, (1000, 300))])
def test_bernoulli(p, shape):
    _same(jax.random.bernoulli(jax.random.PRNGKey(5), p, shape),
          R.bernoulli(R.PRNGKey(5, device="cpu"), p, shape))


@pytest.mark.parametrize("shape,n", [
    ((3000, 24), 2800),             # minibatch.py:40 / ecd_psgd.py:52
    ((3000,), 2800),                # hogwild.py:83
    ((3000, 24, 8), 700),           # dadm.py:54
    ((10,), 1),
    ((5, 3), 70000),                # span above 2**16
])
def test_randint(shape, n):
    jk = jax.random.split(jax.random.PRNGKey(11))[0]
    tk = R.split(R.PRNGKey(11, device="cpu"))[0]
    _same(jax.random.randint(jk, shape, 0, n), R.randint(tk, shape, 0, n))


@pytest.mark.parametrize("n", [4000, 1000, 17, 1])
def test_permutation(n):
    # Dataset.split's shuffle (spec.py:311 -> synth.py:79)
    _same(jax.random.permutation(jax.random.PRNGKey(0), n),
          R.permutation(R.PRNGKey(0, device="cpu"), n))


def test_ecd_quantization_noise():
    """ECD-PSGD's per-(iteration, worker) keys (ecd_psgd.py:56) and the
    uniform noise each draws (compression.py:22)."""
    iters, m_top, d = 40, 24, 28
    k_q = jax.random.split(jax.random.PRNGKey(0))[1]
    wkeys = jax.vmap(lambda t: jax.random.split(
        jax.random.fold_in(k_q, t), m_top))(jnp.arange(iters))
    noise = jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, (d,), jnp.float32)))(wkeys)
    tk_q = R.split(R.PRNGKey(0, device="cpu"))[1]
    twkeys = R.split(R.fold_in(tk_q, torch.arange(iters)), m_top)
    _same(wkeys, twkeys)
    _same(noise, R.uniform(twkeys, (d,)))


def test_seed_axis_keys():
    """The engine's seed axis: seed s draws with fold_in(key, s)
    (engine.py:265)."""
    jk, tk = jax.random.PRNGKey(0), R.PRNGKey(0, device="cpu")
    for s in range(1, 5):
        _same(jax.random.fold_in(jk, s), R.fold_in(tk, s))


def test_keys_are_values():
    """No global state: the same key always draws the same numbers."""
    k = R.PRNGKey(9, device="cpu")
    a, b = R.uniform(k, (16,)), R.uniform(k, (16,))
    assert torch.equal(a, b)
    assert not torch.equal(a, R.uniform(R.split(k)[0], (16,)))
