"""The port's normal, gamma and Student-t samplers and its six new dataset
generators against the reference, on the CPU.  Tolerance: none; every
draw, X and y are equal bit for bit (``log``, ``log1p`` and ``erf_inv``,
which the samplers evaluate as the reference's compiler does, too; a NaN
only has to be a NaN)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synth as JS
from repro_torch import random as R
from repro_torch.data import synth as TS


def _same(ref, got):
    ref = np.asarray(ref)
    if np.issubdtype(ref.dtype, np.integer):
        ref = ref.astype(np.int64)
    got = got.numpy()
    assert ref.shape == got.shape and ref.dtype == got.dtype
    if ref.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(ref), np.isnan(got))
        ref, got = (np.where(np.isnan(a), 0, a).view(np.int32)
                    for a in (ref, got))
    np.testing.assert_array_equal(ref, got)


def test_log_and_log1p_match_reference():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-6, 50, 20000),
                        rng.uniform(0, 1, 20000),
                        [0.0, -1.0, np.inf, np.nan, 1e-40, 3e38, 1.0]])
    x = x.astype(np.float32)
    _same(jax.jit(jnp.log)(x), R.log_f32(torch.tensor(x)))
    z = rng.uniform(-0.9999, 3.0, 40000).astype(np.float32)
    _same(jax.jit(jnp.log1p)(z), R.log1p_f32(torch.tensor(z)))


def test_erf_inv_matches_reference():
    rng = np.random.default_rng(1)
    u = np.concatenate([rng.uniform(-1, 1, 40000),
                        rng.uniform(0.996, 1.0, 4000),
                        [-1.0, 1.0, 0.0, -0.0]]).astype(np.float32)
    _same(jax.jit(jax.lax.erf_inv)(u), R.erf_inv_f32(torch.tensor(u)))


@pytest.mark.parametrize("seed,shape", [(0, (2000, 28)), (7, (33,)),
                                        (11, (4, 5, 6))])
def test_normal(seed, shape):
    _same(jax.random.normal(jax.random.PRNGKey(seed), shape),
          R.normal(R.PRNGKey(seed), shape))


@pytest.mark.parametrize("a,seed", [(1.5, 0), (1.5, 3), (1.0, 1), (4.0, 2),
                                    (2.25, 5)])
def test_gamma(a, seed):
    _same(jax.random.gamma(jax.random.PRNGKey(seed), a, (500, 28)),
          R.gamma(R.PRNGKey(seed), a, (500, 28)))


def test_gamma_below_one_is_refused():
    with pytest.raises(ValueError):
        R.gamma(R.PRNGKey(0), 0.5, (4,))


@pytest.mark.parametrize("df,seed", [(3.0, 0), (3.0, 9), (5.0, 1)])
def test_student_t(df, seed):
    """heavy_tailed's sampler (synth.py:242) at problem_generality's
    quick shape."""
    _same(jax.random.t(jax.random.PRNGKey(seed), df, (1000, 28)),
          R.t(R.PRNGKey(seed), df, (1000, 28)))


def test_batched_permutation_is_one_permutation_per_key():
    """ls_sequence's per-row choice(replace=False) draws a batch of
    permutations; each equals the reference's for its key."""
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    got = R.permutation(torch.tensor(np.asarray(keys).astype(np.int64)), 200)
    for i in range(6):
        _same(jax.random.permutation(keys[i], 200), got[i])


GENERATOR_CASES = [
    ("ls_sequence", {"n": 400, "d": 28, "mutate_frac": 0.1}),
    ("ls_sequence", {"n": 400, "d": 28, "mutate_frac": 0.9}),
    ("ls_sequence", {"n": 300, "d": 200, "mutate_frac": 0.1,
                     "density": 0.05, "lo": 0, "hi": 1}),
    ("ls_sequence", {"n": 300, "d": 200, "mutate_frac": 0.9,
                     "density": 0.05, "lo": 0, "hi": 1}),
    ("one_sample", {"n": 100, "d": 16}),
    ("label_noise", {"base": "higgs_like", "flip_frac": 0.2, "n": 500,
                     "d": 28}),
    ("label_noise", {"base": "realsim_like", "flip_frac": 0.3, "n": 300,
                     "d": 100, "density": 0.1}),
    ("character_knob", {"n": 512, "d": 48, "variance": 0.25,
                        "density": 0.5, "duplication": 0.75}),
    ("character_knob", {"n": 1536, "d": 48, "variance": 4.0,
                        "density": 1.0, "duplication": 0.0}),
    ("character_knob", {"n": 700, "d": 48, "variance": 1.0, "density": 0.1,
                        "duplication": 0.5}),
    ("heavy_tailed", {"n": 600, "d": 28, "df": 3.0}),
]


@pytest.mark.parametrize("name,kw", GENERATOR_CASES)
@pytest.mark.parametrize("seed", [0, 5])
def test_generator_matches_reference(name, kw, seed):
    ref = JS.get_generator(name)(jax.random.PRNGKey(seed), **kw)
    got = TS.get_generator(name)(R.PRNGKey(seed), **kw)
    _same(ref.X, got.X)
    _same(ref.y, got.y)
    assert got.name == ref.name


def test_ls_sequence_from_a_given_first_sample():
    first = np.linspace(-1, 1, 28).astype(np.float32)
    kw = {"n": 50, "d": 28, "mutate_frac": 0.25}
    ref = JS.make_ls_sequence(jax.random.PRNGKey(2), first_sample=first, **kw)
    got = TS.make_ls_sequence(R.PRNGKey(2), first_sample=first, **kw)
    _same(ref.X, got.X)


def test_diversity_variants_match_reference():
    kw = {"n": 803, "d": 30, "density": 0.1}
    base = JS.make_realsim_like(jax.random.PRNGKey(0), **kw)
    tbase = TS.make_realsim_like(R.PRNGKey(0), **kw)
    for ref, got in zip(JS.make_diversity_variants(base),
                        TS.make_diversity_variants(tbase)):
        assert got.name == ref.name
        _same(ref.X, got.X)
        _same(ref.y, got.y)


@pytest.mark.parametrize("kw", [{"duplication": 1.0}, {"duplication": -0.1},
                                {"density": 0.0}, {"density": 1.5}])
def test_character_knob_rejects_bad_knobs(kw):
    for gen, key in ((JS.make_character_knob, jax.random.PRNGKey(0)),
                     (TS.make_character_knob, R.PRNGKey(0))):
        with pytest.raises(ValueError):
            gen(key, n=16, d=4, **kw)


def test_registry_names_match_reference():
    assert sorted(TS.GENERATORS) == sorted(JS.GENERATORS)
