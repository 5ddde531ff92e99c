"""The port's SSM blocks (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) in float32 at the reduced configs:
Mamba2 from zamba2-1.2b, mLSTM and sLSTM from xlstm-350m, the reference's
weights carried across, inputs from numpy seeds.  Forward outputs and
final states with T off the chunk (T = 40, chunk 32), on it and below
it; decode steps with their states token by token; the gated norm, the
causal conv and the SSD core.  Tolerance: atol/rtol 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import ssm as RS
from repro_torch.configs.registry import get_arch
from repro_torch.models import ssm as S

from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = {"mamba2": "zamba2-1.2b", "mlstm": "xlstm-350m",
        "slstm": "xlstm-350m"}
REF = {"mamba2": (RS.init_mamba2, RS.mamba2_forward, RS.init_mamba2_state,
                  RS.mamba2_step),
       "mlstm": (RS.init_mlstm, RS.mlstm_forward, RS.init_mlstm_state,
                 RS.mlstm_step),
       "slstm": (RS.init_slstm, RS.slstm_forward, RS.init_slstm_state,
                 RS.slstm_step)}
PORT = {"mamba2": (S.mamba2_forward, S.init_mamba2_state, S.mamba2_step),
        "mlstm": (S.mlstm_forward, S.init_mlstm_state, S.mlstm_step),
        "slstm": (S.slstm_forward, S.init_slstm_state, S.slstm_step)}


def _setup(kind, seed=0):
    """(reference cfg, port cfg, reference params, port params); the
    reference's gates get non-trivial values so that decay, skip and gate
    biases all matter."""
    rcfg = ref_get_arch(ARCH[kind]).reduced()
    cfg = get_arch(ARCH[kind]).reduced()
    rp = REF[kind][0](jax.random.PRNGKey(seed), rcfg, jnp.float32)
    rng = np.random.default_rng(seed + 100)
    rp = {k: np.asarray(v) for k, v in rp.items()}
    for name in ("a_log", "dt_bias", "conv_b", "norm_scale"):
        if name in rp:
            rp[name] = (rp[name] + 0.3 * rng.standard_normal(
                rp[name].shape)).astype(np.float32)
    p = {k: torch.tensor(v) for k, v in rp.items()}
    return rcfg, cfg, rp, p


def _x(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)


def _state_arrays(state):
    if isinstance(state, tuple):
        return [np.asarray(a) for a in state]
    return [np.asarray(getattr(state, f.name)) for f in
            dataclasses.fields(state)]


@pytest.mark.parametrize("T", [40, 32, 7])
@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_forward_matches_reference(kind, T):
    rcfg, cfg, rp, p = _setup(kind)
    x = _x(cfg, 2, T, seed=T)
    want, want_state = REF[kind][1](rp, rcfg, jnp.asarray(x),
                                    return_state=True)
    got, got_state = PORT[kind][0](p, cfg, torch.tensor(x),
                                   return_state=True)
    assert got.shape == (2, T, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_state = want_state if isinstance(want_state, tuple) else (
        want_state,)
    got_state = got_state if isinstance(got_state, tuple) else (got_state,)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_step_matches_reference(kind):
    """Eight decode steps from the initial state: every output and every
    state field."""
    rcfg, cfg, rp, p = _setup(kind, seed=1)
    x = _x(cfg, 2, 8, seed=5)
    rstate = REF[kind][2](rcfg, 2, jnp.float32)
    state = PORT[kind][1](cfg, 2, torch.float32, device="cpu")
    for t in range(x.shape[1]):
        want, rstate = REF[kind][3](rp, rcfg, jnp.asarray(x[:, t:t + 1]),
                                    rstate)
        got, state = PORT[kind][2](p, cfg, torch.tensor(x[:, t:t + 1]),
                                   state)
        assert got.shape == (2, 1, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for g, w in zip(_state_arrays(state), _state_arrays(rstate)):
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_steps_reach_the_forward_state(kind):
    """Inside the port: T steps from the initial state end in the state
    the forward pass returns (the mLSTM's T a multiple of its chunk, the
    sLSTM's any)."""
    _, cfg, _, p = _setup(kind, seed=2)
    x = torch.tensor(_x(cfg, 2, 64, seed=9))
    out, final = PORT[kind][0](p, cfg, x, return_state=True)
    state = PORT[kind][1](cfg, 2, torch.float32, device="cpu")
    steps = []
    for t in range(x.shape[1]):
        y, state = PORT[kind][2](p, cfg, x[:, t:t + 1], state)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), out.numpy(),
                               **TOL)
    for g, w in zip(_state_arrays(state), final):
        np.testing.assert_allclose(g, w.numpy(), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_gated_rmsnorm_matches_reference(use_kernel):
    """On a CPU tensor both routes are K5's plain version."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 48), dtype=np.float32)
    z = rng.standard_normal((3, 5, 48), dtype=np.float32)
    scale = rng.standard_normal(48, dtype=np.float32)
    want = RS._gated_rmsnorm(jnp.asarray(x), jnp.asarray(z),
                             jnp.asarray(scale))
    got = S._gated_rmsnorm(torch.tensor(x), torch.tensor(z),
                           torch.tensor(scale), use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_causal_conv_and_ssd_core_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    b = rng.standard_normal(24, dtype=np.float32)
    np.testing.assert_allclose(
        S._causal_conv(torch.tensor(x), torch.tensor(w),
                       torch.tensor(b)).numpy(),
        np.asarray(RS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))), atol=1e-5, rtol=1e-5)
    B, T, H, hd, N, chunk = 2, 48, 3, 8, 5, 16
    xh = rng.standard_normal((B, T, H, hd), dtype=np.float32)
    dt = rng.standard_normal((B, T, H), dtype=np.float32)
    Bm = rng.standard_normal((B, T, N), dtype=np.float32)
    Cm = rng.standard_normal((B, T, N), dtype=np.float32)
    a_log = 0.5 * rng.standard_normal(H, dtype=np.float32)
    want_y, want_s = RS._ssd_chunked(*(jnp.asarray(a) for a in (
        xh, dt, Bm, Cm, a_log)), chunk)
    got_y, got_s = S._ssd_chunked(*(torch.tensor(a) for a in (
        xh, dt, Bm, Cm, a_log)), chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_init_shapes_match_reference(kind):
    """The port's init gives the reference's names, shapes and types, and
    the constant leaves (gate biases, skips, norm gains) equal."""
    rcfg = ref_get_arch(ARCH[kind])
    cfg = get_arch(ARCH[kind])
    shapes = jax.eval_shape(lambda: REF[kind][0](jax.random.PRNGKey(0),
                                                 rcfg, jnp.bfloat16))
    init = {"mamba2": S.init_mamba2, "mlstm": S.init_mlstm,
            "slstm": S.init_slstm}[kind]
    p = init(None, cfg, torch.bfloat16, "meta")
    assert sorted(p) == sorted(shapes)
    for k, v in p.items():
        assert tuple(v.shape) == shapes[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(shapes[k].dtype), k
    small = init(torch.Generator().manual_seed(0), cfg.reduced(),
                 torch.float32, "cpu")
    ref = REF[kind][0](jax.random.PRNGKey(0), rcfg.reduced(), jnp.float32)
    for k in ("b_i", "b_f", "b", "a_log", "dt_bias", "d_skip", "norm_scale",
              "conv_b"):
        if k in ref:
            np.testing.assert_array_equal(small[k].numpy(),
                                          np.asarray(ref[k]))
