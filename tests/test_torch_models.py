"""The port's LM against the reference's on reduced configs in float32,
with the reference's weights carried across by ``interop.lm_params``:
prefill logits with both attention implementations, decode logits at
every step, prefill/decode consistency inside the port, and the full
gemma3-1b parameter count."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_arch as ref_get_arch
from repro.models import model as RM
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as M

from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["gemma3-1b", "qwen2.5-3b", "phi3-mini-3.8b", "qwen1.5-110b"]
# gemma3's reduced window is 64: 72 tokens take its ring buffer round
SEQ = {"gemma3-1b": 72, "qwen2.5-3b": 12, "phi3-mini-3.8b": 12,
       "qwen1.5-110b": 12}
IMPLS = {"kernel": "pallas", "reference": "reference"}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    rcfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    rparams = RM.init_params(jax.random.PRNGKey(0), rcfg)
    params = interop.lm_params(cfg, jax.tree.map(np.asarray, rparams),
                               device="cpu")
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab_size, (2, SEQ[arch]), dtype=np.int32)
    return rcfg, cfg, rparams, params, tokens


@functools.lru_cache(maxsize=None)
def _ref_forward(arch, impl):
    rcfg, _, rparams, _, tokens = _setup(arch)
    fwd = jax.jit(lambda p, t: RM.forward(p, rcfg, {"tokens": t},
                                          attention_impl=impl)[0])
    return np.asarray(fwd(rparams, jnp.asarray(tokens)))


@functools.lru_cache(maxsize=None)
def _port_decode(arch):
    _, cfg, _, params, tokens = _setup(arch)
    state = M.init_decode_state(cfg, tokens.shape[0], 96, device="cpu")
    out = []
    for t in range(tokens.shape[1]):
        logits, state = M.decode_step(
            params, cfg, torch.tensor(tokens[:, t:t + 1]), state)
        out.append(logits[:, 0].numpy())
    return np.stack(out, axis=1), state


@pytest.mark.parametrize("impl", ["kernel", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, impl):
    _, cfg, _, params, tokens = _setup(arch)
    want = _ref_forward(arch, IMPLS[impl])
    got, aux = M.forward(params, cfg, {"tokens": torch.tensor(tokens)},
                         attention_impl=impl)
    assert got.dtype == torch.float32
    assert got.shape == (2, SEQ[arch], cfg.vocab_size)
    assert float(aux["load_balance_loss"]) == 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    rcfg, _, rparams, _, tokens = _setup(arch)
    step = jax.jit(lambda p, t, s: RM.decode_step(p, rcfg, t, s))
    state = RM.init_decode_state(rcfg, tokens.shape[0], 96)
    want = []
    for t in range(tokens.shape[1]):
        logits, state = step(rparams, jnp.asarray(tokens[:, t:t + 1]), state)
        want.append(np.asarray(logits[:, 0]))
    got, port_state = _port_decode(arch)
    np.testing.assert_allclose(got, np.stack(want, axis=1), atol=1e-4,
                               rtol=1e-4)
    assert port_state["position"] == tokens.shape[1]
    assert int(state["position"]) == tokens.shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """The reference's own bound (tests/test_archs.py): decode logits
    within 5e-4 of the prefill's at every position."""
    _, cfg, _, params, tokens = _setup(arch)
    full, _ = M.forward(params, cfg, {"tokens": torch.tensor(tokens)})
    dec, _ = _port_decode(arch)
    assert np.max(np.abs(dec - full.numpy())) < 5e-4


def test_gemma3_window_plan():
    cfg = get_arch("gemma3-1b")
    windows = [s.window for s in M.layer_plan(cfg)]
    assert windows.count(0) == 4 and windows.count(1024) == 22
    assert [i for i, w in enumerate(windows) if w == 0] == [5, 11, 17, 23]
    ref_plan = [(s.kind, s.window) for s in RM.layer_plan(
        ref_get_arch("gemma3-1b"))]
    assert [(s.kind, s.window) for s in M.layer_plan(cfg)] == ref_plan


def test_full_gemma3_param_count():
    """Built on the meta device (no memory): the same count as the
    reference's eval_shape, inside tests/test_archs.py's range."""
    cfg = get_arch("gemma3-1b")
    lm = M.init_params(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    shapes = jax.eval_shape(
        lambda: RM.init_params(jax.random.PRNGKey(0), ref_get_arch(
            "gemma3-1b")))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert n == want
    assert 0.7e9 <= n <= 1.4e9
    assert all(p.dtype == torch.bfloat16 for p in lm.parameters())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds(arch):
    """Every arch of the registry builds at its reduced config, with the
    reference's parameter count."""
    cfg = get_arch(arch).reduced()
    lm = M.init_params(cfg, device="cpu")
    shapes = jax.eval_shape(lambda: RM.init_params(
        jax.random.PRNGKey(0), ref_get_arch(arch).reduced()))
    assert sum(p.numel() for p in lm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_layers_match_reference():
    """LayerNorm, both MLP kinds and RoPE against the reference's layers
    (float32, within 1e-5)."""
    from repro.models import layers as RL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 3, 32), dtype=np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32) * 37, (2, 1))
    np.testing.assert_allclose(
        L.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4).numpy(),
        np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        atol=1e-5, rtol=1e-5)
    h = rng.standard_normal((2, 5, 16), dtype=np.float32)
    ln = {"scale": rng.standard_normal(16, dtype=np.float32),
          "bias": rng.standard_normal(16, dtype=np.float32)}
    np.testing.assert_allclose(
        L.apply_layernorm({k: torch.tensor(v) for k, v in ln.items()},
                          torch.tensor(h)).numpy(),
        np.asarray(RL.apply_layernorm(ln, jnp.asarray(h))), atol=1e-5,
        rtol=1e-5)
    for kind, names in (("swiglu", ("wi_gate", "wi_up", "wo")),
                        ("gelu", ("wi", "bi", "wo", "bo"))):
        shapes = {"wi_gate": (16, 24), "wi_up": (16, 24), "wi": (16, 24),
                  "bi": (24,), "wo": (24, 16), "bo": (16,)}
        p = {n: 0.3 * rng.standard_normal(shapes[n], dtype=np.float32)
             for n in names}
        np.testing.assert_allclose(
            L.apply_mlp({k: torch.tensor(v) for k, v in p.items()},
                        torch.tensor(h), kind).numpy(),
            np.asarray(RL.apply_mlp(p, jnp.asarray(h), kind)), atol=1e-5,
            rtol=1e-5)
