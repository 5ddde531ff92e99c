"""The port's Multi-head Latent Attention and deepseek-v2-236b against the
reference's, on the reduced config in float32 (two layers: the dense
first layer and one MoE layer with a shared expert; MLA with latent 64,
q rank 96, nope 64 + rope 32, v 64), the reference's weights carried
across by ``interop.lm_params``: ``mla_forward`` and the absorbed
``mla_decode`` step by step within 1e-5, full-model logits with both
attention implementations and decode logits within 1e-4, prefill against
decode within the reference's 5e-4 (``tests/test_archs.py``, at capacity
factor 8 so that the prefill drops no assignment), greedy tokens, loss and
gradients (the loss within 1e-6 relative, each gradient leaf within 1e-5
of its largest magnitude), the pytree round trip, the full config's
parameter count and the serve launcher."""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import attention as RA
from repro.models import model as RM
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.serve.engine import greedy_generate

from _torch_train_parity import check_loss_and_grads

ARCH = "deepseek-v2-236b"
IMPLS = {"kernel": "pallas", "reference": "reference"}
SEQ = 40
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def _cfg(get, capacity=None):
    cfg = get(ARCH).reduced()
    if capacity:        # no capacity drops: prefill and decode route alike
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


@functools.lru_cache(maxsize=None)
def _setup(capacity=None):
    rcfg, cfg = _cfg(ref_get_arch, capacity), _cfg(get_arch, capacity)
    rparams = jax.tree.map(np.asarray, jax.jit(
        lambda key: RM.init_params(key, rcfg))(jax.random.PRNGKey(0)))
    params = interop.lm_params(cfg, rparams)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, SEQ), dtype=np.int32)
    return rcfg, cfg, rparams, params, tokens


def _mla_layer():
    """The reference's first-layer MLA weights (numpy and torch) and a
    hidden state (2, SEQ, d) drawn with numpy."""
    rcfg, cfg, rparams, _, _ = _setup()
    p = {k: v[0] for k, v in rparams["segments"][0]["attn"].items()}
    assert sorted(p) == ["wk_b", "wk_rope", "wkv_a", "wo", "wq_a", "wq_b",
                         "wv_b"]
    x = np.random.default_rng(9).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, p, {k: torch.tensor(v) for k, v in p.items()}, x


def test_mla_forward_matches_reference():
    rcfg, cfg, rp, p, x = _mla_layer()
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (2, 1))
    want = jax.jit(lambda a, b: RA.mla_forward(rp, rcfg, a, b))(
        jnp.asarray(x), jnp.asarray(pos))
    got = A.mla_forward(p, cfg, torch.tensor(x), torch.tensor(pos))
    assert got.shape == (2, SEQ, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_mla_decode_matches_reference():
    """Step by step from empty caches: each output and the compressed
    caches within 1e-5; the port writes its cache in place."""
    rcfg, cfg, rp, p, x = _mla_layer()
    rcache = RA.init_mla_cache(rcfg, 2, SEQ + 4, jnp.float32)
    cache = A.init_mla_cache(cfg, 2, SEQ + 4, torch.float32)
    assert cache.c_kv.shape == (2, SEQ + 4, cfg.mla.kv_lora_rank)
    assert cache.k_rope.shape == (2, SEQ + 4, cfg.mla.qk_rope_head_dim)
    step = jax.jit(lambda c, xt, t: RA.mla_decode(rp, rcfg, xt, c, t))
    for t in range(SEQ):
        want, rcache = step(rcache, jnp.asarray(x[:, t:t + 1]),
                            jnp.int32(t))
        got, same = A.mla_decode(p, cfg, torch.tensor(x[:, t:t + 1]), cache,
                                 t)
        assert same is cache and cache.index == t + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {t}")
    np.testing.assert_allclose(cache.c_kv.numpy(), np.asarray(rcache.c_kv),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cache.k_rope.numpy(),
                               np.asarray(rcache.k_rope), atol=1e-5,
                               rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _ref_forward(impl):
    rcfg, _, rparams, _, tokens = _setup()
    fwd = jax.jit(lambda p, t: RM.forward(p, rcfg, {"tokens": t},
                                          attention_impl=impl))
    logits, aux = fwd(rparams, jnp.asarray(tokens))
    return np.asarray(logits), float(aux["load_balance_loss"])


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_forward_matches_reference(impl):
    _, cfg, _, params, tokens = _setup()
    want, want_lb = _ref_forward(IMPLS[impl])
    got, aux = M.forward(params, cfg, {"tokens": torch.tensor(tokens)},
                         attention_impl=impl)
    assert got.shape == (2, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert want_lb > 0
    np.testing.assert_allclose(float(aux["load_balance_loss"]), want_lb,
                               atol=1e-5, rtol=1e-5)


def _port_decode(capacity=None):
    _, cfg, _, params, tokens = _setup(capacity)
    state = M.init_decode_state(cfg, tokens.shape[0], 64, device="cpu")
    out = []
    for t in range(tokens.shape[1]):
        logits, state = M.decode_step(
            params, cfg, torch.tensor(tokens[:, t:t + 1]), state)
        out.append(logits[:, 0].numpy())
    return np.stack(out, axis=1), state


@functools.lru_cache(maxsize=None)
def _ref_step():
    rcfg = _setup()[0]
    return jax.jit(lambda p, t, s: RM.decode_step(p, rcfg, t, s))


def test_decode_matches_reference():
    rcfg, _, rparams, _, tokens = _setup()
    step = _ref_step()
    state = RM.init_decode_state(rcfg, tokens.shape[0], 64)
    want = []
    for t in range(tokens.shape[1]):
        logits, state = step(rparams, jnp.asarray(tokens[:, t:t + 1]), state)
        want.append(np.asarray(logits[:, 0]))
    got, port_state = _port_decode()
    np.testing.assert_allclose(got, np.stack(want, axis=1), atol=1e-4,
                               rtol=1e-4)
    assert port_state["position"] == tokens.shape[1]
    assert [type(c) for c in port_state["caches"]] == [A.MLACache] * 2
    assert [c.index for c in port_state["caches"]] == [SEQ] * 2


def test_prefill_decode_consistency():
    _, cfg, _, params, tokens = _setup(8.0)
    full, _ = M.forward(params, cfg, {"tokens": torch.tensor(tokens)})
    dec, _ = _port_decode(8.0)
    assert np.max(np.abs(dec - full.numpy())) < 5e-4


def test_greedy_generate_matches_reference():
    """The reference's ``serve.engine.greedy_generate`` loop over its
    jitted ``decode_step`` (the loop itself runs each step unjitted, a
    second apiece here)."""
    rcfg, cfg, rparams, params, tokens = _setup()
    prompts = tokens[:, :6]
    step = _ref_step()
    state = RM.init_decode_state(rcfg, 2, prompts.shape[1] + 5 + 8)
    for t in range(prompts.shape[1]):
        logits, state = step(rparams, jnp.asarray(prompts[:, t:t + 1]),
                             state)
    want = []
    for _ in range(5):
        tok = jnp.argmax(logits[:, -1:, :], axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, state = step(rparams, tok, state)
    want = np.concatenate(want, axis=1)
    got = greedy_generate(params, cfg, torch.tensor(prompts), 5,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_loss_and_grads_match_reference():
    rcfg, cfg, rparams, _, tokens = _setup()
    rng = np.random.default_rng(6)
    check_loss_and_grads(rcfg, cfg, rparams, {
        "tokens": tokens,
        "labels": rng.integers(-1, cfg.vocab_size, tokens.shape,
                               dtype=np.int32)})


def test_lm_tree_inverts_lm_params():
    _, cfg, rparams, params, _ = _setup()
    tree = interop.lm_tree(params)
    want = jax.tree_util.tree_flatten_with_path(rparams)[0]
    got = T.flatten_with_path(tree)
    assert len(got) == len(want)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    again = interop.lm_tree(interop.lm_params(cfg, tree))
    for (_, g), (_, w) in zip(T.flatten_with_path(again), got):
        assert torch.equal(g, w)


def test_full_param_count_and_plan_match_reference():
    """The full config on the meta device: the reference's eval_shape
    leaves, shapes and count (about 236 B, inside tests/test_archs.py's
    range), and its layer plan: a dense MLA layer, then 59 MoE ones."""
    cfg, rcfg = get_arch(ARCH), ref_get_arch(ARCH)
    lm = M.init_params(cfg, device="meta")
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = T.flatten_with_path(interop.lm_tree(lm))
    assert [tuple(g.shape) for _, g in got] == [w.shape for _, w in want]
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(np.prod(w.shape)) for _, w in want)
    assert 200e9 <= n <= 260e9
    plan = [(s.kind, s.moe) for s in M.layer_plan(cfg)]
    assert plan == [(s.kind, s.moe) for s in RM.layer_plan(rcfg)]
    assert plan == [("mla", False)] + [("mla", True)] * 59


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--requests", "2", "--prompt-len", "8",
         "--gen", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert f"arch={ARCH} generated 8 tokens" in proc.stdout
    assert "device=cpu" in proc.stdout
