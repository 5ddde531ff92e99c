"""The port's recurrent, hybrid and MoE LMs against the reference's on the
reduced configs in float32 (xlstm-350m: an mLSTM and an sLSTM layer;
zamba2-1.2b: a Mamba2 layer and a shared-attention layer; arctic-480b: two
MoE attention layers with a dense residual), the reference's weights
carried across by ``interop.lm_params``: full-model logits with both
attention implementations and the load-balance loss, decode logits at
every step, prefill against decode within the reference's 5e-4
(``tests/test_archs.py``), greedy tokens, the decode state's size, the
full configs' parameter counts, the pytree round trip and the serve
launcher."""

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
from repro.models import model as RM
from repro.serve import engine as RE
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as M
from repro_torch.serve.engine import greedy_generate, make_prefill_step

from _torch_threads import capped_env, one_torch_thread  # noqa: F401

ARCHS = ["xlstm-350m", "zamba2-1.2b", "arctic-480b"]
IMPLS = {"kernel": "pallas", "reference": "reference"}
SEQ = 40                # off the reduced SSM chunk of 32
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def _cfg(get, arch, capacity=None):
    cfg = get(arch).reduced()
    if capacity:        # no capacity drops: prefill and decode route alike
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


@functools.lru_cache(maxsize=None)
def _setup(arch, capacity=None):
    rcfg = _cfg(ref_get_arch, arch, capacity)
    cfg = _cfg(get_arch, arch, capacity)
    rparams = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0),
                                                      rcfg))
    params = interop.lm_params(cfg, rparams, device="cpu")
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab_size, (2, SEQ), dtype=np.int32)
    return rcfg, cfg, rparams, params, tokens


@functools.lru_cache(maxsize=None)
def _ref_forward(arch, impl):
    rcfg, _, rparams, _, tokens = _setup(arch)
    fwd = jax.jit(lambda p, t: RM.forward(p, rcfg, {"tokens": t},
                                          attention_impl=impl))
    logits, aux = fwd(rparams, jnp.asarray(tokens))
    return np.asarray(logits), float(aux["load_balance_loss"])


@functools.lru_cache(maxsize=None)
def _port_decode(arch, capacity=None):
    """The port's decode logits at every position and its final state,
    computed once per (arch, capacity) for the module's tests."""
    _, cfg, _, params, tokens = _setup(arch, capacity)
    state = M.init_decode_state(cfg, tokens.shape[0], 64, device="cpu")
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
    want, want_lb = _ref_forward(arch, IMPLS[impl])
    got, aux = M.forward(params, cfg, {"tokens": torch.tensor(tokens)},
                         attention_impl=impl)
    assert got.shape == (2, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux["load_balance_loss"]), want_lb,
                               atol=1e-5, rtol=1e-5)
    assert (want_lb > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    rcfg, _, rparams, _, tokens = _setup(arch)
    step = jax.jit(lambda p, t, s: RM.decode_step(p, rcfg, t, s))
    state = RM.init_decode_state(rcfg, tokens.shape[0], 64)
    want = []
    for t in range(tokens.shape[1]):
        logits, state = step(rparams, jnp.asarray(tokens[:, t:t + 1]), state)
        want.append(np.asarray(logits[:, 0]))
    got, port_state = _port_decode(arch)
    np.testing.assert_allclose(got, np.stack(want, axis=1), atol=1e-4,
                               rtol=1e-4)
    assert port_state["position"] == tokens.shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """The reference's own bound: decode logits within 5e-4 of the
    prefill's at every position (arctic at capacity factor 8, as the
    reference's test, so that the prefill drops no assignment)."""
    _, cfg, _, params, tokens = _setup(arch, 8.0 if "arctic" in arch
                                       else None)
    full, _ = M.forward(params, cfg, {"tokens": torch.tensor(tokens)})
    dec, _ = _port_decode(arch, 8.0 if "arctic" in arch else None)
    assert np.max(np.abs(dec - full.numpy())) < 5e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    rcfg, cfg, rparams, params, tokens = _setup(arch)
    prompts = tokens[:, :6]
    want = RE.greedy_generate(rparams, rcfg, jnp.asarray(prompts), steps=5)
    got = greedy_generate(params, cfg, torch.tensor(prompts), 5,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the prefill step is the forward's last position
    last = make_prefill_step(cfg)(params, {"tokens": torch.tensor(tokens)})
    full, _ = M.forward(params, cfg, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), atol=1e-5,
                               rtol=1e-5)


def _state_size(state):
    leaves = []
    for cache in state["caches"]:
        leaves += [getattr(cache, f.name) for f in dataclasses.fields(cache)]
    return sum(x.numel() for x in leaves if isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-1.2b"])
def test_ssm_decode_state_constant_size(arch):
    """The reference's tests/test_serve.py check: an SSM layer's decode
    state does not grow with max_len (zamba2's shared-attention layer
    keeps a KV cache that does)."""
    cfg = get_arch(arch).reduced()
    s1 = M.init_decode_state(cfg, 2, 64, device="cpu")
    s2 = M.init_decode_state(cfg, 2, 4096, device="cpu")
    kinds = [spec.kind for spec in M.layer_plan(cfg)]
    ssm = [i for i, k in enumerate(kinds) if k != "shared_attn"]
    assert ssm and _state_size({"caches": [s1["caches"][i] for i in ssm]}) \
        == _state_size({"caches": [s2["caches"][i] for i in ssm]})
    if arch == "xlstm-350m":
        rcfg = ref_get_arch(arch).reduced()
        want = sum(x.size for x in jax.tree.leaves(
            RM.init_decode_state(rcfg, 2, 64)["caches"]))
        assert _state_size(s1) == _state_size(s2) == want
    else:
        assert _state_size(s2) > _state_size(s1)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_counts_and_plan_match_reference(arch):
    """Full configs on the meta device: the reference's eval_shape count,
    leaf names and shapes, and its layer plan."""
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    lm = M.init_params(cfg, device="meta")
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = T.flatten_with_path(interop.lm_tree(lm))
    assert [tuple(g.shape) for _, g in got] == [w.shape for _, w in want]
    assert sum(p.numel() for p in lm.parameters()) == sum(
        int(np.prod(w.shape)) for _, w in want)
    assert [(s.kind, s.moe, s.window) for s in M.layer_plan(cfg)] == [
        (s.kind, s.moe, s.window) for s in RM.layer_plan(rcfg)]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_tree_inverts_lm_params(arch):
    _, cfg, rparams, params, _ = _setup(arch)
    tree = interop.lm_tree(params)
    want = jax.tree_util.tree_flatten_with_path(rparams)[0]
    got = T.flatten_with_path(tree)
    assert len(got) == len(want)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    again = interop.lm_tree(interop.lm_params(cfg, tree, device="cpu"))
    for (_, g), (_, w) in zip(T.flatten_with_path(again), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_cpu(arch):
    env = capped_env(PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--requests", "2", "--prompt-len", "8",
         "--gen", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert f"arch={arch} generated 8 tokens" in proc.stdout
    assert "device=cpu" in proc.stdout
