"""The port's serving engine against the reference's (tests/test_serve.py):
greedy tokens, the serve-step interface, the sliding-window ring buffer,
and the launcher on the CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import model as RM
from repro.serve import engine as RE
from repro_torch import interop
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as M
from repro_torch.models.attention import gqa_decode, init_gqa, init_kv_cache
from repro_torch.serve.engine import (greedy_generate, init_serve_state,
                                      make_prefill_step, make_serve_step)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


def _pair(arch):
    rcfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    rparams = RM.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rparams, interop.lm_params(
        cfg, jax.tree.map(np.asarray, rparams))


def test_greedy_generate_matches_reference():
    rcfg, cfg, rparams, params = _pair("gemma3-1b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6),
                                                dtype=np.int32)
    want = RE.greedy_generate(rparams, rcfg, jnp.asarray(prompts), steps=4)
    got = greedy_generate(params, cfg, torch.tensor(prompts), 4,
                          device="cpu")
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_step_is_last_position_of_forward():
    rcfg, cfg, rparams, params = _pair("qwen2.5-3b")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10),
                                               dtype=np.int32)
    want = RE.make_prefill_step(rcfg)(rparams, {"tokens": jnp.asarray(
        tokens)})
    for impl in ("kernel", "reference"):
        got = make_prefill_step(cfg, attention_impl=impl)(
            params, {"tokens": torch.tensor(tokens)})
        assert got.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_serve_step_interface():
    cfg = get_arch("gemma3-1b").reduced()
    params = M.init_params(cfg, device="cpu")
    serve = make_serve_step(cfg)
    state = init_serve_state(cfg, batch=2, max_len=64, dtype=torch.float32,
                             device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int64)
    for _ in range(4):
        tok_next, state = serve(params, state, tok)
        assert tok_next.shape == (2,)
        tok = tok_next[:, None]
    assert int(state["decode"]["position"]) == 4


def test_sliding_window_cache_is_ring_buffer():
    """After window+k tokens, the cache holds only the last `window` keys."""
    cfg = get_arch("gemma3-1b").reduced()
    window = 8
    gen = torch.Generator().manual_seed(0)
    p = init_gqa(gen, cfg, torch.float32, "cpu")
    cache = init_kv_cache(cfg, batch=1, max_len=64, dtype=torch.float32,
                          window=window)
    assert cache.k.shape[1] == window
    x = torch.randn((1, 1, cfg.d_model), generator=gen)
    for t in range(window + 3):
        _, cache = gqa_decode(p, cfg, x, cache, t)
    # oldest retained position is t - window + 1
    assert int(cache.pos[0].min()) == (window + 3) - window
    assert cache.index == window + 3


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "2", "--prompt-len", "8", "--gen", "8"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "arch=gemma3-1b generated 16 tokens" in proc.stdout
    assert "device=cpu" in proc.stdout
