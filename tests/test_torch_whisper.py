"""The port's whisper-small against the reference's, on the reduced config
in float32 (two encoder layers over 64 frames, two decoder layers with
cross-attention, learned positions over a 512-row table, LayerNorm and
GELU), the reference's weights carried across by ``interop.lm_params``:
``cross_attn_forward`` and ``encode`` within 1e-5; full-model logits with
both attention implementations and decode logits with the encoder output
within 1e-4; prefill against decode within the reference's 5e-4
(``tests/test_archs.py``); greedy tokens; the learned positions clipped
past the table in a prefill and in a decode step; loss and gradients (the
loss within 1e-6 relative, each gradient leaf within 1e-5 of its largest
magnitude); two steps of ``train_loop``; the pytree round trip; the
serve step carrying ``enc_out``; the full config's parameter count and
the serve launcher."""

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
from repro.serve import engine as RE
from repro.train import checkpoint as RC
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.serve import engine as E

from _torch_train_parity import check_loss_and_grads, check_train_loop
from _torch_threads import capped_env, one_torch_thread  # noqa: F401

ARCH = "whisper-small"
IMPLS = {"kernel": "pallas", "reference": "reference"}
SEQ = 40
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@functools.lru_cache(maxsize=None)
def _setup():
    rcfg, cfg = ref_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    rparams = jax.tree.map(np.asarray, jax.jit(
        lambda key: RM.init_params(key, rcfg))(jax.random.PRNGKey(0)))
    params = interop.lm_params(cfg, rparams, device="cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, SEQ), dtype=np.int32)
    frames = (0.1 * rng.standard_normal(
        (2, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return rcfg, cfg, rparams, params, tokens, frames


@functools.lru_cache(maxsize=None)
def _ref_encode():
    rcfg, _, rparams, _, _, frames = _setup()
    return np.asarray(jax.jit(lambda p, f: RM.encode(p, rcfg, f))(
        rparams["encoder"], jnp.asarray(frames)))


def _port_encode():
    _, cfg, _, params, _, frames = _setup()
    return M.encode(params.encoder, cfg, torch.tensor(frames))


def test_cross_attn_and_encode_match_reference():
    rcfg, cfg, rparams, params, _, frames = _setup()
    enc = _port_encode()
    assert enc.shape == (2, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(enc.numpy(), _ref_encode(), atol=1e-5,
                               rtol=1e-5)
    rp = {k: v[1] for k, v in rparams["segments"][0]["cross"].items()}
    assert sorted(rp) == ["wk", "wo", "wq", "wv"]
    x = np.random.default_rng(9).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda a, e: RA.cross_attn_forward(rp, rcfg, a, e))(
        jnp.asarray(x), jnp.asarray(frames))
    got = A.cross_attn_forward(params.blocks[1].cross, cfg, torch.tensor(x),
                               torch.tensor(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _batch(tokens, frames, to):
    return {"tokens": to(tokens), "frames": to(frames)}


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_forward_matches_reference(impl):
    rcfg, cfg, rparams, params, tokens, frames = _setup()
    want, _ = jax.jit(lambda p, b: RM.forward(
        p, rcfg, b, attention_impl=IMPLS[impl]))(
            rparams, _batch(tokens, frames, jnp.asarray))
    got, aux = M.forward(params, cfg, _batch(tokens, frames, torch.tensor),
                         attention_impl=impl)
    assert got.shape == (2, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert float(aux["load_balance_loss"]) == 0.0


@functools.lru_cache(maxsize=None)
def _ref_step():
    rcfg = _setup()[0]
    return jax.jit(lambda p, t, s, e: RM.decode_step(p, rcfg, t, s,
                                                     enc_out=e))


def _port_decode(enc, max_len=64):
    _, cfg, _, params, tokens, _ = _setup()
    state = M.init_decode_state(cfg, tokens.shape[0], max_len, device="cpu")
    out = []
    for t in range(tokens.shape[1]):
        logits, state = M.decode_step(
            params, cfg, torch.tensor(tokens[:, t:t + 1]), state,
            enc_out=enc)
        out.append(logits[:, 0].numpy())
    return np.stack(out, axis=1), state


def test_decode_matches_reference():
    rcfg, _, rparams, _, tokens, _ = _setup()
    step, enc = _ref_step(), jnp.asarray(_ref_encode())
    state = RM.init_decode_state(rcfg, tokens.shape[0], 64)
    want = []
    for t in range(tokens.shape[1]):
        logits, state = step(rparams, jnp.asarray(tokens[:, t:t + 1]), state,
                             enc)
        want.append(np.asarray(logits[:, 0]))
    got, port_state = _port_decode(_port_encode())
    np.testing.assert_allclose(got, np.stack(want, axis=1), atol=1e-4,
                               rtol=1e-4)
    assert port_state["position"] == tokens.shape[1]


def test_prefill_decode_consistency():
    _, cfg, _, params, tokens, frames = _setup()
    full, _ = M.forward(params, cfg, _batch(tokens, frames, torch.tensor))
    dec, _ = _port_decode(_port_encode())
    assert np.max(np.abs(dec - full.numpy())) < 5e-4


def test_greedy_generate_matches_reference():
    """The reference's greedy loop over its jitted ``decode_step`` with the
    encoder output, against the port's ``greedy_generate``."""
    rcfg, cfg, rparams, params, tokens, _ = _setup()
    prompts = tokens[:, :6]
    step, enc = _ref_step(), jnp.asarray(_ref_encode())
    state = RM.init_decode_state(rcfg, 2, prompts.shape[1] + 5 + 8)
    for t in range(prompts.shape[1]):
        logits, state = step(rparams, jnp.asarray(prompts[:, t:t + 1]),
                             state, enc)
    want = []
    for _ in range(5):
        tok = jnp.argmax(logits[:, -1:, :], axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, state = step(rparams, tok, state, enc)
    got = E.greedy_generate(params, cfg, torch.tensor(prompts), 5,
                            device="cpu", enc_out=_port_encode())
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_learned_positions_clamp_past_the_table():
    """A 520-token prefill over the 512-row table (the reference clips the
    ids) and one decode step at position 515 (the reference's slice is
    clamped to the last row), against the reference."""
    rcfg, cfg, rparams, params, _, frames = _setup()
    assert cfg.max_seq_len == 512 == params.pos_embed["pos"].shape[0]
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 520),
                                               dtype=np.int32)
    want, _ = jax.jit(lambda p, b: RM.forward(p, rcfg, b))(
        rparams, _batch(tokens, frames, jnp.asarray))
    got, _ = M.forward(params, cfg, _batch(tokens, frames, torch.tensor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)

    rstate = RM.init_decode_state(rcfg, 2, 520)
    rstate = {"position": jnp.int32(515), "caches": [
        dataclasses.replace(c, index=jnp.full_like(c.index, 515))
        for c in rstate["caches"]]}
    state = M.init_decode_state(cfg, 2, 520, device="cpu")
    state["position"] = 515
    for c in state["caches"]:
        c.index = 515
    tok = tokens[:, :1]
    want, _ = _ref_step()(rparams, jnp.asarray(tok), rstate,
                          jnp.asarray(_ref_encode()))
    got, state = M.decode_step(params, cfg, torch.tensor(tok), state,
                               enc_out=_port_encode())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert state["position"] == 516


def test_loss_and_grads_match_reference():
    rcfg, cfg, rparams, _, tokens, frames = _setup()
    rng = np.random.default_rng(6)
    grads, _ = check_loss_and_grads(rcfg, cfg, rparams, {
        "tokens": tokens, "frames": frames,
        "labels": rng.integers(-1, cfg.vocab_size, tokens.shape,
                               dtype=np.int32)})
    # the encoder learns through cross-attention
    assert float(grads["encoder"]["layers"]["attn"]["wq"].abs().max()) > 0


def test_train_loop_matches_reference():
    """Two sync steps of ``launch.train.train_loop``, whose batches carry
    zero frames as the reference's do, against the reference's loop."""
    check_train_loop(ARCH, steps=2, batch_size=2, seq_len=16, lr=2e-3,
                     strategy="sync")


def test_lm_tree_inverts_lm_params():
    _, cfg, rparams, params, _, _ = _setup()
    tree = interop.lm_tree(params)
    want = jax.tree_util.tree_flatten_with_path(rparams)[0]
    got = T.flatten_with_path(tree)
    assert [p for p, _ in got] == [RC._leaf_key(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    again = interop.lm_tree(interop.lm_params(cfg, tree, device="cpu"))
    for (_, g), (_, w) in zip(T.flatten_with_path(again), got):
        assert torch.equal(g, w)


def test_serve_state_carries_enc_out():
    """``init_serve_state`` holds a zero ``enc_out``; ``make_serve_step``
    carries it and matches the reference's serve step token for token; a
    slot driver masks a state that holds it."""
    rcfg, cfg, rparams, params, tokens, _ = _setup()
    state = E.init_serve_state(cfg, 2, 16, device="cpu")
    assert state["enc_out"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert not bool(state["enc_out"].any())
    gemma = get_arch("gemma3-1b").reduced()
    assert "enc_out" not in E.init_serve_state(gemma, 2, 16, device="cpu")
    assert E.init_serve_state(gemma, 2, 16, device="cpu",
                              with_encoder=True)["enc_out"].shape == (
        2, 0, gemma.d_model)
    state["enc_out"] = _port_encode()
    rstate = RE.init_serve_state(rcfg, 2, 16)
    rstate["enc_out"] = jnp.asarray(_ref_encode())
    serve, rserve = E.make_serve_step(cfg), jax.jit(RE.make_serve_step(rcfg))
    tok = tokens[:, :1]
    for _ in range(6):
        want, rstate = rserve(rparams, rstate, jnp.asarray(tok))
        got, state = serve(params, state, torch.tensor(tok))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tok = got[:, None].numpy().astype(np.int32)
    assert state["decode"]["position"] == 6
    assert torch.equal(state["enc_out"], _port_encode())

    slots = {"enc_out": torch.zeros(3, 4, 2), "tok": torch.zeros(3)}

    def step(s, active):
        return ({"enc_out": s["enc_out"] + 1, "tok": s["tok"] + 1},
                s["tok"] >= 1)

    driver = E.SlotDriver(step, slots, 3)
    assert driver.admit("a", {"enc_out": torch.ones(4, 2)}) == 0
    driver.step()
    done = driver.step()
    assert [r for r, _ in done] == ["a"]
    assert torch.equal(done[0][1]["enc_out"], torch.full((4, 2), 3.0))
    assert not bool(driver.state["enc_out"][1:].any())


def test_full_param_count_and_plan_match_reference():
    """The full config on the meta device: the reference's eval_shape
    leaf paths, shapes and count (0.28 B)."""
    cfg, rcfg = get_arch(ARCH), ref_get_arch(ARCH)
    lm = M.init_params(cfg, device="meta")
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = T.flatten_with_path(interop.lm_tree(lm))
    assert [tuple(g.shape) for _, g in got] == [w.shape for _, w in want]
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(np.prod(w.shape)) for _, w in want) == 282330624
    plan = [(s.kind, s.cross) for s in M.layer_plan(cfg)]
    assert plan == [(s.kind, s.cross) for s in RM.layer_plan(rcfg)]
    assert plan == [("attn", True)] * 12
    assert len(lm.encoder.layers) == 12
    assert lm.pos_embed["pos"].shape == (4096, 768)
    assert lm.encoder.pos["pos"].shape == (1500, 768)


def test_serve_launcher_runs_on_cpu():
    env = capped_env(PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--requests", "2", "--prompt-len", "8",
         "--gen", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert f"arch={ARCH} generated 8 tokens" in proc.stdout
    assert "device=cpu" in proc.stdout
