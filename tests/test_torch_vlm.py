"""The port's qwen2-vl-72b against the reference's, on the reduced config
in float32 (two layers, GQA 4:1 at head dim 64 with QKV bias, M-RoPE
sections rescaled to (8, 12, 12), 16 vision patches), the reference's
weights carried across by ``interop.lm_params``: ``apply_mrope`` at the
full (16, 24, 24) and the reduced sections within 1e-5; full-model logits
with vision embeddings and grid positions (a 4 x 4 patch grid, then text,
as Qwen2-VL lays them out) under both attention implementations within
1e-4; text-only decode logits within 1e-4 and within the reference's
5e-4 of the text-only prefill (decoding feeds no vision embeddings, so a
vision prefill is held prefill against prefill); greedy tokens; loss and
gradients with vision inputs (the loss within 1e-6 relative, each
gradient leaf within 1e-5 of its largest magnitude); two steps of
``train_loop``; the pytree round trip; the full config's parameter count
and the serve launcher."""

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
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve.engine import greedy_generate

from _torch_mrope import grid_positions
from _torch_train_parity import check_loss_and_grads, check_train_loop

ARCH = "qwen2-vl-72b"
IMPLS = {"kernel": "pallas", "reference": "reference"}
SEQ = 40
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@functools.lru_cache(maxsize=None)
def _setup():
    rcfg, cfg = ref_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    rparams = jax.tree.map(np.asarray, jax.jit(
        lambda key: RM.init_params(key, rcfg))(jax.random.PRNGKey(0)))
    # the reference initialises QKV biases to zero: give them values, so
    # that the bias path is held too
    rng = np.random.default_rng(8)
    for name in ("bq", "bk", "bv"):
        leaf = rparams["segments"][0]["attn"][name]
        rparams["segments"][0]["attn"][name] = (
            0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
    params = interop.lm_params(cfg, rparams)
    tokens = rng.integers(0, cfg.vocab_size, (2, SEQ), dtype=np.int32)
    vision = (0.02 * rng.standard_normal(
        (2, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    positions = grid_positions(2, SEQ, cfg.vision_tokens).numpy().astype(
        np.int32)
    return rcfg, cfg, rparams, params, tokens, vision, positions


def _vision_batch(to):
    _, _, _, _, tokens, vision, positions = _setup()
    return {"tokens": to(tokens), "vision_embeds": to(vision),
            "positions": to(positions)}


@pytest.mark.parametrize("sections,head_dim", [((16, 24, 24), 128),
                                               ((8, 12, 12), 64)])
def test_apply_mrope_matches_reference(sections, head_dim):
    assert get_arch(ARCH).mrope_sections == (16, 24, 24)
    assert get_arch(ARCH).reduced().mrope_sections == (8, 12, 12)
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 24, 3, head_dim)).astype(np.float32)
    pos = grid_positions(2, 24, 16).numpy().astype(np.int32)
    pos[1] += 5             # the three streams differ everywhere
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # equal streams reduce it to the standard RoPE
    same = np.broadcast_to(pos[:1], pos.shape)
    np.testing.assert_allclose(
        L.apply_mrope(torch.tensor(x), torch.tensor(same), 1e6,
                      sections).numpy(),
        L.apply_rope(torch.tensor(x), torch.tensor(same[0]), 1e6).numpy(),
        atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6, (8, 8, 8))


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_forward_with_vision_matches_reference(impl):
    rcfg, cfg, rparams, params, *_ = _setup()
    want, _ = jax.jit(lambda p, b: RM.forward(
        p, rcfg, b, attention_impl=IMPLS[impl]))(
            rparams, _vision_batch(jnp.asarray))
    got, _ = M.forward(params, cfg, _vision_batch(torch.tensor),
                       attention_impl=impl)
    assert got.shape == (2, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the vision inputs and the grid positions both reach the logits
    text, _ = M.forward(params, cfg, {"tokens": torch.tensor(_setup()[4])},
                        attention_impl=impl)
    assert float((text - got).abs().max()) > 1e-3


@functools.lru_cache(maxsize=None)
def _ref_step():
    rcfg = _setup()[0]
    return jax.jit(lambda p, t, s: RM.decode_step(p, rcfg, t, s))


def _port_decode():
    _, cfg, _, params, tokens, _, _ = _setup()
    state = M.init_decode_state(cfg, tokens.shape[0], 64, device="cpu")
    out = []
    for t in range(tokens.shape[1]):
        logits, state = M.decode_step(
            params, cfg, torch.tensor(tokens[:, t:t + 1]), state)
        out.append(logits[:, 0].numpy())
    return np.stack(out, axis=1), state


def test_text_decode_matches_reference():
    rcfg, _, rparams, _, tokens, _, _ = _setup()
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


def test_text_prefill_decode_consistency():
    """Text only: the default (p, p, p) positions of the prefill are the
    decode's."""
    _, cfg, _, params, tokens, _, _ = _setup()
    full, _ = M.forward(params, cfg, {"tokens": torch.tensor(tokens)})
    dec, _ = _port_decode()
    assert np.max(np.abs(dec - full.numpy())) < 5e-4


def test_greedy_generate_matches_reference():
    rcfg, cfg, rparams, params, tokens, _, _ = _setup()
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
    got = greedy_generate(params, cfg, torch.tensor(prompts), 5,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_loss_and_grads_match_reference():
    rcfg, cfg, rparams, *_ = _setup()
    batch = _vision_batch(np.asarray)
    batch["labels"] = np.random.default_rng(6).integers(
        -1, cfg.vocab_size, batch["tokens"].shape, dtype=np.int32)
    grads, _ = check_loss_and_grads(rcfg, cfg, rparams, batch)
    assert float(grads["segments"][0]["attn"]["bq"].abs().max()) > 0


def test_train_loop_matches_reference():
    """Two sync steps of ``launch.train.train_loop``, whose batches carry
    zero vision embeddings as the reference's do, against the reference's
    loop."""
    check_train_loop(ARCH, steps=2, batch_size=2, seq_len=24, lr=2e-3,
                     strategy="sync")


def test_lm_tree_inverts_lm_params():
    _, cfg, rparams, params, *_ = _setup()
    tree = interop.lm_tree(params)
    want = jax.tree_util.tree_flatten_with_path(rparams)[0]
    got = T.flatten_with_path(tree)
    assert len(got) == len(want)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    again = interop.lm_tree(interop.lm_params(cfg, tree))
    for (_, g), (_, w) in zip(T.flatten_with_path(again), got):
        assert torch.equal(g, w)


def test_full_param_count_matches_reference():
    """The full config on the meta device: the reference's eval_shape
    shapes and count (72.7 B), and the 4-layer cut the card serves."""
    cfg, rcfg = get_arch(ARCH), ref_get_arch(ARCH)
    lm = M.init_params(cfg, device="meta")
    shapes = jax.eval_shape(lambda: RM.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = T.flatten_with_path(interop.lm_tree(lm))
    assert [tuple(g.shape) for _, g in got] == [w.shape for _, w in want]
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(np.prod(w.shape)) for _, w in want) == 72706203648
    cut = M.init_params(dataclasses.replace(cfg, num_layers=4),
                        device="meta")
    assert sum(p.numel() for p in cut.parameters()) == 6002163712


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
