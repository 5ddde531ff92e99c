"""The port's training path against the reference's on reduced configs in
float32, the reference's weights carried across by ``interop.lm_params``:
loss and gradients, chunked cross-entropy, ``grad_cast``, microbatched
gradients, ``train_loop`` histories under sync and stale, checkpoints
across the two packages, the analytic FLOP/byte model and the CLI.

Tolerances: the loss within 1e-6 relative and each gradient leaf within
1e-5 of its largest magnitude (the same float32 formulas, summed in
another order); five AdamW steps of ``train_loop`` within 1e-5 relative
(AdamW divides by sqrt(v), which turns a gradient's last bits into at most
lr-sized moves of near-zero coordinates); the train step's AdamW update,
given the same gradients as the reference's, within 1e-6 of each leaf's
largest magnitude; analytic counts exact."""

import filecmp
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_arch as ref_get_arch
from repro.launch import analytic as RA
from repro.models import model as RM
from repro.train import checkpoint as RC
from repro.train.steps import _split_microbatches as ref_split
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.launch import analytic as A
from repro_torch.models import model as M
from repro_torch.train import checkpoint as C
from repro_torch.train import steps as S

from _torch_train_parity import check_loss_and_grads, check_train_loop
from _torch_threads import capped_env, one_torch_thread  # noqa: F401

ARCHS = ["gemma3-1b", "qwen2.5-3b", "phi3-mini-3.8b", "qwen1.5-110b"]
# gemma3's reduced window is 64: 72 tokens cross it
SEQ = {"gemma3-1b": 72, "qwen2.5-3b": 16, "phi3-mini-3.8b": 16,
       "qwen1.5-110b": 16}
REPO = os.path.join(os.path.dirname(__file__), "..")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    rcfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    rparams = jax.tree.map(np.asarray,
                           RM.init_params(jax.random.PRNGKey(0), rcfg))
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab_size, (2, SEQ[arch]), dtype=np.int32)
    # -1 labels are masked out of the loss
    labels = rng.integers(-1, cfg.vocab_size, (2, SEQ[arch]),
                          dtype=np.int32)
    return rcfg, cfg, rparams, {"tokens": tokens, "labels": labels}


def _port_params(arch):
    _, cfg, rparams, _ = _setup(arch)
    lm = interop.lm_params(cfg, rparams, device="cpu")
    for p in lm.parameters():
        p.requires_grad_(True)
    return lm


def _tbatch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(*_setup(arch))


def test_chunked_ce_equals_unchunked():
    """Chunks of 8, the auto chunk and one chunk give the same loss and
    gradients, and equal the cross-entropy of the full logits."""
    _, cfg, _, batch = _setup("gemma3-1b")
    tb = _tbatch(batch)
    results = []
    for chunk in (8, 0, 72, 7):          # 7 does not divide 72: one chunk
        lm = _port_params("gemma3-1b")
        h, _ = M.forward_hidden(lm, cfg, tb, attention_impl="reference")
        loss = M.chunked_ce(lm, cfg, h, tb["labels"], chunk=chunk)
        names, params = zip(*lm.named_parameters())
        results.append((loss.detach(), torch.autograd.grad(loss, params)))
    for loss, grads in results[1:]:
        torch.testing.assert_close(loss, results[0][0], rtol=1e-6, atol=0)
        for a, b in zip(grads, results[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    with torch.no_grad():
        lm = _port_params("gemma3-1b")
        logits, _ = M.forward(lm, cfg, tb, attention_impl="reference")
        lab = tb["labels"].long()
        logp = torch.log_softmax(logits, -1)
        ll = torch.gather(logp, -1, lab.clamp_min(0)[..., None])[..., 0]
        mask = (lab >= 0).float()
        want = -(ll * mask).sum() / mask.sum()
    torch.testing.assert_close(results[0][0], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("B,S,V,chunk", [
    (8, 1024, 262144, 16),      # full gemma3-1b at the chip run's batch
    (2, 72, 512, 72), (4, 100, 2 ** 20, 5), (1, 7, 2 ** 26, 1)])
def test_ce_chunk_rule(B, S, V, chunk):
    """The reference's rule: the largest divisor of S within 128 MiB of
    float32 logits on one device."""
    assert M._ce_chunk_size(B, S, V) == chunk


def test_grad_cast_cotangent_dtype():
    x = torch.randn(3, 4).to(torch.bfloat16).requires_grad_(True)
    c = torch.randn(3, 4)
    out = M.grad_cast({"w": x})
    assert torch.equal(out["w"], x) and out["w"].dtype == torch.bfloat16
    (g,) = torch.autograd.grad((out["w"].float() * c).sum(), x)
    assert g.dtype == torch.bfloat16
    assert torch.equal(g, c.to(torch.bfloat16))
    ct = M._GradCast.backward(type("Ctx", (), {"dtype": x.dtype})(),
                              torch.randn(3, 4))
    assert ct.dtype == torch.bfloat16


def test_split_microbatches_matches_reference():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (4, 6), dtype=np.int32),
             "positions": rng.integers(0, 9, (3, 4, 6), dtype=np.int32)}
    want = ref_split({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = S._split_microbatches(_tbatch(batch), 2)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("accum_mode", ["explicit", "in-loss"])
def test_microbatched_matches_full(accum_mode, monkeypatch):
    """Gradients accumulated over two microbatches equal the full batch's
    (each microbatch has the same number of unmasked labels)."""
    _, cfg, _, batch = _setup("qwen2.5-3b")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    grads = {}
    for mb in (1, 2):
        captured = {}

        def capture(params, g, opt, **kw):
            captured.update(T.flatten_with_path(g))
            return opt
        monkeypatch.setattr(S, "adamw_update_", capture)
        state = S.init_train_state(cfg, params=_port_params("qwen2.5-3b"))
        step = S.make_train_step(cfg, microbatches=mb, accum_mode=accum_mode)
        _, metrics = step(state, _tbatch(batch))
        grads[mb] = (metrics, captured)
    (m1, g1), (m2, g2) = grads[1], grads[2]
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)
    for k in g1:
        assert g2[k].dtype == torch.float32
        torch.testing.assert_close(g2[k], g1[k], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("strategy", ["sync", "stale"])
def test_train_loop_matches_reference(strategy):
    """The five losses of both train_loops within 1e-5 relative."""
    got = check_train_loop("gemma3-1b", steps=5, batch_size=4, seq_len=32,
                           lr=2e-3, strategy=strategy)
    assert got[-1] < got[0]


@pytest.mark.parametrize("strategy", ["sync", "stale"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-3b"])
def test_train_step_updates_match_reference(arch, strategy, monkeypatch):
    """Three steps of the port's train step, the gradients each AdamW
    update receives recorded and handed to the reference's
    ``adamw_update`` on the reference's pytree: every parameter leaf
    within 1e-6 of its largest magnitude (measured 1.2e-7) and the
    optimizer state alike after each step.  The reference stacks each
    segment's layers, so its norm gains (gemma3) and QKV biases (qwen2.5)
    have rank 2 and are decayed: the port's must be too.  (After several
    steps the two packages' own gradients part by AdamW's sign of rounding
    noise in near-zero gradients, 1e-5 to 1e-4 of a leaf, so whole runs
    are held by their losses above.)"""
    from repro.optim.optimizers import adamw_init as ref_adamw_init
    from repro.optim.optimizers import adamw_update as ref_adamw_update
    _, cfg, rparams, _ = _setup(arch)
    rng = np.random.default_rng(7)
    seen = []
    real = S.adamw_update_

    def record(params, grads, opt, **kw):
        seen.append((T.tree_map(lambda g: g.numpy().copy(), grads), kw))
        return real(params, grads, opt, **kw)
    monkeypatch.setattr(S, "adamw_update_", record)
    state = S.init_train_state(
        cfg, strategy, params=interop.lm_params(cfg, rparams, device="cpu"))
    step = S.make_train_step(cfg, strategy=strategy, lr=2e-3)
    ref_p = jax.tree.map(jnp.asarray, rparams)
    ref_opt = ref_adamw_init(ref_p)

    def close(got, want, what):
        got, want = T.flatten_with_path(got), T.flatten_with_path(want)
        assert [p for p, _ in got] == [p for p, _ in want], what
        for (path, g), (_, w) in zip(got, want):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(
                g.float().numpy(), w, rtol=0,
                atol=1e-6 * max(float(np.abs(w).max()), 1e-30),
                err_msg=f"{what} {path}")

    for i in range(3):
        batch = {k: rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
                 for k in ("tokens", "labels")}
        state, _ = step(state, _tbatch(batch))
        grads, kw = seen[-1]
        ref_p, ref_opt = ref_adamw_update(ref_p, grads, ref_opt, **kw)
        close(state["params"], jax.tree.map(np.asarray, ref_p),
              f"step {i} params")
        close({"m": state["opt"]["m"], "v": state["opt"]["v"]},
              jax.tree.map(np.asarray, {"m": ref_opt["m"],
                                        "v": ref_opt["v"]}),
              f"step {i} opt")
        assert int(state["opt"]["count"]) == int(ref_opt["count"]) == i + 1
        assert state["opt"]["count"].dtype == torch.int32
    # the model the loss runs is a view of the state's leaves
    for (_, leaf), (_, again) in zip(
            T.flatten_with_path(state["params"]),
            T.flatten_with_path(interop.lm_tree(state["model"]))):
        assert torch.equal(leaf, again)


def test_checkpoints_restore_across_packages(tmp_path):
    """The reference writes, the port restores (bfloat16 and float32
    leaves), and the other way round (float32: the reference's restore
    cannot read a bfloat16 leaf, its own included, so for bfloat16 the
    port's files must be byte-identical to the reference's)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    ref_tree = {"w": jnp.asarray(w).astype(jnp.bfloat16),
                "deep": [jnp.asarray(b), jnp.arange(4, dtype=jnp.int32)]}
    port_tree = {"w": torch.tensor(w).to(torch.bfloat16),
                 "deep": [torch.tensor(b), torch.arange(4, dtype=torch.int32)]}
    RC.save_checkpoint(tmp_path / "ref", ref_tree, step=3)
    C.save_checkpoint(tmp_path / "port", port_tree, step=3)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert filecmp.cmp(tmp_path / "ref" / name, tmp_path / "port" / name,
                           shallow=False), name
    got, step = C.restore_checkpoint(tmp_path / "ref", port_tree)
    assert step == 3
    for (path, g), (_, want) in zip(T.flatten_with_path(got),
                                    T.flatten_with_path(port_tree)):
        assert g.dtype == want.dtype and torch.equal(g, want), path
    f32_tree = {"deep": port_tree["deep"]}
    C.save_checkpoint(tmp_path / "port32", f32_tree, step=4)
    back, step = RC.restore_checkpoint(tmp_path / "port32",
                                       {"deep": ref_tree["deep"]})
    assert step == 4
    for a, want in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"deep": ref_tree["deep"]})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(want))


def test_model_checkpoint_across_packages(tmp_path):
    """A CausalLM saved by the port restores in the reference (the
    reference's pytree, segments stacked) and a reference model
    checkpoint restores in the port as a CausalLM."""
    rcfg, cfg, rparams, _ = _setup("gemma3-1b")
    lm = interop.lm_params(cfg, rparams, device="cpu")
    C.save_checkpoint(tmp_path / "port", {"params": lm}, step=5)
    like = {"params": jax.tree.map(jnp.asarray, rparams)}
    back, step = RC.restore_checkpoint(tmp_path / "port", like)
    assert step == 5
    for a, want in zip(jax.tree.leaves(back), jax.tree.leaves(like)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(want))
    RC.save_checkpoint(tmp_path / "ref", like, step=6)
    blank = M.init_params(cfg, device="cpu")
    got, step = C.restore_checkpoint(tmp_path / "ref", {"params": blank})
    assert step == 6 and isinstance(got["params"], M.CausalLM)
    for (name, a), (_, b) in zip(got["params"].named_parameters(),
                                 lm.named_parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_tree_inverts_lm_params(arch):
    _, cfg, rparams, _ = _setup(arch)
    tree = interop.lm_tree(interop.lm_params(cfg, rparams, device="cpu"))
    want = jax.tree_util.tree_flatten_with_path(rparams)[0]
    got = T.flatten_with_path(tree)
    assert [p for p, _ in got] == [RC._leaf_key(p) for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_full_gemma3_reference_leaves():
    """Full gemma3-1b (meta device): the reference's 83 leaves, in its
    flatten order and shapes; the largest is the tied embedding."""
    shapes = jax.eval_shape(lambda: RM.init_params(
        jax.random.PRNGKey(0), ref_get_arch("gemma3-1b")))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    got = T.flatten_with_path(interop.lm_tree(
        M.init_params(get_arch("gemma3-1b"), device="meta")))
    assert len(got) == len(want) == 83
    assert [p for p, _ in got] == [RC._leaf_key(p) for p, _ in want]
    assert [tuple(g.shape) for _, g in got] == [w.shape for _, w in want]
    assert max(g.numel() for _, g in got) == 262144 * 1152


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_matches_reference(arch):
    """Every shape of every arch: the reference's counts exactly."""
    cfg = get_arch(arch)
    assert A.param_counts(cfg) == RA.param_counts(ref_get_arch(arch))
    for name, shape in INPUT_SHAPES.items():
        assert A.model_flops(cfg, shape) == RA.model_flops(
            ref_get_arch(arch), REF_SHAPES[name])
        assert A.model_bytes(cfg, shape) == RA.model_bytes(
            ref_get_arch(arch), REF_SHAPES[name])


def test_no_mesh_and_strategy_checks():
    """A mesh must be a named torch DeviceMesh (tests/test_torch_shard.py
    runs real ones); anything else is a TypeError.  Identity layout hooks
    leave the loss as it is, bit for bit."""
    cfg = get_arch("gemma3-1b").reduced()
    with pytest.raises(TypeError):
        S.make_train_step(cfg, mesh=object())
    with pytest.raises(TypeError):
        S.make_gossip_step(cfg, mesh=object(), replicas=2)
    with pytest.raises(ValueError):
        S.make_train_step(cfg, strategy="gossip")
    lm = M.init_params(cfg, device="cpu")
    batch = _tbatch(_setup("gemma3-1b")[3])
    ident = lambda x, kind="attn": x      # noqa: E731
    hooked, _ = M.loss_fn(lm, cfg, batch, constrain=ident,
                          constrain_inner=ident, constrain_logits=ident,
                          constrain_head=ident,
                          constrain_layer=lambda t: t)
    assert torch.equal(hooked, M.loss_fn(lm, cfg, batch)[0])


def _cli(*args):
    env = capped_env(PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def test_train_cli_cpu(tmp_path):
    out = tmp_path / "run.json"
    proc = _cli("--device", "cpu", "--steps", "3", "--json", str(out),
                "--ckpt", str(tmp_path / "ck"))
    assert proc.returncode == 0, proc.stderr
    assert "trained 3 steps" in proc.stdout and "device=cpu" in proc.stdout
    import json
    run = json.loads(out.read_text())
    assert len(run["history"]) == 3 and len(run["step_ms"]) == 3
    assert all(np.isfinite(run["history"]))
    assert (tmp_path / "ck" / "manifest.json").exists()


def test_train_cli_cuda_by_default():
    """Without a GPU the default device is an error, never the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default run would train")
    proc = _cli("--steps", "1")
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
