"""Training the recurrent, hybrid and MoE families: the port's loss and
gradients against the reference's on the reduced configs in float32
(xlstm-350m: an mLSTM and an sLSTM layer; zamba2-1.2b: a Mamba2 and a
shared-attention layer; arctic-480b: two MoE layers with a dense
residual), the reference's weights carried across by
``interop.lm_params``, and one ECD-PSGD gossip step on zamba2.

Tolerances are ``_torch_train_parity``'s: the total loss, ``ce_loss`` and
``load_balance_loss`` within 1e-6 relative, each gradient leaf within
1e-5 of its largest magnitude.  Mamba2's
``dt_bias`` is never read by either package's forward pass (both apply
softplus to the projected dt alone), so its gradient is exactly zero in
both: ``jax.grad`` gives an unused leaf zeros, and so must
``train.steps.value_and_grad``."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import model as RM
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as M
from repro_torch.train import steps as S

from _torch_train_parity import check_loss_and_grads
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["xlstm-350m", "zamba2-1.2b", "arctic-480b"]
SEQ = 40                # off the reduced SSM chunk of 32


@functools.lru_cache(maxsize=None)
def _setup(arch):
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    rparams = jax.tree.map(np.asarray, jax.jit(
        lambda key: RM.init_params(key, rcfg))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(len(arch))
    # -1 labels are masked out of the loss
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, SEQ),
                                    dtype=np.int32),
             "labels": rng.integers(-1, cfg.vocab_size, (2, SEQ),
                                    dtype=np.int32)}
    return rcfg, cfg, rparams, batch


def _dt_bias(tree):
    return [leaf for path, leaf in T.flatten_with_path(tree)
            if path.endswith("/dt_bias")]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    grads, rg = check_loss_and_grads(*_setup(arch))
    if arch == "zamba2-1.2b":
        ref_dt = [leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(rg)[0]
                  if getattr(path[-1], "key", None) == "dt_bias"]
        assert len(ref_dt) == len(_dt_bias(grads)) == 1
        assert not np.asarray(ref_dt[0]).any()
        assert not _dt_bias(grads)[0].any()


def test_unused_parameter_gets_zero_gradient():
    """``value_and_grad`` on a model with a leaf that the loss never reads
    gives that leaf zeros of its own type (in a bfloat16 model too)."""
    cfg = get_arch("zamba2-1.2b").reduced()
    lm = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(
        torch.bfloat16)
    for p in lm.parameters():
        p.requires_grad_(True)
    rng = np.random.default_rng(3)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (2, 8)))
             for k in ("tokens", "labels")}
    loss, _, grads = S.value_and_grad(lm, lambda m, b: M.loss_fn(m, cfg, b),
                                      batch)
    assert torch.isfinite(loss)
    (dt,) = _dt_bias(grads)
    (param,) = _dt_bias(interop.lm_tree(lm))
    assert dt.dtype == param.dtype and dt.shape == param.shape
    assert not dt.any()


def test_gossip_step_runs_on_zamba2():
    """One port gossip step (R = 2) on zamba2's reduced config: the step's
    loss is the mean of each replica's ``loss_fn`` on its weights before
    the update and its block of the batch; every leaf stays finite and
    the weights move."""
    _, cfg, rparams, _ = _setup("zamba2-1.2b")
    rng = np.random.default_rng(11)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 32),
                                          dtype=np.int32))
             for k in ("tokens", "labels")}
    state = S.init_gossip_state(
        cfg, 2, params=interop.lm_params(cfg, rparams, device="cpu"))
    before = T.tree_map(torch.clone, state["params"])
    with torch.no_grad():
        want = torch.stack([
            M.loss_fn(lm, cfg, {k: v[2 * r:2 * r + 2]
                                for k, v in batch.items()})[0]
            for r, lm in enumerate(state["models"])]).mean()
    step = S.make_gossip_step(cfg, replicas=2, lr=2e-3)
    # the step's threefry draws are thousands of int64 elementwise ops over
    # whole leaves; on a CPU shared by several test workers each
    # multi-threaded op can stall at its barrier, so the step runs on one
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, metrics = step(state, batch)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(metrics["loss"], want)
    assert int(state["step"]) == 1
    leaves = T.flatten(state["params"])[0] + T.flatten(state["y"])[0]
    assert all(bool(torch.isfinite(x).all()) for x in leaves)
    assert any(not torch.equal(a, b) for a, b in zip(
        T.flatten(state["params"])[0], T.flatten(before)[0]))
