"""Shared checks of the training parity tests: the port's loss and
gradients, and a whole ``train_loop``, against the reference's on a
reduced config in float32, the reference's weights carried across by
``interop.lm_params``.

Tolerances: the total loss, ``ce_loss`` and ``load_balance_loss`` within
1e-6 relative (the load-balance loss is exactly 0 in both for a dense
arch and positive for an MoE one); each gradient leaf within 1e-5 of its
largest magnitude (the same float32 formulas, summed in another order);
``train_loop`` losses within 1e-5 relative (AdamW divides by sqrt(v),
which turns a gradient's last bits into lr-sized moves of near-zero
coordinates, so after a step the weights part by more than the losses
do, and whole runs are held by their losses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.launch.train import train_loop as ref_train_loop
from repro.models import model as RM
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.launch.train import train_loop
from repro_torch.models import model as M
from repro_torch.train import steps as S


def trainable(cfg, rparams):
    """The reference's pytree as a port model whose leaves need grads."""
    lm = interop.lm_params(cfg, rparams, device="cpu")
    for p in lm.parameters():
        p.requires_grad_(True)
    return lm


def leaf_close(got, want, rel):
    """Each leaf of the port's pytree ``got`` within ``rel`` of the largest
    magnitude of the reference's leaf at the same path, in float32."""
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = T.flatten_with_path(got)
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w, np.float64)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.detach().double().numpy() - w).max()) \
            <= rel * scale, path


def check_loss_and_grads(rcfg, cfg, rparams, batch):
    """The port's loss, its aux losses and its gradients from
    ``train.steps.value_and_grad`` (the train step's own path) against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` on the numpy
    ``batch``.  Returns (port gradients, reference gradients)."""
    (rl, raux), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b), has_aux=True))(
            rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux, grads = S.value_and_grad(
        trainable(cfg, rparams),
        lambda m, b: M.loss_fn(m, cfg, b, remat=True),
        {k: torch.tensor(v) for k, v in batch.items()})
    for got, want in ((loss, rl), (aux["ce_loss"], raux["ce_loss"]),
                      (aux["load_balance_loss"],
                       raux["load_balance_loss"])):
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert (float(raux["load_balance_loss"]) > 0) == (cfg.moe is not None)
    if cfg.moe is None:
        assert float(aux["ce_loss"]) == float(loss)
    leaf_close(grads, rg, 1e-5)
    return grads, rg


def check_train_loop(arch, **kw):
    """``kw``'s run of the reference's ``train_loop`` and of the port's from
    the same weights (``init_params`` at PRNGKey(0), as the reference's
    draws them) on the same ``hmm_stream`` batches on the CPU: every loss
    finite and within 1e-5 relative.  Returns the port's losses."""
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    kw = dict(kw, log_every=1000)
    _, want = ref_train_loop(rcfg, **kw)
    rparams = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0),
                                                      rcfg))
    params, got, step_ms = train_loop(
        cfg, params=interop.lm_params(cfg, rparams, device="cpu"),
        device="cpu", **kw)
    assert isinstance(params, M.CausalLM) and len(step_ms) == kw["steps"]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    return got
