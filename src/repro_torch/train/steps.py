"""Train-step factories, one per paper exchange strategy (the port of
``repro/train/steps.py``), on one device.

  sync    mini-batch AdamW (Alg 2): the gradient of the batch's mean loss.
  stale   Hogwild!'s insight (Alg 1): the update applied at step t uses
          the gradient computed at step t-1 (tau = 1 staleness).
  gossip  ECD-PSGD (Alg 4): R model replicas, each on its own block of
          the batch, exchange *compressed* (stochastically quantized)
          extrapolation variables over a ring.

The reference shards these over a mesh; the port takes ``mesh=None`` and
raises NotImplementedError for a mesh (``distributed/rules.py`` is not
ported yet).

Every state holds its weights as the reference does: ``params`` is the
reference's parameter pytree (:func:`repro_torch.interop.lm_tree`, each
segment's layers stacked on a leading axis), and the optimizer, the
gradients and the compression run over those leaves, so a rank-dependent
rule (AdamW decays leaves of rank 2 and more: a stacked norm gain too)
and a per-leaf draw see what the reference's see.  The ``CausalLM`` that
the loss runs is built once, its parameters views of the leaves, and each
step writes the new weights into the leaves in place.  Gradients come
back per layer and are stacked into the tree's layout (one copy).

The gossip step keeps its R replicas stacked on one device: every leaf
with a leading replica axis, one ``CausalLM`` of views per replica.
Replica r takes rows ``[r B/R, (r+1) B/R)`` of the batch, as
``shard_map`` gives it.  C(.) runs leaf by leaf with the R replicas as R
rows of one ``(R, numel)`` matrix, one scale per row: one K3
(``quantize_rows``) and one K4 (``dequantize_rows``) launch per leaf and
compression on the card, two compressions a step.

Steps return the state and metrics as tensors on the device; nothing in a
step waits for the device.
"""

from __future__ import annotations

import torch

from repro_torch import interop
from repro_torch import random as R
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compression
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models import model as M
from repro_torch.optim import adamw_init, adamw_update


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh needs distributed/rules.py, not ported yet "
            "(ROADMAP A12/A14); pass mesh=None for one device")


def _model(cfg, tree):
    """A trainable ``CausalLM`` whose parameters are views of ``tree``'s
    leaves (the reference's pytree)."""
    lm = interop.lm_params(cfg, tree, T.flatten(tree)[0][0].device)
    for p in lm.parameters():
        p.requires_grad_(True)
    return lm


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def init_train_state(cfg: ArchConfig, strategy="sync", *, params=None,
                     generator=None, device=DEFAULT_DEVICE):
    """{"params": the reference's pytree, "model": a ``CausalLM`` of views
    of it, "opt": AdamW state over the pytree, "step"} (+ "prev_grads"
    for ``stale``).  Weights from ``generator`` (``models.model.
    init_params``) unless a ``CausalLM`` is given as ``params``; the state
    copies them and shares no memory with ``params``."""
    lm = params if params is not None else M.init_params(cfg, generator,
                                                         device)
    tree = T.tree_map(torch.clone, interop.lm_tree(lm))
    state = {"params": tree, "model": _model(cfg, tree),
             "opt": adamw_init(tree),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=lm.embed["table"].device)}
    if strategy == "stale":
        state["prev_grads"] = T.tree_map(torch.zeros_like, tree)
    return state


# ---------------------------------------------------------------------------
# sync / stale steps
# ---------------------------------------------------------------------------

def _split_microbatches(batch, m):
    """(B, ...) -> (m, B/m, ...); M-RoPE positions (3, B, S) split on
    axis 1."""
    out = {}
    for name, leaf in batch.items():
        if name == "positions":
            out[name] = leaf.reshape(leaf.shape[0], m, -1,
                                     *leaf.shape[2:]).transpose(0, 1)
        else:
            out[name] = leaf.reshape(m, -1, *leaf.shape[1:])
    return out


def value_and_grad(lm, loss, batch, out=None):
    """``loss(lm, batch) -> (l, aux)`` and its gradient with respect to
    every parameter of ``lm`` as the reference's pytree (written into
    ``out``'s leaves when it is given): (l, aux, grads), all detached.  A
    parameter the loss never reads (Mamba2's ``dt_bias``) gets a zero
    gradient of its own type, as ``jax.grad`` gives it."""
    (l, aux) = loss(lm, batch)
    names, params = zip(*lm.named_parameters())
    grads = torch.autograd.grad(l, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return l.detach(), {k: v.detach() for k, v in aux.items()}, \
        interop.lm_tree(lm, dict(zip(names, grads)), out)


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in T.flatten(tree)[0]))


def make_train_step(cfg: ArchConfig, mesh=None, *, strategy="sync",
                    lr=3e-4, remat=True, microbatches=1,
                    grad_accum_dtype=torch.float32, accum_mode="explicit"):
    """``step(state, batch) -> (state, metrics)`` for ``strategy``
    ``sync`` or ``stale``; ``microbatches`` > 1 accumulates gradients
    either per microbatch in ``grad_accum_dtype`` (``accum_mode
    "explicit"``) or in the backward pass of the summed loss
    (``"in-loss"``)."""
    _no_mesh(mesh)
    if strategy not in ("sync", "stale"):
        raise ValueError(f"strategy {strategy!r} must be sync or stale")
    if accum_mode not in ("explicit", "in-loss"):
        raise ValueError(f"accum_mode {accum_mode!r} must be explicit or "
                         f"in-loss")

    def loss(lm, batch):
        return M.loss_fn(lm, cfg, batch, remat=remat)

    def grads_of(lm, batch):
        """Gradient of the mean loss, microbatched."""
        if microbatches <= 1:
            return value_and_grad(lm, loss, batch)
        mb = _split_microbatches(batch, microbatches)
        parts = [{k: v[i] for k, v in mb.items()}
                 for i in range(microbatches)]
        if accum_mode == "in-loss":
            def total_loss(lm_, _):
                tot = torch.zeros((), dtype=torch.float32,
                                  device=batch["tokens"].device)
                for one in parts:
                    l, aux = loss(lm_, one)
                    tot = tot + l
                return tot / microbatches, aux
            return value_and_grad(lm, total_loss, None)
        acc_g, acc_l = None, torch.zeros((), dtype=torch.float32,
                                         device=batch["tokens"].device)
        for one in parts:
            l, aux, g = value_and_grad(lm, loss, one)
            g = T.tree_map(lambda x: x.to(grad_accum_dtype), g)
            acc_g = g if acc_g is None else T.tree_map(torch.add, acc_g, g)
            acc_l = acc_l + l
        grads = T.tree_map(lambda x: x / microbatches, acc_g)
        return acc_l / microbatches, aux, grads

    def apply(state, grads):
        new_p, new_opt = adamw_update(state["params"], grads, state["opt"],
                                      lr=lr)
        with torch.no_grad():       # the model's parameters are views
            for p, q in zip(T.flatten(state["params"])[0],
                            T.flatten(new_p)[0]):
                p.copy_(q)
        return new_opt

    def sync_step(state, batch):
        l, aux, grads = grads_of(state["model"], batch)
        new_opt = apply(state, grads)
        metrics = {"loss": l, "ce_loss": aux["ce_loss"],
                   "grad_norm": _global_norm(grads)}
        return dict(state, opt=new_opt, step=state["step"] + 1), metrics

    def stale_step(state, batch):
        # apply last step's gradient while computing this step's
        l, aux, grads = grads_of(state["model"], batch)
        metrics = {"loss": l, "ce_loss": aux["ce_loss"],
                   "grad_norm": _global_norm(grads)}
        prev = T.tree_map(lambda g, p: g.to(p.dtype), grads,
                          state["params"])
        new_opt = apply(state, state["prev_grads"])
        return dict(state, opt=new_opt, step=state["step"] + 1,
                    prev_grads=prev), metrics

    return {"sync": sync_step, "stale": stale_step}[strategy]


# ---------------------------------------------------------------------------
# gossip (ECD-PSGD) step — R replicas stacked on one device
# ---------------------------------------------------------------------------

def init_gossip_state(cfg: ArchConfig, replicas: int, *, params=None,
                      generator=None, device=DEFAULT_DEVICE):
    """{"params": tree, "y": tree, "models", "step"}: the reference's
    parameter pytree with a leading replica axis of ``replicas``, every
    replica starting from the same weights (``params`` or drawn from
    ``generator``), the extrapolation variables ``y`` equal to them, and
    one ``CausalLM`` per replica whose parameters are views of its slice
    of ``params``."""
    lm = params if params is not None else M.init_params(cfg, generator,
                                                         device)
    tree = interop.lm_tree(lm)
    stack = T.tree_map(lambda x: x.expand(replicas, *x.shape).clone(), tree)
    return {"params": stack, "y": T.tree_map(torch.clone, stack),
            "models": [_model(cfg, T.tree_map(lambda x: x[r], stack))
                       for r in range(replicas)],
            "step": torch.zeros((), dtype=torch.int32,
                                device=lm.embed["table"].device)}


def _compress(leaf, keys, bits):
    """C(.) of each replica's leaf: ``leaf`` (R, ...) -> dequantize(
    quantize_stochastic(leaf[r], keys[r])) as float32 (R, ...), with one
    scale per replica (row)."""
    rows = leaf.reshape(leaf.shape[0], -1).to(torch.float32).contiguous()
    u = R.uniform(keys, rows.shape[1:])
    q, scale = compression.quantize_rows_stochastic(rows, u, bits=bits)
    return compression.dequantize_rows(q, scale).reshape(leaf.shape)


def make_gossip_step(cfg: ArchConfig, mesh=None, *, replicas: int, lr=3e-4,
                     compress_bits=8, remat=False):
    """ECD-PSGD over ``replicas`` stacked replicas on a ring; returns
    ``step(state, batch) -> (state, {"loss"})``, the loss averaged over
    the replicas; ``params`` and ``y`` are updated in place.  Keys, the
    ring average and the extrapolation follow the reference's
    ``local_step`` (``repro/train/steps.py``) leaf by leaf."""
    _no_mesh(mesh)
    n_rep = replicas

    def loss(lm, batch):
        return M.loss_fn(lm, cfg, batch, remat=remat)

    def replica_grads(state, batch):
        """Each replica's loss and gradient (the reference's pytree,
        stacked over replicas) on its block of the batch."""
        B = batch["tokens"].shape[0]
        if B % n_rep:
            raise ValueError(f"batch {B} does not split over {n_rep} "
                             f"replicas")
        rows = B // n_rep
        grads = T.tree_map(torch.empty_like, state["params"])
        losses = []
        for r, lm in enumerate(state["models"]):
            one = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
            l, _, _ = value_and_grad(lm, loss, one,
                                     T.tree_map(lambda x: x[r], grads))
            losses.append(l)
        return torch.stack(losses), grads

    def step(state, batch):
        params, y_var = state["params"], state["y"]
        dev = state["step"].device
        t = state["step"].to(torch.float32) + 2.0
        key = R.fold_in(R.fold_in(R.PRNGKey(17, device=dev), state["step"]),
                        torch.arange(n_rep, device=dev))        # (R, 2)
        losses, grads = replica_grads(state, batch)
        three = torch.full((), 3.0, dtype=torch.float32, device=dev)

        def ring_avg(leaf):
            # ppermute forward (i -> i+1) and backward (i -> i-1) on a ring
            total = leaf.to(torch.float32)
            total = total + torch.roll(leaf, 1, 0).to(torch.float32)
            total = total + torch.roll(leaf, -1, 0).to(torch.float32)
            return (total / three).to(leaf.dtype)

        y_leaves = T.flatten(y_var)[0]
        x_leaves = T.flatten(params)[0]
        g_leaves = T.flatten(grads)[0]
        keys_a = R.split(key, len(y_leaves))                    # (R, n, 2)
        keys_b = R.split(R.fold_in(key, 1), len(y_leaves))
        for j, (y, x, g) in enumerate(zip(y_leaves, x_leaves, g_leaves)):
            # pull compressed neighbour y (Alg 4 step 3)
            y_comp = _compress(y, keys_a[:, j], compress_bits).to(y.dtype)
            x_half = ring_avg(y_comp)
            x_new = (x_half.to(torch.float32)
                     - lr * g.to(torch.float32)).to(x_half.dtype)
            # extrapolate + compress (Alg 4 steps 4-5)
            z = (1.0 - t / 2.0) * x.to(torch.float32) \
                + (t / 2.0) * x_new.to(torch.float32)
            cz = _compress(z, keys_b[:, j], compress_bits)
            y_new = ((1.0 - 2.0 / t) * y.to(torch.float32)
                     + (2.0 / t) * cz).to(y.dtype)
            with torch.no_grad():
                x.copy_(x_new)
                y.copy_(y_new)
        return dict(state, step=state["step"] + 1), {"loss": losses.mean()}

    return step
