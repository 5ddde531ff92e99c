"""Train-step factories, one per paper exchange strategy (the port of
``repro/train/steps.py``), on one device.

  sync    mini-batch AdamW (Alg 2): the gradient of the batch's mean loss.
  stale   Hogwild!'s insight (Alg 1): the update applied at step t uses
          the gradient computed at step t-1 (tau = 1 staleness).
  gossip  ECD-PSGD (Alg 4): R model replicas, each on its own block of
          the batch, exchange *compressed* (stochastically quantized)
          extrapolation variables over a ring.

Every factory takes ``mesh``: None runs on one device, as below; a named
torch ``DeviceMesh`` (``distributed.make_debug_mesh`` /
``make_production_mesh``) runs the reference's sharded step.  There the
train state's leaves are DTensors laid out by :func:`train_state_specs`,
each batch is laid out by ``rules.batch_specs``, the model runs through
the reference's hooks (``act_constraint``, ``inner_act_constraint`` and,
with ``grad_shard``, ``layer_constraint``, ``logits_constraint`` and
``head_constraint``), and the gradients are pinned to the parameters'
layout, so the FSDP reduction is a reduce-scatter.  The gossip step puts
one replica on each rank of the data axes (``shard_map``'s layout): each
rank computes its replica's step on its local leaves, K3 and K4 included,
and the ring exchange is a permute collective over each data axis.
Anything but None or a named mesh raises TypeError.

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

import contextlib

import torch

from repro_torch import interop
from repro_torch import random as R
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compression
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.distributed import local as DL
from repro_torch.distributed import rules as RU
from repro_torch.distributed.mesh import check_model_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw_init, adamw_update_


def mesh_context(mesh):
    """The context a mesh step runs in: plain tensors the model makes
    (masks, positions, zeros) count as replicated DTensors."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _plain(x):
    """A DTensor's global value as a tensor (a tensor stays itself)."""
    return x.full_tensor() if DL.is_dtensor(x) else x


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
                     generator=None, device=DEFAULT_DEVICE, mesh=None):
    """{"params": the reference's pytree, "model": a ``CausalLM`` of views
    of it, "opt": AdamW state over the pytree, "step"} (+ "prev_grads"
    for ``stale``).  Weights from ``generator`` (``models.model.
    init_params``) unless a ``CausalLM`` is given as ``params``; the state
    copies them and shares no memory with ``params``.  With ``mesh`` the
    state is laid out by :func:`train_state_specs` (:func:`shard_state`)."""
    check_model_mesh(mesh)
    lm = params if params is not None else M.init_params(cfg, generator,
                                                         device)
    tree = T.tree_map(torch.clone, interop.lm_tree(lm))
    state = {"params": tree, "model": _model(cfg, tree),
             "opt": adamw_init(tree),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=lm.embed["table"].device)}
    if strategy == "stale":
        state["prev_grads"] = T.tree_map(torch.zeros_like, tree)
    return state if mesh is None else shard_state(cfg, state, mesh)


def train_state_specs(state_shapes, mesh):
    """The train state's specs: parameters, AdamW moments and stale
    gradients by ``rules.param_specs``; scalars replicated."""
    pspecs = RU.param_specs(state_shapes["params"], mesh)
    specs = {"params": pspecs,
             "opt": {"m": pspecs, "v": pspecs, "count": RU.P()},
             "step": RU.P()}
    if "prev_grads" in state_shapes:
        specs["prev_grads"] = pspecs
    return specs


def shard_state(cfg: ArchConfig, state, mesh):
    """A train state (every rank holding the same global values) laid out
    on ``mesh`` by :func:`train_state_specs`, its ``CausalLM`` rebuilt as
    views of the DTensor leaves (a leaf already laid out stays as it
    is)."""
    specs = train_state_specs(state, mesh)
    out = dict(state, **{k: RU.place_tree(state[k], specs[k], mesh)
                         for k in specs})
    out["model"] = _model(cfg, out["params"])
    return out


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
    gradient of its own type, as ``jax.grad`` gives it.  A DTensor loss
    is replicated first, so each rank seeds the backward pass with 1."""
    (l, aux) = loss(lm, batch)
    if DL.is_dtensor(l):
        l = DL.replicate(l)
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
                    lr=3e-4, remat=True, attention_impl="reference",
                    seq_shard=True, grad_shard=True, microbatches=1,
                    grad_accum_dtype=torch.float32, accum_mode="explicit",
                    lb_coef=0.01):
    """``step(state, batch) -> (state, metrics)`` for ``strategy``
    ``sync`` or ``stale``, the loss weighing the MoE load-balance term by
    ``lb_coef`` (the reference's ``train_loop`` argument; its own
    ``make_train_step`` takes ``loss_fn``'s default, 0.01);
    ``microbatches`` > 1 accumulates gradients
    either per microbatch in ``grad_accum_dtype`` (``accum_mode
    "explicit"``) or in the backward pass of the summed loss
    (``"in-loss"``).  The loss takes the reference's arithmetic
    (``attention_impl="reference"``, the only value: the kernels have no
    backward).

    On a mesh the state must come from ``init_train_state(...,
    mesh=mesh)`` (or :func:`shard_state`), each batch leaf is the global
    batch (a tensor every rank holds, or a DTensor), microbatches are
    split from it as the reference splits them and each laid out by
    ``batch_specs``; ``seq_shard`` and ``grad_shard`` select the
    reference's hooks.  Metrics come back as plain tensors."""
    check_model_mesh(mesh)
    if attention_impl != "reference":
        raise ValueError(f"attention_impl {attention_impl!r}: training "
                         f"takes the reference's arithmetic")
    if strategy not in ("sync", "stale"):
        raise ValueError(f"strategy {strategy!r} must be sync or stale")
    if accum_mode not in ("explicit", "in-loss"):
        raise ValueError(f"accum_mode {accum_mode!r} must be explicit or "
                         f"in-loss")

    hooks = {}
    if mesh is not None:
        hooks = dict(constrain=RU.act_constraint(mesh, seq_shard=seq_shard),
                     constrain_inner=RU.inner_act_constraint(
                         mesh, seq_shard=seq_shard, cfg=cfg))
        if grad_shard:
            hooks.update(constrain_layer=RU.layer_constraint(mesh),
                         constrain_logits=RU.logits_constraint(mesh),
                         constrain_head=RU.head_constraint(mesh))

    def loss(lm, batch):
        return M.loss_fn(lm, cfg, batch, remat=remat, lb_coef=lb_coef,
                         **hooks)

    def place(batch):
        if mesh is None:
            return batch
        return RU.place_tree(batch, RU.batch_specs(batch, mesh), mesh)

    def constrain_grads(grads):
        # the gradients in the parameters' layout: the FSDP reduction
        # becomes a reduce-scatter
        if mesh is None or not grad_shard:
            return grads
        return RU.place_tree(grads, RU.param_specs(grads, mesh), mesh)

    def grads_of(lm, batch):
        """Gradient of the mean loss, microbatched."""
        if microbatches <= 1:
            l, aux, g = value_and_grad(lm, loss, place(batch))
            return l, aux, constrain_grads(g)
        mb = _split_microbatches(
            {k: _plain(v) for k, v in batch.items()}, microbatches)
        parts = [place({k: v[i] for k, v in mb.items()})
                 for i in range(microbatches)]
        if accum_mode == "in-loss":
            def total_loss(lm_, _):
                tot = torch.zeros((), dtype=torch.float32,
                                  device=batch["tokens"].device)
                for one in parts:
                    l, aux = loss(lm_, one)
                    tot = tot + l
                return tot / microbatches, aux
            l, aux, g = value_and_grad(lm, total_loss, None)
            return l, aux, constrain_grads(g)
        acc_g, acc_l = None, torch.zeros((), dtype=torch.float32,
                                         device=batch["tokens"].device)
        for one in parts:
            l, aux, g = value_and_grad(lm, loss, one)
            g = constrain_grads(T.tree_map(lambda x: x.to(grad_accum_dtype),
                                           g))
            acc_g = g if acc_g is None else T.tree_map(torch.add, acc_g, g)
            acc_l = acc_l + l
        grads = T.tree_map(lambda x: x / microbatches, acc_g)
        return acc_l / microbatches, aux, grads

    def apply(state, grads):
        # in place: the model's parameters are views of the state's leaves
        return adamw_update_(state["params"], grads, state["opt"], lr=lr)

    def metrics_of(l, aux, grads):
        return {"loss": _plain(l), "ce_loss": _plain(aux["ce_loss"]),
                "grad_norm": _plain(_global_norm(grads))}

    def sync_step(state, batch):
        l, aux, grads = grads_of(state["model"], batch)
        new_opt = apply(state, grads)
        return (dict(state, opt=new_opt, step=state["step"] + 1),
                metrics_of(l, aux, grads))

    def stale_step(state, batch):
        # apply last step's gradient while computing this step's
        l, aux, grads = grads_of(state["model"], batch)
        metrics = metrics_of(l, aux, grads)
        prev = T.tree_map(lambda g, p: g.to(p.dtype), grads,
                          state["params"])
        new_opt = apply(state, state["prev_grads"])
        return dict(state, opt=new_opt, step=state["step"] + 1,
                    prev_grads=prev), metrics

    step = {"sync": sync_step, "stale": stale_step}[strategy]

    def grads(state, batch):
        """The step's (loss, aux, gradients) without the update."""
        with mesh_context(mesh):
            return grads_of(state["model"], batch)

    def mesh_step(state, batch):
        with mesh_context(mesh):
            return step(state, batch)
    out = step if mesh is None else mesh_step
    out.grads = grads
    return out


# ---------------------------------------------------------------------------
# gossip (ECD-PSGD) step — R replicas stacked on one device
# ---------------------------------------------------------------------------

def replicas_of(mesh):
    """The gossip step's replica count on ``mesh``: the product of its
    data axes' sizes."""
    shape = RU.mesh_shape(mesh)
    n = 1
    for a in RU.data_axis_tuple(mesh):
        n *= shape[a]
    return n


def _replica_index(mesh):
    """This rank's replica: its coordinate over the data axes, the first
    axis major."""
    names = RU.axis_names(mesh)
    idx = 0
    for a in RU.data_axis_tuple(mesh):
        i = names.index(a)
        idx = idx * mesh.shape[i] + mesh.get_local_rank(i)
    return idx


def _replica_placements(mesh):
    """The replica axis (dimension 0) over the data axes, replicated over
    'model' (placements on ``rules.compute_mesh(mesh)``)."""
    return RU.to_placements(RU.P(RU.data_axes(mesh)), mesh)


def init_gossip_state(cfg: ArchConfig, n_replicas=None, *, params=None,
                      generator=None, device=DEFAULT_DEVICE, mesh=None):
    """{"params": tree, "y": tree, "models", "step"}: the reference's
    parameter pytree with a leading replica axis of ``n_replicas``, every
    replica starting from the same weights (``params`` or drawn from
    ``generator``), the extrapolation variables ``y`` equal to them, and
    one ``CausalLM`` per replica whose parameters are views of its slice
    of ``params``.

    With ``mesh`` the replica axis lies over the data axes
    (``n_replicas`` is :func:`replicas_of` the mesh): each leaf is a DTensor
    of global shape (R, ...) whose local shard is this rank's replica,
    and ``models`` holds the one ``CausalLM`` of this rank's replica,
    views of the local shards."""
    check_model_mesh(mesh)
    lm = params if params is not None else M.init_params(cfg, generator,
                                                         device)
    tree = interop.lm_tree(lm)
    if mesh is not None:
        from torch.distributed.tensor import DTensor
        n_rep = replicas_of(mesh)
        if n_replicas not in (None, n_rep):
            raise ValueError(f"n_replicas={n_replicas}: the mesh's data "
                             f"axes hold {n_rep}")
        pl = _replica_placements(mesh)

        cmesh = RU.compute_mesh(mesh)

        def stack():
            return T.tree_map(lambda x: DTensor.from_local(
                x[None].clone(), cmesh, pl, run_check=False,
                shape=(n_rep,) + tuple(x.shape),
                stride=(x.numel(),) + tuple(x[None].stride()[1:])), tree)
        stack_p = stack()
        return {"params": stack_p, "y": stack(),
                "models": [_model(cfg, T.tree_map(
                    lambda x: x.to_local()[0], stack_p))],
                "step": torch.zeros((), dtype=torch.int32,
                                    device=lm.embed["table"].device)}
    stack = T.tree_map(lambda x: x.expand(n_replicas, *x.shape).clone(),
                       tree)
    return {"params": stack, "y": T.tree_map(torch.clone, stack),
            "models": [_model(cfg, T.tree_map(lambda x: x[r], stack))
                       for r in range(n_replicas)],
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


def make_gossip_step(cfg: ArchConfig, mesh=None, *, replicas=None,
                     lr=3e-4, compress_bits=8, remat=False,
                     attention_impl="reference"):
    """ECD-PSGD over ``replicas`` stacked replicas on a ring; returns
    ``step(state, batch) -> (state, {"loss"})``, the loss averaged over
    the replicas; ``params`` and ``y`` are updated in place.  Keys, the
    ring average and the extrapolation follow the reference's
    ``local_step`` (``repro/train/steps.py``) leaf by leaf.  With
    ``mesh``, :func:`_mesh_gossip_step`."""
    check_model_mesh(mesh)
    if attention_impl != "reference":
        raise ValueError(f"attention_impl {attention_impl!r}: training "
                         f"takes the reference's arithmetic")
    if mesh is not None:
        return _mesh_gossip_step(cfg, mesh, lr=lr,
                                 compress_bits=compress_bits, remat=remat)
    if replicas is None:
        raise ValueError("make_gossip_step without a mesh needs replicas")
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


def _mesh_gossip_step(cfg: ArchConfig, mesh, *, lr, compress_bits, remat):
    """The reference's ``shard_map``'d ``local_step``: this rank holds
    replica r (its coordinate over the data axes; the 'model' ranks of a
    replica compute the same step), takes rows ``[r B/R, (r+1) B/R)`` of
    the batch, draws replica r's keys (the stacked step's row r), runs K3
    and K4 on its own leaves, averages its compressed neighbours' y over
    a ring on each data axis (two permutes per axis, one each way) and
    averages the loss over the data axes."""
    import torch.distributed._functional_collectives as funcol
    n_rep = replicas_of(mesh)
    names = RU.axis_names(mesh)
    axes = [names.index(a) for a in RU.data_axis_tuple(mesh)]

    def loss(lm, batch):
        return M.loss_fn(lm, cfg, batch, remat=remat)

    def ring_avg(leaf):
        total = leaf.to(torch.float32)
        n = 1
        for i in axes:
            size = mesh.shape[i]
            fwd = [(r + 1) % size for r in range(size)]
            bwd = [(r - 1) % size for r in range(size)]
            for src_dst in (fwd, bwd):
                got = funcol.permute_tensor(leaf.reshape(-1), src_dst,
                                            (mesh, i))
                total = total + funcol.wait_tensor(got).reshape(
                    leaf.shape).to(torch.float32)
            n += 2
        return (total / n).to(leaf.dtype)

    def local_rows(x, r):
        if DL.is_dtensor(x):
            return x.redistribute(x.device_mesh,
                                  _replica_placements(mesh)).to_local()
        B = x.shape[0]
        if B % n_rep:
            raise ValueError(f"batch {B} does not split over {n_rep} "
                             f"replicas")
        rows = B // n_rep
        return x[r * rows:(r + 1) * rows]

    def step(state, batch):
        r = _replica_index(mesh)
        lm = state["models"][0]
        x_leaves = [x.to_local()[0] for x in T.flatten(state["params"])[0]]
        y_leaves = [y.to_local()[0] for y in T.flatten(state["y"])[0]]
        step_t = _plain(state["step"])
        dev = step_t.device
        t = step_t.to(torch.float32) + 2.0
        key = R.fold_in(R.fold_in(R.PRNGKey(17, device=dev), step_t),
                        torch.tensor([r], device=dev))          # (1, 2)
        one = {k: local_rows(v, r) for k, v in batch.items()}
        l, _, grads = value_and_grad(lm, loss, one)
        g_leaves = T.flatten(grads)[0]
        keys_a = R.split(key, len(y_leaves))                    # (1, n, 2)
        keys_b = R.split(R.fold_in(key, 1), len(y_leaves))
        for j, (y, x, g) in enumerate(zip(y_leaves, x_leaves, g_leaves)):
            y_comp = _compress(y[None], keys_a[:, j],
                               compress_bits)[0].to(y.dtype)
            x_half = ring_avg(y_comp)
            x_new = (x_half.to(torch.float32)
                     - lr * g.to(torch.float32)).to(x_half.dtype)
            z = (1.0 - t / 2.0) * x.to(torch.float32) \
                + (t / 2.0) * x_new.to(torch.float32)
            cz = _compress(z[None], keys_b[:, j], compress_bits)[0]
            y_new = ((1.0 - 2.0 / t) * y.to(torch.float32)
                     + (2.0 / t) * cz).to(y.dtype)
            with torch.no_grad():
                x.copy_(x_new)
                y.copy_(y_new)
        l_avg = l
        for i in axes:
            l_avg = funcol.wait_tensor(funcol.all_reduce(
                l_avg, "sum", (mesh, i))) / mesh.shape[i]
        return dict(state, step=state["step"] + 1), {"loss": l_avg}

    return step
