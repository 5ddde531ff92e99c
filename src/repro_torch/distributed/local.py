"""Explicit redistribution around the ops that DTensor's sharding
propagation does not carry (the port's counterpart of the places where
GSPMD partitions an op the reference writes plainly).

Each function here takes DTensors (on a named mesh), redistributes them
to a layout its op can run on shard by shard, runs the op on the local
shards, and wraps the result as a DTensor again; on plain tensors it is
the plain op.  Everything stays differentiable: ``redistribute``,
``to_local`` and ``from_local`` carry gradients, so a weight gathered
here gets its gradient reduce-scattered back to its own layout.

  :func:`embedding`     a sharded table looked up in place: each rank
                        looks up every token in its block of the table
                        (rows outside its vocabulary shard read 0), the
                        result a partial sum over 'model' and sharded on
                        d_model over the data axes.
  :func:`attention`     full-sequence attention, heads (or q's rows) over
                        'model', the batch over the data axes.
  :func:`replicated`,   a block whose op has no sharding rule (the SSM
  :func:`replicated_step`  chunk loops and token loops, and their decode
                        steps): its weights gathered, its activations
                        and states batch-sharded over the data axes and
                        replicated over 'model'.
  :func:`write_slot`    a decode-cache write, by the rank holding the slot.
  :func:`split_heads`,  head reshapes whose head count does not divide
  :func:`merge_heads`   the axes sharding them (gathered first).
MoE dispatch has its own region (``models.moe._moe_mesh``: experts on
'model').
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _names(mesh):
    return tuple(mesh.mesh_dim_names)


def batch_placements(mesh, shape, dim=0):
    """Dimension ``dim`` (the batch) sharded over the data axes when it
    divides them (and they hold more than one rank), replicated over
    every other axis."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.rules import FSDP_AXES
    sizes = dict(zip(_names(mesh), mesh.shape))
    n = 1
    for a in FSDP_AXES:
        n *= sizes.get(a, 1)
    ok = n > 1 and shape[dim] % n == 0
    return tuple(Shard(dim) if ok and name in FSDP_AXES else Replicate()
                 for name in _names(mesh))


def replicate(x):
    """A DTensor replicated on every mesh dimension (gathered)."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          (Replicate(),) * x.device_mesh.ndim)


def grad_placements(w_pl, act_pl):
    """A gathered weight's gradient layout: partial sums over the axes
    its activations are sharded on, its own placement elsewhere."""
    from torch.distributed.tensor import Partial, Shard
    return tuple(Partial() if isinstance(a, Shard) else w
                 for w, a in zip(w_pl, act_pl))


def _local_tree(tree, fn):
    if isinstance(tree, dict) or hasattr(tree, "items"):   # ParameterDict
        return {k: _local_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local_tree(v, fn) for v in tree)
    return fn(tree)


def replicated(fn, weights, *acts, mesh, n_out=1):
    """``fn(weights, *acts)`` on local shards: every DTensor leaf of
    ``weights`` gathered (replicated), each activation (all of one batch
    size) batch-sharded (:func:`batch_placements`) and replicated over
    'model'; the first ``n_out`` outputs come back batch-sharded in the
    same way, the others pass through."""
    from torch.distributed.tensor import DTensor, Replicate
    act_pl = batch_placements(mesh, acts[0].shape, 0)
    a_local = [a.redistribute(mesh, act_pl).to_local() if is_dtensor(a)
               else a for a in acts]
    w_grad = grad_placements((Replicate(),) * mesh.ndim, act_pl)
    w_local = _local_tree(
        weights, lambda w: replicate(w).to_local(grad_placements=w_grad)
        if is_dtensor(w) else w)
    out = fn(w_local, *a_local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = [DTensor.from_local(o, mesh, act_pl, run_check=False)
               if i < n_out else o for i, o in enumerate(outs)]
    return tuple(wrapped) if isinstance(out, tuple) else wrapped[0]


def embedding(tokens, table):
    """``F.embedding(tokens, table)``; for a DTensor table each rank
    looks up every token (the tokens gathered: a few bytes) in the block
    of the table it holds.  Rows outside its vocabulary shard read 0, so
    the result is ``Partial`` over the axes sharding the vocabulary and
    sharded over those sharding d_model: no weight moves.  (The table's
    FSDP shard is never gathered, as the reference's sharded take does
    not gather it.)"""
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    rep = (Replicate(),) * mesh.ndim
    if is_dtensor(tokens):
        tok = tokens.redistribute(mesh, rep).to_local()
    else:
        tok = tokens
    tl = table.to_local()
    rows, off = tl.shape[0], 0
    out_pl = []
    for i, pl in enumerate(table.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            off = off * mesh.shape[i] + mesh.get_local_rank(i)
            out_pl.append(Partial())
        elif isinstance(pl, Shard):
            out_pl.append(Shard(tok.ndim))
        else:
            out_pl.append(Replicate())
    off *= rows
    ids = tok - off
    ok = (ids >= 0) & (ids < rows)
    out = F.embedding(ids.clamp(0, rows - 1), tl)
    out = out * ok[..., None].to(out.dtype)
    return DTensor.from_local(out, mesh, tuple(out_pl), run_check=False)


def replicated_step(fn, weights, x, state):
    """A decode step ``fn(weights, x, state) -> (y, new state)`` whose
    ``state`` is a dataclass of tensors laid out by
    ``rules.decode_state_specs``: weights gathered, ``x`` and every state
    tensor batch-sharded over the data axes (gathered over 'model') for
    the step, and the new state's tensors laid out as the old ones were
    (over 'model' a local slice, no transfer)."""
    import dataclasses
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    fields = [f.name for f in dataclasses.fields(state)
              if is_dtensor(getattr(state, f.name))]
    layouts = {f: getattr(state, f).placements for f in fields}

    def run(w, x_, *tensors):
        st = dataclasses.replace(state, **dict(zip(fields, tensors)))
        y, new = fn(w, x_, st)
        return (y,) + tuple(getattr(new, f) for f in fields)

    outs = replicated(run, weights, x,
                      *(getattr(state, f) for f in fields), mesh=mesh,
                      n_out=1 + len(fields))
    y, tensors = outs[0], outs[1:]
    new = dataclasses.replace(state, **{
        f: t.redistribute(mesh, layouts[f]) for f, t in zip(fields, tensors)})
    return y, new


def write_slot(buf, slot: int, value):
    """``buf[:, slot] = value`` in place.  For a DTensor ``buf`` (a cache
    laid out by ``rules.decode_state_specs``) the rank holding slot
    ``slot`` of dimension 1 writes its part of ``value`` (a DTensor, a
    tensor or a number) into its shard."""
    if not is_dtensor(buf):
        buf[:, slot] = value
        return buf
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = buf.device_mesh, buf.placements
    local = buf.to_local()
    off = 0
    for i, q in enumerate(pl):
        if isinstance(q, Shard) and q.dim == 1:
            off = off * mesh.shape[i] + mesh.get_local_rank(i)
    off *= local.shape[1]
    if is_dtensor(value):
        v_pl = tuple(Replicate() if isinstance(q, Shard) and q.dim == 1
                     else Shard(q.dim - 1) if isinstance(q, Shard)
                     and q.dim > 1 else q for q in pl)
        value = value.redistribute(mesh, v_pl).to_local()
    if off <= slot < off + local.shape[1]:
        local[:, slot - off] = value
    return buf


def split_heads(x, *shape):
    """``x.reshape(*shape)`` splitting the last dimension into (heads,
    head_dim); on a DTensor whose last dimension is sharded over axes
    that do not divide the head count (gemma3's 4 heads on 8-wide
    'model'), those axes are gathered first (GSPMD pads instead)."""
    return split_dim(x, x.ndim - 1, shape[-2], shape)


def split_dim(x, dim, first, shape):
    """``x.reshape(*shape)`` where dimension ``dim`` splits into (first,
    ...); on a DTensor the axes sharding ``dim`` are gathered first unless
    they divide ``first``."""
    if is_dtensor(x):
        x = _gather_uneven(x, dim, first)
    return x.reshape(*shape)


def _gather_uneven(x, dim, parts):
    """``x`` with dimension ``dim`` gathered on every axis, if the axes
    sharding it do not divide ``parts``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    n = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            n *= mesh.shape[i]
    if parts % n == 0:
        return x
    return x.redistribute(mesh, tuple(
        Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
        for pl in x.placements))


class _HeadsGrad(torch.autograd.Function):
    """Identity whose gradient (a DTensor) gets its last dimension
    gathered when its sharding does not divide ``heads``."""

    @staticmethod
    def forward(ctx, x, heads):
        ctx.heads = heads
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            g = _gather_uneven(g, g.ndim - 1, ctx.heads)
        return g, None


def merge_heads(x, *shape):
    """``x.reshape(*shape)`` merging (heads, head_dim) into the last
    dimension; on a DTensor the gradient coming back into the merge is
    laid out so that it splits into the heads again (the backward
    counterpart of :func:`split_heads`)."""
    y = x.reshape(*shape)
    if not is_dtensor(y):
        return y
    return _HeadsGrad.apply(y, x.shape[-2])


def attention(fn, q, k, v, mask):
    """``fn(q, k, v, mask)`` (full-sequence attention, q (B, S, H, D), k
    and v (B, T, KV, D)) on local shards: the batch over the data axes,
    and over 'model' the heads when both head counts divide it, else q's
    rows when S divides it (k and v gathered: q-row-parallel, the
    reference's choice when heads do not divide 'model'), else nothing.
    A row-parallel rank's k and v gradients are partial sums over
    'model'."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = q.device_mesh
    names = _names(mesh)
    B, S, H, _ = q.shape
    KV = k.shape[2]
    base = batch_placements(mesh, q.shape, 0)
    mi = names.index("model") if "model" in names else None
    n = mesh.shape[mi] if mi is not None else 1
    q_dim = kv_dim = None
    if n > 1 and H % n == 0 and KV % n == 0:
        q_dim = kv_dim = 2
    elif n > 1 and S % n == 0:
        q_dim = 1

    def pl(dim, partial=False):
        return tuple((Shard(dim) if dim is not None else
                      Partial() if partial else p) if i == mi else p
                     for i, p in enumerate(base))

    ql = q.redistribute(mesh, pl(q_dim)).to_local()
    kv_grad = pl(kv_dim, partial=q_dim == 1)
    kl = k.redistribute(mesh, pl(kv_dim)).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, pl(kv_dim)).to_local(grad_placements=kv_grad)
    if mask is not None:
        if is_dtensor(mask):
            m_pl = (base if mask.shape[0] == B else
                    batch_placements(mesh, (1,), 0))
            mask = mask.redistribute(mesh, pl(None) if mask.shape[0] == B
                                     else m_pl).to_local()
        if q_dim == 1 and mask.shape[-2] == S:
            rows = S // n
            off = mesh.get_local_rank(mi) * rows
            mask = mask[..., off:off + rows, :]
    out = fn(ql, kl, vl, mask)
    return DTensor.from_local(out, mesh, pl(q_dim), run_check=False)


def _seq_axes(k, dim=1):
    """The mesh dimensions sharding ``k``'s sequence dimension."""
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(k.placements)
            if isinstance(p, Shard) and p.dim == dim]


def sequence_sharded(k, dim=1) -> bool:
    """True for a DTensor whose sequence dimension ``dim`` is sharded (a
    decode cache laid out by ``rules.decode_state_specs``)."""
    return is_dtensor(k) and bool(_seq_axes(k, dim))


def _all_reduce(x, op, mesh, dims):
    import torch.distributed._functional_collectives as funcol
    for i in dims:
        x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, i)))
    return x


def _local_chunk(t, mesh, placements):
    """This rank's block of ``t`` (a tensor holding the global value) under
    ``placements``, cut without communication."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(mesh.shape[i], dim=p.dim)[mesh.get_local_rank(i)]
    return t


def sequence_attention(qs, keys, values, mask, score_fn, out_fn, scale):
    """Decode attention against caches sharded on their sequence (the
    reference's sequence-parallel decode): each rank scores the queries
    ``qs`` (a tuple) against its own slots, the softmax's max and sum are
    all-reduced over the axes sharding the sequence, and each rank's
    weighted sum of its values is summed over them.  ``keys`` / ``values``
    are the caches (DTensors, sequence on dimension 1); ``mask`` (a
    DTensor laid out as the caches, or a tensor broadcastable to the
    scores) or None; ``score_fn(qs_local, *keys_local)`` gives float32
    scores (..., T_local) and ``out_fn(w, *values_local)`` the output from
    weights ``w`` (in the values' type, as the reference casts them).
    Returns the caches' batch layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ref = keys[0]
    mesh = ref.device_mesh
    t_dims = _seq_axes(ref)
    b_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                 else Replicate() for p in ref.placements)
    ql = tuple(q.redistribute(mesh, b_pl).to_local() if is_dtensor(q)
               else q for q in qs)
    kl = [k.redistribute(mesh, ref.placements).to_local() for k in keys]
    vl = [v.redistribute(mesh, ref.placements).to_local() for v in values]
    scores = score_fn(ql, *kl) / scale
    if mask is not None:
        m_pl = tuple(Shard(mask.ndim - 1) if i in t_dims else
                     p if mask.shape[0] > 1 else Replicate()
                     for i, p in enumerate(b_pl))
        ml = (mask.redistribute(mesh, m_pl).to_local() if is_dtensor(mask)
              else _local_chunk(mask, mesh, m_pl))
        scores = torch.where(ml, scores, torch.full_like(scores, -1e30))
    mx = _all_reduce(torch.amax(scores, dim=-1, keepdim=True), "max",
                     mesh, t_dims)
    e = torch.exp(scores - mx)
    w = e / _all_reduce(torch.sum(e, dim=-1, keepdim=True), "sum", mesh,
                        t_dims)
    dtype = vl[0].dtype
    out = out_fn(w.to(dtype).to(torch.float32),
                 *(v.to(torch.float32) for v in vl))
    out = _all_reduce(out, "sum", mesh, t_dims).to(dtype)
    return DTensor.from_local(out, mesh, b_pl, run_check=False)


def matmul(x, w):
    """``x @ w``.  For a DTensor activation sharded on both leading
    dimensions (batch over the data axes and sequence over 'model': the
    residual stream under ``rules.act_constraint``, or a block input the
    reference's ``inner_act_constraint`` keeps sequence-sharded), which
    DTensor (torch 2.11) cannot flatten into a matrix product, the product
    runs on x's local rows against the whole weight, gathered: what the
    reference's compiler does there ("all-gathering FULL weight
    matrices").  The weight's gradient is a partial sum over those axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not is_dtensor(x) or x.ndim < 3:
        return x @ w
    dims = {p.dim for p in x.placements if isinstance(p, Shard)}
    if not {0, 1} <= dims:
        return x @ w
    mesh = x.device_mesh
    last = x.ndim - 1
    x_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
                 else p for p in x.placements)
    xl = x.redistribute(mesh, x_pl).to_local()
    if is_dtensor(w):
        w_grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                       for p in x_pl)
        w = replicate(w).to_local(grad_placements=w_grad)
    return DTensor.from_local(xl @ w, mesh, x_pl, run_check=False)
