"""The model stack's FSDP/TP partition rules as DTensor placements (the
port of ``repro/distributed/rules.py``).

A spec is a :class:`P`: one entry per tensor dimension, each ``None``
(replicated), a mesh axis name, or a tuple of names (the dimension split
over several axes, the first one major).  :func:`to_placements` turns it
into the ``Shard``/``Replicate`` placements of a DTensor on a named
``torch.distributed.device_mesh.DeviceMesh``; ``DTensor.redistribute`` to
those placements is the port's ``with_sharding_constraint``.

Layout (the reference's):
  * FSDP:  parameters and optimizer state sharded over ('pod', 'data') on
    the d_model-like dimension; gradients reduce over the same axes.
  * TP:    heads / ffn-hidden / experts sharded over 'model'.
  * batch: ('pod', 'data'); KV-cache sequence dimension: 'model'; SSM
    heads: 'model'.

Rules are name-based over the reference's parameter pytree (the port's
train states hold it, :func:`repro_torch.interop.lm_tree`): stacked
segment leaves carry a leading layer axis that is never sharded.  A
dimension that does not divide its axes' size is left replicated
(:func:`fit_spec`): a DTensor shards unevenly, but the reference's jit
boundary does not, and the port keeps the reference's specs.

Every function takes a mesh as a torch ``DeviceMesh`` with named
dimensions or as any object with ``axis_names`` and ``devices`` (the
reference tests' fake mesh): specs need only the axis names and sizes.
"""

from __future__ import annotations

from typing import Any

FSDP_AXES = ("pod", "data")     # collapsed to just ('data',) on 1-pod meshes


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_names(mesh):
    """The mesh's axis names, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh):
    """{axis name: size}."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def data_axes(mesh) -> Any:
    """The data-parallel (FSDP/batch) mesh axes present in `mesh`."""
    names = axis_names(mesh)
    ax = tuple(a for a in FSDP_AXES if a in names)
    return ax if len(ax) > 1 else (ax[0] if ax else None)


def data_axis_tuple(mesh):
    """:func:`data_axes` as a tuple (empty without one)."""
    fd = data_axes(mesh)
    return fd if isinstance(fd, tuple) else (() if fd is None else (fd,))


# name -> spec over the *unstacked* weight dims.
# FD = fsdp axes placeholder, substituted at call time.
_FD = "__FSDP__"

_RULES_2D = {
    # (in, out) projections: shard in-dim on FSDP, out-dim on model
    "wq": (_FD, "model"), "wk": (_FD, "model"), "wv": (_FD, "model"),
    "wi": (_FD, "model"), "wi_gate": (_FD, "model"), "wi_up": (_FD, "model"),
    "wq_a": (_FD, None), "wq_b": (_FD, "model"),
    "wkv_a": (_FD, None), "wk_rope": (_FD, None),
    "wk_b": (_FD, "model"), "wv_b": (_FD, "model"),
    "in_proj": (_FD, "model"), "w_if": (_FD, None), "wz": (_FD, "model"),
    "w_in": (_FD, "model"), "w_concat": (_FD, "model"),
    "router": (_FD, None),
    "lm_head": (_FD, "model"),
    # output projections: shard in-dim on model, out-dim on FSDP
    "wo": ("model", _FD), "out_proj": ("model", _FD), "down": ("model", _FD),
    # embeddings
    "table": ("model", _FD),
    "pos": (None, _FD),
    # depthwise conv (W, C): channels on model
    "conv_w": (None, "model"),
    # sLSTM recurrent mixer (H, hd, 4hd): small; replicate
    "r": (None, None, None),
}

# 3D MoE expert banks (E, d, ff)/(E, ff, d): experts on model, d on FSDP
_RULES_MOE = {
    "wi_gate": ("model", _FD, None),
    "wi_up": ("model", _FD, None),
    "wo": ("model", None, _FD),
}


def _axis_size(shape_of, ax):
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= shape_of.get(a, 1)
        return n
    return shape_of.get(ax, 1)


def fit_spec(spec, shape, mesh):
    """Drop the axes of every dimension they do not divide (the
    reference's jit boundary requires divisibility)."""
    shape_of = mesh_shape(mesh)
    out = []
    for i, ax in enumerate(spec):
        if i >= len(shape):
            break
        size = _axis_size(shape_of, ax)
        out.append(ax if (size > 1 and shape[i] % size == 0) or size == 1
                   else None)
    return P(*out)


def _leaf_spec(path, leaf, fd):
    """The rule for one parameter leaf; ``path`` is its keys from the
    root (dict keys as strings, list indices as ints)."""
    keys = list(path)
    name = keys[-1]
    stacked = "segments" in keys or "layers" in keys
    base_ndim = leaf.ndim - (1 if stacked else 0)
    in_moe = "moe" in keys

    if base_ndim <= 1:
        spec = (None,) * base_ndim
    elif in_moe and name in _RULES_MOE and base_ndim == 3:
        spec = _RULES_MOE[name]
    elif name in _RULES_2D and base_ndim == len(_RULES_2D[name]):
        spec = _RULES_2D[name]
    elif name in _RULES_2D and base_ndim == 2:
        spec = _RULES_2D[name][:2]
    else:
        spec = (None,) * base_ndim
    spec = tuple(fd if s == _FD else s for s in spec)
    if stacked:
        spec = (None,) + spec
    return P(*spec)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (and the port's
    cache dataclasses, by field), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params_tree, mesh):
    fd = data_axes(mesh)
    return tree_map_with_path(
        lambda p, x: fit_spec(_leaf_spec(p, x, fd), x.shape, mesh),
        params_tree)


def opt_state_specs(opt_state_tree, param_spec_tree):
    """Adam m/v mirror the param sharding; scalar counts replicate."""
    return {"m": param_spec_tree, "v": param_spec_tree, "count": P()}


def batch_specs(batch_tree, mesh, *, shardable_batch=True):
    """Inputs: batch dim over data axes (when divisible), rest replicated."""
    fd = data_axes(mesh)

    def f(_, leaf):
        if leaf.ndim == 0:
            return P()
        if not shardable_batch:
            return P(*([None] * leaf.ndim))
        if leaf.ndim == 3 and leaf.shape[0] == 3:     # M-RoPE (3, B, S)
            spec = P(None, fd, *([None] * (leaf.ndim - 2)))
        else:
            spec = P(fd, *([None] * (leaf.ndim - 1)))
        return fit_spec(spec, leaf.shape, mesh)

    return tree_map_with_path(f, batch_tree)


def decode_state_specs(state_tree, mesh, *, shardable_batch=True):
    """KV caches: (L, B, T, ...) -> batch on data axes, seq/heads on model.

    When the batch is not shardable (long_500k, B=1) the sequence dim is
    sharded over *both* data and model axes.
    """
    fd = data_axes(mesh)
    seq_ax = "model" if shardable_batch else (
        (fd + ("model",)) if isinstance(fd, tuple) else (fd, "model"))
    b_ax = fd if shardable_batch else None

    def f(path, leaf):
        name = path[-1] if path else None
        if name == "position" or leaf.ndim <= 1:
            return P()
        # all cache leaves carry leading (L, B, ...) dims
        if name in ("k", "v"):            # (L,B,T,KV,D)
            spec = P(None, b_ax, seq_ax, None, None)
        elif name == "pos":               # (L,B,T)
            spec = P(None, b_ax, seq_ax)
        elif name in ("c_kv", "k_rope"):  # (L,B,T,r)
            spec = P(None, b_ax, seq_ax, None)
        elif name == "conv":              # (L,B,W-1,C)
            spec = P(None, b_ax, None, "model")
        elif name == "ssm":               # (L,B,H,hd,N)
            spec = P(None, b_ax, "model", None, None)
        elif name == "C":                 # (L,B,H,hd,hd)
            spec = P(None, b_ax, "model", None, None)
        elif name in ("n", "c", "m", "h"):  # (L,B,H,hd)
            spec = P(None, b_ax, "model", None)
        elif name == "index":             # (L,)
            spec = P(None)
        else:
            spec = P(*([None] * leaf.ndim))
        return fit_spec(spec, leaf.shape, mesh)

    return tree_map_with_path(f, state_tree)


def serve_state_specs(state_tree, mesh, *, shardable_batch=True):
    """A serve state's specs, as the reference's dry run lays it out: the
    decode caches by :func:`decode_state_specs`, ``enc_out`` with its
    batch over the data axes when the batch is shardable."""
    specs = {"decode": decode_state_specs(state_tree["decode"], mesh,
                                          shardable_batch=shardable_batch)}
    if "enc_out" in state_tree:
        fd = data_axes(mesh)
        specs["enc_out"] = P(fd if shardable_batch else None, None, None)
    return specs


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

_COMPUTE = {}


def compute_mesh(mesh):
    """The mesh the DTensors of a model-stack mesh live on.  A (pod,
    data, model) mesh is folded to (data, model), pod major: the spec
    entry ("pod", "data") is one dimension there, split over the same
    ranks in the same order, and DTensor's search for an op's layout
    grows steeply with the mesh's rank (a 3-D mesh makes it minutes per
    op).  Any other mesh is itself.  Folding builds process groups, so
    every rank calls it at the same point (the first time a mesh is
    used)."""
    names = axis_names(mesh)
    if "pod" not in names:
        return mesh
    key = id(mesh)
    if key not in _COMPUTE:
        from torch.distributed.device_mesh import DeviceMesh as _Mesh
        if names != ("pod", "data", "model"):
            raise ValueError(f"mesh axes {names}: expected (pod, data, "
                             f"model)")
        ranks = mesh.mesh
        folded = _Mesh(mesh.device_type,
                       ranks.reshape(-1, ranks.shape[-1]),
                       mesh_dim_names=("data", "model"))
        _COMPUTE[key] = (mesh, folded)
    return _COMPUTE[key][1]


def to_placements(spec, mesh):
    """A spec -> one placement per dimension of :func:`compute_mesh`:
    ``Shard(i)`` on every axis that tensor dimension ``i`` names,
    ``Replicate()`` elsewhere.  A dimension split over several axes is
    ``Shard(i)`` on each, the first one major, as mesh order gives it;
    ("pod", "data") is the folded 'data' dimension of a 3-D mesh.  An
    axis of size 1 splits nothing: its placement is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    fold = "pod" in names
    cnames = ("data", "model") if fold else names
    out = [Replicate()] * len(cnames)
    for i, ax in enumerate(spec):
        axes = ax if isinstance(ax, tuple) else (() if ax is None else (ax,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes of dimension {i} out of "
                             f"mesh order {names}")
        if fold and ("pod" in axes) != ("data" in axes):
            raise ValueError(f"spec {spec}: 'pod' and 'data' split one "
                             f"dimension together")
        for a in axes:
            j = cnames.index("data" if a == "pod" else a)
            if sizes[a] > 1 or (fold and a in ("pod", "data") and
                                sizes["pod"] * sizes["data"] > 1):
                out[j] = Shard(i)
    return tuple(out)


def place(x, spec, mesh):
    """``x`` (a DTensor or a tensor holding the global value on every
    rank) as a DTensor laid out by ``spec``: the port's
    ``with_sharding_constraint``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = to_placements(spec, mesh)
    cmesh = compute_mesh(mesh)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(cmesh, pl)
    return distribute_tensor(x, cmesh, pl)


def place_tree(tree, specs, mesh):
    """:func:`place` leaf by leaf over a tree and its spec tree."""
    from repro_torch import tree as T
    leaves, rebuild = T.flatten(tree)
    spec_leaves = _spec_leaves(specs)
    return rebuild([place(x, s, mesh) for x, s in zip(leaves, spec_leaves)])


def _spec_leaves(specs):
    """The specs of a spec tree in the port's flatten order."""
    out = []

    def walk(t):
        if isinstance(t, P):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for v in t:
                walk(v)
    walk(specs)
    return out


# ---------------------------------------------------------------------------
# Constraint hooks
# ---------------------------------------------------------------------------

def layer_constraint(mesh):
    """The hook applied to one layer's parameters: each leaf pinned to its
    unstacked rule (paths inside a layer lack 'segments').  The gradient
    flowing back through the redistribute is pinned with it, so each
    layer's gradient is reduce-scattered to the FSDP layout."""
    fd = data_axes(mesh)

    def constrain(tree):
        return tree_map_with_path(
            lambda p, x: place(x, fit_spec(_leaf_spec(p, x, fd), x.shape,
                                           mesh), mesh), tree)

    return constrain


def logits_constraint(mesh):
    """CE chunk logits (B, c, V): vocab on 'model'."""
    fd = data_axes(mesh)

    def constrain(logits):
        return place(logits, P(fd, None, "model"), mesh)

    return constrain


def head_constraint(mesh):
    """LM head weight for the CE chunks: vocab on 'model', d replicated —
    gathered once per step instead of once per chunk."""
    def constrain(w):
        v_first = w.shape[0] > w.shape[1]      # (V, d) tied vs (d, V) head
        spec = P("model", None) if v_first else P(None, "model")
        return place(w, spec, mesh)
    return constrain


def decode_act_constraint(mesh):
    """Decode-time h pin: d_model sharded over the data axes (batch
    replicated), so the (B, 1, d) activation contracts against the FSDP
    weight shard locally (a partial product and a small all-reduce)
    instead of gathering the weights every decoded token."""
    fd = data_axes(mesh)

    def constrain(h):
        if h.ndim == 3 and h.shape[-1] % 2 == 0:
            return place(h, P(None, None, fd), mesh)
        return h
    return constrain


def act_constraint(mesh, *, seq_shard=True):
    """The sequence-parallel activation pin (B on data, S on model)."""
    fd = data_axes(mesh)

    def constrain(h):
        if h.ndim == 3 and seq_shard and h.shape[1] > 1:
            return place(h, P(fd, "model", None), mesh)
        return h

    return constrain


def inner_act_constraint(mesh, *, seq_shard=True, cfg=None):
    """Megatron-SP block-entry pin: gather the sequence dimension so
    'model' is free for TP (heads / d_ff / experts) inside the block;
    block outputs (kind ``"residual"``) pinned replicated over 'model'.

    Heads-aware: when the head count does not divide 'model', the
    attention input keeps its sequence sharding (q-row-parallel attention
    against gathered k/v); the MLP side gathers only when d_ff divides
    'model'."""
    fd = data_axes(mesh)
    n_model = mesh_shape(mesh).get("model", 1)
    attn_gather = True
    mlp_gather = True
    if cfg is not None:
        attn_gather = cfg.num_heads % n_model == 0
        mlp_gather = (cfg.d_ff % n_model == 0) if cfg.d_ff else False

    def constrain(x, kind="attn"):
        if x.ndim != 3 or not seq_shard or x.shape[1] <= 1:
            return x
        if kind == "residual":
            spec = P(fd, None, None)
        else:
            gather = attn_gather if kind == "attn" else mlp_gather
            spec = P(fd, None, None) if gather else P(fd, "model", None)
        return place(x, spec, mesh)

    return constrain
