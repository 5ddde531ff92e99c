"""Carry-across functions: the reference's state, given as numpy arrays,
turned into the port's, so tests can feed both packages identical inputs.

  :func:`dataset`  X and y (and a name) -> `data.synth.Dataset`, e.g.
                   a reference generator's output
  :func:`split`    the reference's train / valid (/ test) datasets, each
                   as an ``(X, y)`` pair -> a tuple of port datasets
  :func:`draws`    an algorithm's ``make_draws`` output -> the port's
                   draws (ECD-PSGD's per-(iteration, worker) keys become
                   the uniform noise they seed)
  :func:`model`    a model vector -> a float32 tensor
  :func:`lm_params`  the reference LM's ``init_params`` pytree -> the
                   port's ``CausalLM`` (segments unstacked into per-layer
                   blocks in layer-plan order, nested MoE subtrees,
                   zamba2's ``shared_attn``, whisper's ``pos_embed`` and
                   ``encoder`` (its stacked layers unstacked too) and
                   each decoder layer's ``cross`` and ``norm_cross``
                   included)
  :func:`lm_tree`  its inverse: a ``CausalLM`` -> the reference's pytree,
                   each segment's and the encoder's layers stacked on a
                   leading axis

The trainer uses the last two as well: its train states and checkpoints
hold the reference's leaves, and its models are views of them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch import random as R
from repro_torch.device import (DEFAULT_DEVICE, resolve_device,
                                resolve_device_or_meta)
from repro_torch.data.synth import Dataset


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype,
                        device=resolve_device(device))


def dataset(X, y, name: str = "", device=DEFAULT_DEVICE) -> Dataset:
    return Dataset(_tensor(X, torch.float32, device),
                   _tensor(y, torch.float32, device), name)


def split(*parts, device=DEFAULT_DEVICE):
    """``split((Xtr, ytr), (Xva, yva)[, (Xte, yte)])`` -> datasets."""
    tags = (":train", ":valid", ":test")
    return tuple(dataset(X, y, tag, device)
                 for (X, y), tag in zip(parts, tags))


def model(x, device=DEFAULT_DEVICE) -> torch.Tensor:
    return _tensor(x, torch.float32, device)


def draws(algorithm: str, ref_draws, d: int, device=DEFAULT_DEVICE):
    """The reference's ``make_draws`` pytree for ``algorithm`` -> the
    port's draws.  Sample indices become int64; ECD-PSGD's ``keys``
    (iters, m_top, 2) uint32 become ``u`` (iters, m_top, d), the uniform
    noise each key draws; a faulted Hogwild! or local SGD's ``{"i",
    "fault": {...}}`` becomes one flat dict, the four event masks beside
    ``"i"``."""
    if algorithm == "ecd_psgd":
        keys = _tensor(np.asarray(ref_draws["keys"]).astype(np.int64),
                       torch.int64, device)
        return {"order": _tensor(ref_draws["order"], torch.int64, device),
                "u": R.uniform(keys, (d,))}
    if algorithm in ("hogwild", "local_sgd") and isinstance(ref_draws, dict):
        return {"i": _tensor(ref_draws["i"], torch.int64, device),
                **{k: _tensor(v, torch.float32, device)
                   for k, v in ref_draws["fault"].items()}}
    if algorithm in ("minibatch", "hogwild", "dadm", "momentum", "local_sgd",
                     "async_svrg"):
        return _tensor(ref_draws, torch.int64, device)
    raise KeyError(f"no carry-across for algorithm {algorithm!r}")


def _array_tensor(a, device):
    """A numpy array (bfloat16 included) -> a tensor of the same type; a
    tensor stays itself (moved to ``device`` if it lies elsewhere)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def _set_leaf(owner, name, a, layer, device):
    """``owner[name]`` (a ``ParameterDict``) or ``owner.name`` (a module)
    becomes a parameter holding ``a`` (``a[layer]`` for a stacked leaf)."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    t = _array_tensor(a if layer is None else a[layer], device)
    old = (owner[name] if isinstance(owner, nn.ParameterDict)
           else getattr(owner, name))
    if t.shape != old.shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, port expects "
                         f"{tuple(old.shape)}")
    param = nn.Parameter(t, requires_grad=False)
    if isinstance(owner, nn.ParameterDict):
        owner[name] = param
    else:
        setattr(owner, name, param)


def _put(pdict, tree, layer, device):
    """A (nested) dict of leaves -> the parameters of ``pdict``."""
    if set(pdict.keys()) != set(tree):
        raise ValueError(f"parameter names differ: port "
                         f"{sorted(pdict.keys())}, reference {sorted(tree)}")
    for name, a in tree.items():
        if isinstance(a, dict):
            _put(pdict[name], a, layer, device)
        else:
            _set_leaf(pdict, name, a, layer, device)


# top-level subtrees a ``CausalLM`` holds as it needs them
_OPTIONAL_TOPS = ("lm_head", "pos_embed", "encoder", "shared_attn")


def _put_layers(blocks, stack, n, device):
    """A stacked subtree of ``n`` layers -> the blocks' parts, layer by
    layer; consumes ``n`` blocks of the iterator ``blocks``."""
    for layer in range(n):
        block = next(blocks)
        if set(stack) != set(block.parts):
            raise ValueError(f"block parts differ: port "
                             f"{sorted(block.parts)}, reference "
                             f"{sorted(stack)}")
        for part in block.parts:
            if isinstance(stack[part], dict):
                _put(getattr(block, part), stack[part], layer, device)
            else:
                _set_leaf(block, part, stack[part], layer, device)


def lm_params(cfg, params, device=DEFAULT_DEVICE):
    """The reference's ``models.model.init_params`` pytree, its leaves as
    numpy arrays or tensors, -> the port's ``CausalLM`` with the same
    weights.  Each segment's leading (layer) axis is unstacked into
    per-layer blocks in ``layer_plan`` order (``norm1`` with ``attn``,
    ``norm2`` and ``mlp`` or ``moe`` (and ``cross``, ``norm_cross``),
    with ``block``, or with ``down``); tied embeddings, optional QKV
    biases and the top-level ``shared_attn``, ``pos_embed`` and
    ``encoder`` (``pos``, ``final_norm`` and ``layers``, stacked as a
    segment is) follow the pytree.  Tensor leaves already on
    ``device`` are not copied: each parameter is a view of its leaf."""
    from repro_torch.models import model as M
    device = resolve_device_or_meta(device)
    lm = M.CausalLM(cfg, None, torch.device("meta"))
    want = {"embed", "final_norm", "segments"} | {
        name for name in _OPTIONAL_TOPS if hasattr(lm, name)}
    if set(params) != want:
        raise ValueError(f"top-level names differ: port {sorted(want)}, "
                         f"reference {sorted(params)}")
    _put(lm.embed, params["embed"], None, device)
    _put(lm.final_norm, params["final_norm"], None, device)
    if "lm_head" in params:
        _set_leaf(lm, "lm_head", params["lm_head"], None, device)
    for name in ("pos_embed", "shared_attn"):
        if name in params:
            _put(getattr(lm, name), params[name], None, device)
    if "encoder" in params:
        enc, tree = lm.encoder, params["encoder"]
        if set(tree) != {"pos", "layers", "final_norm"}:
            raise ValueError(f"encoder names differ: reference "
                             f"{sorted(tree)}")
        _put(enc.pos, tree["pos"], None, device)
        _put(enc.final_norm, tree["final_norm"], None, device)
        _put_layers(iter(enc.layers), tree["layers"], len(enc.layers),
                    device)
    blocks = iter(lm.blocks)
    for (_, n), stack in zip(M.segments(cfg), params["segments"]):
        _put_layers(blocks, stack, n, device)
    return lm


def lm_tree(lm, values=None, out=None):
    """A ``CausalLM`` -> the reference's ``init_params`` pytree:
    ``embed``, ``final_norm``, ``lm_head`` when untied, ``pos_embed``,
    ``encoder`` and ``shared_attn`` when the model has them, and
    ``segments``, one dict per segment of ``models.model.segments`` with
    each leaf's layers stacked on a leading axis, as the encoder's
    ``layers`` are (new memory; the other leaves are the parameters
    themselves, detached).  ``values``, a dict keyed by the port's
    parameter names (``named_parameters``), puts its tensors in the
    parameters' places: the same tree of gradients, say.  ``out``, a
    tree of that structure, receives every leaf in place and is
    returned."""
    from repro_torch.models import model as M
    if values is None:
        values = {k: v.detach() for k, v in lm.named_parameters()}

    def leaf(names, dst, stacked):
        if stacked:
            return torch.stack([values[k] for k in names], out=dst)
        if dst is None:
            return values[names[0]]
        return dst.copy_(values[names[0]])

    def walk(obj, names, dst, stacked=False):
        """The subtree of ``obj`` (a ``ParameterDict`` or a parameter),
        named ``names`` (one per stacked layer)."""
        if not isinstance(obj, nn.ParameterDict):
            return leaf(names, dst, stacked)
        return {k: walk(obj[k], [f"{n}.{k}" for n in names],
                        None if dst is None else dst[k], stacked)
                for k in obj.keys()}

    def sub(*path):
        node = out
        for k in path:
            node = None if node is None else node[k]
        return node

    def layers(prefix, block, first, n, path):
        """The stacked subtree of blocks ``first .. first + n - 1``."""
        return {part: walk(getattr(block, part),
                           [f"{prefix}.{first + j}.{part}" for j in range(n)],
                           sub(*path, part), stacked=True)
                for part in block.parts}

    tops = ["embed", "final_norm"] + [
        name for name in _OPTIONAL_TOPS
        if name != "encoder" and hasattr(lm, name)]
    tree = {name: walk(getattr(lm, name), [name], sub(name))
            for name in tops}
    if hasattr(lm, "encoder"):
        enc = lm.encoder
        tree["encoder"] = {
            name: walk(getattr(enc, name), [f"encoder.{name}"],
                       sub("encoder", name))
            for name in ("pos", "final_norm")}
        tree["encoder"]["layers"] = layers(
            "encoder.layers", enc.layers[0], 0, len(enc.layers),
            ("encoder", "layers"))
    tree["segments"], first = [], 0
    for i, (_, n) in enumerate(M.segments(lm.cfg)):
        tree["segments"].append(layers("blocks", lm.blocks[first], first, n,
                                       ("segments", i)))
        first += n
    return tree
