"""Checkpoints in the reference's on-disk format (the port of
``repro/train/checkpoint.py``): a directory with one ``.npy`` per leaf and
a ``manifest.json`` of ``{"step", "leaves": [{"key", "file", "dtype"}]}``,
leaves named by their path in the tree, in the reference's order.

A ``CausalLM`` inside the tree is written as the reference's parameter
pytree (:func:`repro_torch.interop.lm_tree`, segments stacked), so a
checkpoint written by either package restores in the other.  bfloat16
leaves, which numpy has no type for, are written as the reference writes
them through ``ml_dtypes``: 2-byte records with the header descr
``'<V2'`` and manifest dtype ``"bfloat16"``, the bits of the tensor's
16-bit view; they are read back by viewing the bytes as bfloat16.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch import interop
from repro_torch import tree as T
from repro_torch.models.model import CausalLM


def _as_tree(tree):
    """``tree`` with every CausalLM replaced by the reference's pytree."""
    if isinstance(tree, CausalLM):
        return interop.lm_tree(tree)
    if isinstance(tree, dict):
        return {k: _as_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tree(v) for v in tree)
    return tree


def _save_leaf(fname, t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        arr = t.numpy()
        np.save(fname, arr)
        return str(arr.dtype)
    with open(fname, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(t.shape)})
        f.write(t.view(torch.int16).numpy().tobytes())
    return "bfloat16"


def _load_leaf(fname, dtype, device):
    arr = np.load(fname)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save_checkpoint(path, tree, step=0):
    os.makedirs(path, exist_ok=True)
    manifest = {"step": int(step), "leaves": []}
    for key, leaf in T.flatten_with_path(_as_tree(tree)):
        fname = re.sub(r"[^A-Za-z0-9_/.-]", "_", key).replace("/", "__")
        dtype = _save_leaf(os.path.join(path, fname + ".npy"), leaf)
        manifest["leaves"].append({"key": key, "file": fname + ".npy",
                                   "dtype": dtype})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def restore_checkpoint(path, tree_like):
    """Restores into the structure of ``tree_like`` (shapes must match),
    each leaf on its ``tree_like`` leaf's device, in the stored type; a
    ``CausalLM`` comes back as a new ``CausalLM``.  Returns (tree, step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}

    def restore(like, prefix):
        if isinstance(like, CausalLM):
            dev = like.embed["table"].device
            return interop.lm_params(like.cfg, restore(
                interop.lm_tree(like), prefix), dev)
        if isinstance(like, (dict, list, tuple)):
            leaves, rebuild = T.flatten(like)
            paths = [p for p, _ in T.flatten_with_path(like, prefix)]
            return rebuild([restore(x, p) for x, p in zip(leaves, paths)])
        entry = by_key[prefix]
        t = _load_leaf(os.path.join(path, entry["file"]), entry["dtype"],
                       like.device)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{prefix}: checkpoint shape {tuple(t.shape)}, "
                             f"expected {tuple(like.shape)}")
        return t

    return restore(tree_like, ""), manifest["step"]
