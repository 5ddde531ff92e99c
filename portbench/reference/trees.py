"""Weight trees: nested dicts and lists of tensors, their leaves in the
order the JAX package flattens them (dict entries by sorted key, list
items in order; a tuple is a leaf), each named by its path
("segments/0/block/in_proj")."""

from __future__ import annotations


def leaves(tree, prefix=""):
    """[(path, leaf)] in flattening order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves(v, f"{prefix}/{k}" if prefix else k)
    return out


def get(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tmap(fn, v) for v in tree]
    return fn(tree)
