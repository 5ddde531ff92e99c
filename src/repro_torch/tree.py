"""Trees of tensors, flattened in the reference's order.

A tree is a dict, list or tuple of trees, None (no leaf), or a leaf (any
other object).  Leaves come in ``jax.tree.flatten``'s order: dict entries
by sorted key, lists and tuples in order.  That order decides which key ``_key_tree``
gives a leaf in the reference's gossip step, and a leaf's path is its
name in a checkpoint, so the port flattens exactly so.
"""

from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def flatten(tree):
    """(leaves in order, ``rebuild``): ``rebuild(leaves)`` makes a tree of
    ``tree``'s structure from a list of new leaves."""
    if tree is None:
        return [], lambda leaves: None
    if not isinstance(tree, (dict, list, tuple)):
        return [tree], lambda leaves: leaves[0]
    keys, parts = [], []
    for k, child in _children(tree):
        keys.append(k)
        parts.append(flatten(child))
    leaves = [x for sub, _ in parts for x in sub]

    def rebuild(new):
        out, i = [], 0
        for sub, part in parts:
            out.append(part(new[i:i + len(sub)]))
            i += len(sub)
        if isinstance(tree, dict):
            return dict(zip(sorted(tree), out))
        return type(tree)(out)

    return leaves, rebuild


def flatten_with_path(tree, prefix=""):
    """[(path, leaf)] in order; a path joins dict keys and list indices
    with "/", as the reference's checkpoint names a leaf."""
    if tree is None:
        return []
    if not isinstance(tree, (dict, list, tuple)):
        return [(prefix, tree)]
    return [item for k, child in _children(tree)
            for item in flatten_with_path(child, f"{prefix}/{k}"
                                          if prefix else k)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of the results."""
    leaves, rebuild = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return rebuild([fn(*xs) for xs in zip(leaves, *others)])
