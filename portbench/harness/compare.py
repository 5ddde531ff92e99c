"""The numbers that decide a training run's ``correct``: the program's
readings of its first (checked) steps against the reference's.

  loss_gap     the largest |loss - loss_ref| / |loss_ref| of the checked steps
  loss1_gap    the same of the first step alone (its forward pass)
  grad_gap     each leaf's gradient norm at step 1 as the update got it,
               worked out from AdamW's first moment (m = (1 - b1) g)
  change_gap   each leaf's ||w_n - w_0|| after the checked steps
  launches_off hand-written kernel launches (a sync step's path makes
               none)

A leaf's gap is |n - n_ref| / max(n_ref, the median leaf's n_ref).  A
leaf number is its worst leaf's gap, or, as ``<name>_median``, its
median leaf's: the steady reading where one small leaf is noisy by
nature (a cell's limits file names the numbers it compares, and
``PERF.md`` says why).  A change leaves out each leaf whose reference
gradient norm is under a thousandth of the median leaf's: such a leaf
moves under AdamW by rounding alone."""

from __future__ import annotations

import statistics


def leaf_gaps(prog, ref, keep=None):
    """{leaf: |n - n_ref| / max(n_ref, the median leaf's n_ref)} over the
    leaves of ``ref`` in ``keep`` (all when None)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def worst_leaves(prog, ref, keep=None, top=3):
    """[(gap, leaf, n, n_ref)] of the ``top`` worst leaves."""
    g = leaf_gaps(prog, ref, keep)
    return sorted(((v, k, prog[k], ref[k]) for k, v in g.items()),
                  reverse=True)[:top]


def moving(grad_ref):
    med = statistics.median(grad_ref.values())
    return {k for k, v in grad_ref.items() if v >= 1e-3 * med}


def gaps(prog, ref):
    """{name: (value, worst leaf or None)} of every number a cell's
    limits may name: each leaf number by its worst leaf and, as
    ``<name>_median``, by its median leaf."""
    out = {"loss_gap": (max(abs(a - b) / abs(b) for a, b in
                            zip(prog["loss"], ref["loss"])), None),
           "loss1_gap": (abs(prog["loss"][0] - ref["loss"][0])
                         / abs(ref["loss"][0]), None)}
    for name, key, keep in (("grad_gap", "grad_norm", None),
                            ("change_gap", "change",
                             moving(ref["grad_norm"]))):
        g = leaf_gaps(prog[key], ref[key], keep)
        worst = max(g, key=g.get)
        out[name] = (g[worst], worst)
        out[name + "_median"] = (statistics.median(g.values()), None)
    return out


def details(prog, ref):
    """Lines naming each leaf number's worst leaves, for the log."""
    out = [f"loss {prog['loss']} reference {ref['loss']}"]
    for name, keep in (("grad_norm", None),
                       ("change", moving(ref["grad_norm"]))):
        for g, leaf, a, b in worst_leaves(prog[name], ref[name], keep):
            out.append(f"{name} {leaf} gap {g:.3e} program {a:.6e} "
                       f"reference {b:.6e}")
    return out


def checks(values, limits):
    """{name: {"value", "limit", "ok"}} over ``limits``' names."""
    out = {}
    for name, limit in limits.items():
        v = values[name]
        out[name] = {"value": v, "limit": limit,
                     "ok": v == v and v <= limit}
    return out
