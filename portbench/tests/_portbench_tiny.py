"""Cells of the benchmark cut to a size the CPU tests can hold: the
port's reduced configuration of the cell's arch, in the cell's type, a
few short rows."""

import dataclasses
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench.harness import cells, compare, train  # noqa: E402


def ref_cfg(arch, dtype="float32", reduced=True, **smaller):
    """(the port's ``ArchConfig`` of ``arch``, its reduced one unless
    ``reduced`` is false, in ``dtype`` with ``smaller`` sizes; the
    reference's configuration dict of it)."""
    from repro_torch.configs.registry import get_arch
    c = get_arch(arch)
    c = dataclasses.replace(c.reduced() if reduced else c, dtype=dtype,
                            **smaller)
    out = {"arch": arch, "reference": "lm",
           "num_layers": c.num_layers, "d_model": c.d_model,
           "num_heads": c.num_heads, "num_kv_heads": c.num_kv_heads,
           "head_dim": c.resolved_head_dim, "d_ff": c.d_ff,
           "vocab_size": c.vocab_size, "rope_theta": c.rope_theta,
           "rms_norm_eps": 1e-6, "dtype": dtype,
           "tie_embeddings": c.tie_embeddings,
           "layer_pattern": list(c.layer_pattern)}
    if c.ssm is not None:
        out["ssm"] = {"state_dim": c.ssm.state_dim, "expand": c.ssm.expand,
                      "conv_width": c.ssm.conv_width, "head_dim": 64,
                      "chunk_size": c.ssm.chunk_size}
    return c, out


def tiny_cell(name, seq=32):
    """The cell ``name`` with a reduced configuration in float32 (so that
    a sound run reads far inside the cell's limits, which are set for its
    own type and size) and four rows of ``seq`` tokens."""
    cell = cells.load(name)
    arch, cfg = ref_cfg(cell.cfg["arch"], "float32", d_model=64,
                        num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
                        vocab_size=128)
    cell.cfg = cfg
    cell.traffic = dict(cell.traffic, batch=4, seq=seq, pool=4)
    return cell, arch


def tiny_run(name, seed=5):
    """A run of the cut cell on the CPU (no window: one step), its checks
    against the cell's limits."""
    cell, arch = tiny_cell(name)
    res = train.run(cell, seed, 0.0, False, "cpu", time.perf_counter(),
                    arch=arch)
    return compare.checks(res["values"], cell.limits)
