"""The port's FSDP/TP specs against the reference's, as tuples, leaf for
leaf: ``param_specs``, ``train_state_specs`` (sync and stale),
``batch_specs`` of every input shape (M-RoPE's (3, B, S) positions
included) and of the decode tokens, and ``decode_state_specs`` / the
serve state (shardable and not, ``enc_out``) for all ten archs at full
config, on the reference test's fake meshes at 16 x 16, the port's H100
production shape 32 x 8, and (2, 2, 2).  The reference's trees come from
``jax.eval_shape``, the port's from ``launch/specs.py`` on the meta
device.  Also ``fit_spec``'s cases of ``tests/test_sharding.py``, the MoE
expert-parallel leaf spec, the spec -> placement map, and
``launch/comm_stats.py`` over a hand-made record (the reference's
``test_hlo_stats_parser``)."""

import functools

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_arch as j_arch
from repro.distributed import rules as JR
from repro.launch import specs as JS
from repro.train.steps import train_state_specs as j_tss
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import rules as R
from repro_torch.launch import comm_stats as C
from repro_torch.launch import specs as S
from repro_torch.train.steps import train_state_specs

from _torch_threads import one_torch_thread  # noqa: F401


class _FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


MESHES = {"16x16": _FakeMesh((16, 16), ("data", "model")),
          "32x8": _FakeMesh((32, 8), ("data", "model")),
          "2x2x2": _FakeMesh((2, 2, 2), ("pod", "data", "model"))}


def _jflat(tree):
    out = []
    for path, spec in jtu.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        keys = tuple(getattr(k, "key", getattr(k, "name",
                                               getattr(k, "idx", None)))
                     for k in path)
        out.append((keys, tuple(spec)))
    return sorted(out, key=repr)


def _tflat(tree):
    out = []
    R.tree_map_with_path(lambda p, s: out.append((tuple(p), tuple(s))),
                         tree)
    return sorted(out, key=repr)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    jc, tc = j_arch(arch), get_arch(arch)
    return {
        "params": (JS.param_shapes(jc), S.param_shapes(tc)),
        "sync": (JS.train_state_shapes(jc, "sync"),
                 S.train_state_shapes(tc, "sync")),
        "stale": (JS.train_state_shapes(jc, "stale"),
                  S.train_state_shapes(tc, "stale")),
        **{f"in:{s}": (JS.input_specs(jc, J_SHAPES[s]),
                       S.input_specs(tc, INPUT_SHAPES[s]))
           for s in J_SHAPES},
        **{f"serve:{s}": (JS.serve_state_shapes(jc, J_SHAPES[s]),
                          S.serve_state_shapes(tc, INPUT_SHAPES[s]))
           for s in ("decode_32k", "long_500k")},
        **{f"tok:{s}": (JS.decode_token_specs(jc, J_SHAPES[s]),
                        S.decode_token_specs(tc, INPUT_SHAPES[s]))
           for s in ("decode_32k", "long_500k")},
    }


def _shapes_equal(j, t):
    jl = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(j)]
    tl = []
    R.tree_map_with_path(lambda p, x: tl.append(
        (tuple(x.shape), str(x.dtype).replace("torch.", ""))), t)
    return sorted(jl) == sorted(tl)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_match_reference(arch, mesh):
    m = MESHES[mesh]
    trees = _trees(arch)
    jp, tp = trees["params"]
    assert _shapes_equal(jp, tp)
    assert _tflat(R.param_specs(tp, m)) == _jflat(JR.param_specs(jp, m))
    for strategy in ("sync", "stale"):
        js, ts = trees[strategy]
        assert _tflat(train_state_specs(ts, m)) == \
            _jflat(j_tss(js, m)), strategy
    for s in J_SHAPES:
        jb, tb = trees[f"in:{s}"]
        assert _shapes_equal(jb, tb)
        assert _tflat(R.batch_specs(tb, m)) == _jflat(JR.batch_specs(jb, m))
    for s in ("decode_32k", "long_500k"):
        shardable = J_SHAPES[s].global_batch >= m.shape.get("data", 1)
        js, ts = trees[f"serve:{s}"]
        assert _shapes_equal(js, ts), s
        want = {"decode": JR.decode_state_specs(
            js["decode"], m, shardable_batch=shardable)}
        if "enc_out" in js:
            fd = JR.data_axes(m)
            want["enc_out"] = JP(fd if shardable else None, None, None)
        assert _tflat(R.serve_state_specs(
            ts, m, shardable_batch=shardable)) == _jflat(want), s
        jt, tt = trees[f"tok:{s}"]
        assert tuple(R.batch_specs({"t": tt}, m, shardable_batch=shardable)[
            "t"]) == tuple(JR.batch_specs(jt, m, shardable_batch=shardable))


def test_fit_spec_drops_nondivisible_axes():
    m = MESHES["16x16"]
    assert R.fit_spec(R.P("model", "data"), (51865, 768), m) == \
        (None, "data")
    assert R.fit_spec(R.P("model", "data"), (51872, 768), m) == \
        ("model", "data")
    assert R.fit_spec(R.P(None, "model"), (4, 4), m) == (None, None)
    for a, b in [(R.P("model", "data"), (51865, 768)),
                 (R.P(("pod", "data"), None), (6, 3))]:
        for mm in MESHES.values():
            assert tuple(R.fit_spec(a, b, mm)) == \
                tuple(JR.fit_spec(JP(*a), b, mm))


def test_leaf_spec_moe_expert_parallel():
    shapes = S.param_shapes(get_arch("arctic-480b"))
    seg = [s for s in shapes["segments"] if "moe" in s][0]
    leaf = seg["moe"]["wi_gate"]
    assert leaf.ndim == 4                       # (L, E, d, ff)
    spec = R._leaf_spec(("segments", 0, "moe", "wi_gate"), leaf, "data")
    assert spec == (None, "model", "data", None)
    assert R._leaf_spec(("segments", 0, "moe", "wo"), seg["moe"]["wo"],
                        ("pod", "data")) == (None, "model", None,
                                             ("pod", "data"))


def test_specs_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["16x16"]
    assert R.to_placements(R.P("model", "data"), m) == (Shard(1), Shard(0))
    assert R.to_placements(R.P(None, None), m) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        R.to_placements(R.P(("model", "data")), m)     # out of mesh order


def test_comm_stats_over_a_hand_made_record():
    rec = [{"kind": "all-gather", "bytes": 16 * 1024 * 2},
           {"kind": "all-reduce", "bytes": 8 * 8 * 4 + 4 * 4},
           {"kind": "collective-permute", "bytes": 128 * 4},
           {"kind": "all-reduce", "bytes": 8 * 4, "axes": ("data",)}]
    st = C.collective_stats(rec)
    assert st["all-gather"] == {"count": 1, "bytes": 16 * 1024 * 2}
    assert st["all-reduce"]["count"] == 2
    assert st["all-reduce"]["bytes"] == 8 * 8 * 4 + 4 * 4 + 8 * 4
    assert C.total_collective_bytes(rec) == sum(e["bytes"] for e in rec)
    assert C.count_op(rec, "all-reduce") == 2
    assert C.bytes_by_axes(rec) == {(): sum(e["bytes"] for e in rec[:3]),
                                    ("data",): 32}
    assert C.collective_stats_trips(rec) == st


def test_comm_recorder_counts_local_ops():
    import torch
    rec = C.CommRecorder()
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    with rec:
        (a @ b).sum()
    assert rec.flops == 2 * 4 * 8 * 3
    assert C.count_op(rec, "mm") == 1 and rec.collectives == []
    assert rec.bytes_accessed >= (32 + 24 + 12) * 4
