"""Collective traffic and op counts of an eager step, recorded as it runs
(the port's counterpart of ``repro/launch/hlo_stats.py``).

The reference reads its collectives out of compiled HLO text.  The port
has no HLO: :class:`CommRecorder` is a dispatch mode that sees every op a
step runs on this rank, DTensor's own collectives included (it lets
DTensor desugar first, as ``CommDebugMode`` does), and records

  * each collective: its kind (the reference's names: ``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), the bytes of its result on this rank (the
    reference's measure), and the mesh axes of its group;
  * every other op by name (``count_op``), the floating-point operations
    of the local ops ``torch.utils.flop_counter`` knows (matrix products,
    attention, convolutions), and the bytes each local op reads and
    writes (its tensor inputs and outputs; views move nothing).

The counts are of local shards, so they are per device (the fake-tensor
ops DTensor runs at global shapes to infer layouts are not counted).  Eager execution
unrolls every loop (layers, microbatches, cross-entropy chunks), so each
collective is recorded once per execution: the reference's trip-aware
variants (``collective_stats_trips``) are the plain ones here.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the reference's name of each functional collective
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _tensors(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(tree)
    return out


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


class CommRecorder(TorchDispatchMode):
    """``with CommRecorder(mesh) as rec: step(...)`` records the step's
    local ops and collectives (see the module docstring).  ``mesh`` (a
    named ``DeviceMesh``) names each collective's axes; without it they
    stay unnamed."""

    def __init__(self, mesh=None):
        super().__init__()
        self.collectives = []          # {"kind", "bytes", "axes"}
        self.ops = Counter()
        self.flops = 0
        self.bytes_accessed = 0
        self._axes = {}
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names)
            for i, name in enumerate(names):
                self._axes[mesh.get_group(i).group_name] = (name,)
            import torch.distributed as dist
            self._axes[dist.group.WORLD.group_name] = names
            from repro_torch.distributed.rules import compute_mesh
            cmesh = compute_mesh(mesh)
            if cmesh is not mesh:      # the folded (pod, data) dimension
                self._axes[cmesh.get_group(0).group_name] = names[:2]
                self._axes[cmesh.get_group(1).group_name] = names[2:]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor run its local ops
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor infers an op's output shape on fake tensors of the
            # global shape: not work any rank does
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        ns = packet._qualified_op_name.split("::")[0]
        name = packet.__name__
        self.ops[name] += 1
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _KINDS.get(name)
            if kind is not None:
                group = [a for a in args if isinstance(a, str)][-1:]
                group = group[0] if group else None
                res = _tensors(out)
                self.collectives.append({
                    "kind": kind, "bytes": _nbytes(res),
                    "axes": self._axes.get(group, ()),
                    "shape": tuple(res[0].shape) if res else ()})
            return out
        from torch.utils.flop_counter import flop_registry
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        returns = func._schema.returns
        if not (returns and returns[0].alias_info is not None):
            self.bytes_accessed += (_nbytes(_tensors((args, kwargs)))
                                    + _nbytes(_tensors(out)))
        return out


def _entries(record):
    return (record.collectives if isinstance(record, CommRecorder)
            else list(record))


def collective_stats(record) -> Dict[str, Dict[str, float]]:
    """{kind: {"count": n, "bytes": total result bytes}} over a
    :class:`CommRecorder` or a list of its entries."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "bytes": 0})
    for e in _entries(record):
        stats[e["kind"]]["count"] += 1
        stats[e["kind"]]["bytes"] += e["bytes"]
    return dict(stats)


def total_collective_bytes(record) -> int:
    return int(sum(v["bytes"] for v in collective_stats(record).values()))


def count_op(record, opname: str) -> int:
    """How many times op ``opname`` (an aten name such as ``"mm"``, or a
    collective kind such as ``"all-gather"``) ran."""
    if opname in _KINDS.values():
        return collective_stats(record).get(opname, {"count": 0})["count"]
    ops = record.ops if isinstance(record, CommRecorder) else Counter(
        e.get("op") for e in record)
    return int(ops.get(opname, 0))


def bytes_by_axes(record) -> Dict[tuple, int]:
    """Collective result bytes grouped by the mesh axes they ran over."""
    out: Dict[tuple, int] = defaultdict(int)
    for e in _entries(record):
        out[tuple(e.get("axes", ()))] += e["bytes"]
    return dict(out)


# the reference's trip-aware names: eager execution records every trip
collective_stats_trips = collective_stats
total_collective_bytes_trips = total_collective_bytes
