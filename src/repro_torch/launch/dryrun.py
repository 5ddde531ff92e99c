"""Dry run: every (arch x input shape) step on the production mesh, with
no device executing anything (the port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each step on 512 virtual devices.  The
port starts a fake process group of 256 ranks (512 with
``--multi-pod``) in its own process, builds the step for the pair's mode
(train, prefill or decode) on ``meta`` tensors laid out by the
reference's rules (``distributed.rules``), and runs it once as rank 0:
DTensor propagates every layout, its collectives go to the
fake group (which moves nothing), and :class:`launch.comm_stats.
CommRecorder` records what rank 0 would compute and send.  A layout that
does not compose, or an op with no way to run sharded, fails here.

Reported per device: the floating-point operations of the local shards,
the argument bytes (the local shards of parameters, state and inputs),
the bytes the unfused eager ops read and write, the collective schedule
(kind, count, result bytes, from ``comm_stats``), and three time terms
on H100 constants: compute (dense bf16 peak), memory (HBM) and
collective (NVLink for the 'model' axis, which lies inside one 8-GPU
node; the network for the data axes).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --layers 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_arch, pair_supported
from repro_torch.distributed import rules as RU
from repro_torch.launch import comm_stats
from repro_torch.launch import specs as S

# H100 SXM constants for the time terms
PEAK_FLOPS = 989e12      # dense bf16 FLOP/s (H100 SXM datasheet)
HBM_BW = 3.35e12         # bytes/s of HBM3 (H100 SXM datasheet)
# NVLink 4: 900 GB/s per GPU both ways together (18 links x 50 GB/s),
# 450 GB/s each way (H100 SXM datasheet); the 'model' axis lies in a node
NVLINK_BW = 450e9
# one 400 Gb/s NDR InfiniBand adapter per GPU (ConnectX-7, DGX H100):
# 50 GB/s each way; the data axes cross nodes
NET_BW = 50e9

META = torch.device("meta")


def start_fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0:
    collectives are accepted and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is already "
                               f"in force, not {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def arch_for_pair(arch_id, shape_name):
    if arch_id == "qwen2.5-3b" and shape_name == "long_500k":
        from repro_torch.configs.qwen2_5_3b import SLIDING_VARIANT
        return SLIDING_VARIANT
    return get_arch(arch_id)


def cut_depth(cfg, layers: int):
    """``cfg`` with its first ``layers`` layers, or the shortest prefix of
    its layer plan that holds every kind of layer it has, whichever is
    longer; 0 keeps the full depth."""
    if not layers or layers >= cfg.num_layers:
        return cfg
    from repro_torch.models.model import layer_plan
    plan = layer_plan(cfg)
    kinds, need = set(plan), 0
    seen = set()
    for i, spec in enumerate(plan):
        if spec not in seen:
            seen.add(spec)
            need = i + 1
        if seen == kinds:
            break
    return dataclasses.replace(cfg, num_layers=max(layers, need))


@dataclasses.dataclass
class Lowered:
    """A step and its meta arguments, laid out on the mesh: the port's
    counterpart of a lowered computation.  ``run()`` executes it once."""
    fn: object
    args: tuple
    placed: list           # the DTensor arguments (argument bytes)

    def run(self):
        return self.fn(*self.args)


def _dtensors(tree):
    """The DTensors of a tree of dicts, lists, tuples and dataclasses."""
    from torch.distributed.tensor import DTensor
    out = []

    def walk(x):
        if isinstance(x, DTensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def lower_pair(arch_id, shape_name, mesh, *, strategy="sync", seq_shard=True,
               donate=True, microbatches=4, layers=0):
    """Returns (lowered, meta) for the right step kind for this shape.
    ``layers`` cuts the depth (:func:`cut_depth`); ``donate`` is the
    reference's argument and has no effect (eager steps update their
    state in place)."""
    from repro_torch.models import model as M
    cfg = cut_depth(arch_for_pair(arch_id, shape_name), layers)
    shape = INPUT_SHAPES[shape_name]
    batch = S.input_specs(cfg, shape)
    lm = M.init_params(cfg, device=META)

    if shape.mode == "train":
        from repro_torch.train import steps as TS
        step = TS.make_train_step(
            cfg, mesh, strategy=strategy, remat=True, seq_shard=seq_shard,
            microbatches=microbatches,
            grad_accum_dtype=getattr(torch, os.environ.get(
                "REPRO_GRAD_ACCUM_DTYPE", "float32")),
            accum_mode=os.environ.get("REPRO_ACCUM_MODE", "explicit"))
        state = TS.init_train_state(cfg, strategy, params=lm, device=META,
                                    mesh=mesh)
        placed = RU.place_tree(batch, RU.batch_specs(batch, mesh), mesh)
        arg_tensors = _dtensors({k: v for k, v in state.items()
                                 if k != "model"}) + _dtensors(placed)
        low = Lowered(step, (state, batch), arg_tensors)
    elif shape.mode == "prefill":
        from repro_torch.serve import engine as E
        step = E.make_prefill_step(cfg, attention_impl="reference",
                                   constrain=RU.act_constraint(
                                       mesh, seq_shard=seq_shard))
        params = E.shard_params(lm, mesh)
        placed = E.place_batch(batch, mesh)
        low = Lowered(step, (params, placed),
                      _dtensors(_param_tree(params)) + _dtensors(placed))
    else:  # decode
        from repro_torch.serve import engine as E
        c_dec = (RU.decode_act_constraint(mesh)
                 if os.environ.get("REPRO_DECODE_REPL", "1") == "1"
                 else None)
        step = E.make_serve_step(cfg, constrain=c_dec)
        params = E.shard_params(lm, mesh)
        shardable = shape.global_batch >= RU.mesh_shape(mesh).get("data", 1)
        state = E.shard_serve_state(
            E.init_serve_state(cfg, shape.global_batch, shape.seq_len,
                               device=META),
            mesh, shardable_batch=shardable)
        tokens = S.decode_token_specs(cfg, shape)
        tok = E.place_batch({"tokens": tokens}, mesh,
                            shardable_batch=shardable)
        low = Lowered(step, (params, state, tokens),
                      _dtensors(_param_tree(params)) + _dtensors(state)
                      + _dtensors(tok))
    return low, {"cfg": cfg, "shape": shape}


def _param_tree(params):
    from repro_torch import interop
    return interop.lm_tree(params)


def local_bytes(tensors):
    """The bytes of the local shards of ``tensors`` (DTensors)."""
    return sum(t.to_local().numel() * t.element_size() for t in tensors)


def spec_bytes(tensors):
    """The bytes each of ``tensors`` holds on one rank by its placements
    alone (each sharded dimension divided by its axes' sizes, rounded up
    as DTensor splits)."""
    from torch.distributed.tensor import Shard
    total = 0
    for t in tensors:
        shape = list(t.shape)
        for i, pl in enumerate(t.placements):
            if isinstance(pl, Shard):
                shape[pl.dim] = math.ceil(shape[pl.dim]
                                          / t.device_mesh.shape[i])
        total += math.prod(shape) * t.element_size()
    return total


def analyze(lowered, mesh, verbose=True, recorder=None):
    """Run the lowered step once on the fake group under a
    :class:`comm_stats.CommRecorder` (``recorder``, or a new one); returns
    the per-device report."""
    rec = recorder if recorder is not None else comm_stats.CommRecorder(mesh)
    t0 = time.time()
    with rec:
        lowered.run()
    run_s = time.time() - t0
    coll = comm_stats.collective_stats(rec)
    coll_bytes = comm_stats.total_collective_bytes(rec)
    by_axes = comm_stats.bytes_by_axes(rec)
    coll_s = sum(b / (NVLINK_BW if set(axes) <= {"model"} else NET_BW)
                 for axes, b in by_axes.items())
    result = {
        "chips": int(mesh.size()),
        "run_s": round(run_s, 1),
        "flops_per_device": float(rec.flops),
        "bytes_per_device": float(rec.bytes_accessed),
        "argument_size_in_bytes": int(local_bytes(lowered.placed)),
        "collective_bytes_per_device": float(coll_bytes),
        "collectives": {k: {"count": int(v["count"]),
                            "bytes": float(v["bytes"])}
                        for k, v in coll.items()},
        "collective_bytes_by_axes": {"+".join(k) or "-": int(v)
                                     for k, v in by_axes.items()},
        "compute_term_s": rec.flops / PEAK_FLOPS,
        "memory_term_s": rec.bytes_accessed / HBM_BW,
        "collective_term_s": coll_s,
    }
    terms = {"compute": result["compute_term_s"],
             "memory": result["memory_term_s"],
             "collective": result["collective_term_s"]}
    result["dominant_term"] = max(terms, key=terms.get)
    if verbose:
        print(f"  ran in {run_s:.1f}s on {result['chips']} fake ranks")
        print(f"  per-device: flops={rec.flops:.3e} "
              f"bytes={rec.bytes_accessed:.3e} "
              f"collective_bytes={coll_bytes:.3e}")
        print(f"  time terms (s): compute={terms['compute']:.4f} "
              f"memory={terms['memory']:.4f} "
              f"collective={terms['collective']:.4f} "
              f"-> dominant: {result['dominant_term']}")
        print(f"  memory: args={result['argument_size_in_bytes']/1e9:.2f}GB")
        if coll:
            sched = ", ".join(f"{k} x{v['count']} ({v['bytes']/1e6:.1f}MB)"
                              for k, v in sorted(coll.items()))
            print(f"  collective schedule: {sched}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2-pod (512 rank) mesh instead")
    ap.add_argument("--strategy", default="sync", choices=["sync", "stale"])
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    ap.add_argument("--json", help="write results to this path")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    from repro_torch.distributed.mesh import (PRODUCTION_SHAPE,
                                              make_production_mesh)
    n = math.prod(PRODUCTION_SHAPE) * (2 if args.multi_pod else 1)
    start_fake_group(n)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    mesh_name = "x".join(map(str, mesh.shape))
    pairs = ([(args.arch, args.shape)] if not args.all else
             [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES])

    results, n_fail = {}, 0
    for arch_id, shape_name in pairs:
        key = f"{arch_id}|{shape_name}|{mesh_name}"
        ok, reason = pair_supported(arch_id, shape_name)
        if not ok:
            print(f"[SKIP] {key}: {reason}")
            results[key] = {"status": "skipped", "reason": reason}
            continue
        print(f"[RUN ] {key} (strategy={args.strategy}"
              f"{f', {args.layers} layers' if args.layers else ''})")
        try:
            lowered, meta = lower_pair(
                arch_id, shape_name, mesh, strategy=args.strategy,
                seq_shard=not args.no_seq_shard,
                microbatches=args.microbatches, layers=args.layers)
            res = analyze(lowered, mesh)
            res["status"] = "ok"
            res["layers"] = meta["cfg"].num_layers
            results[key] = res
        except Exception as e:
            n_fail += 1
            traceback.print_exc()
            results[key] = {"status": "fail",
                            "error": f"{type(e).__name__}: {e}"}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json}")
    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    print(f"== dry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed ==")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
