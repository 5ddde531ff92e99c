"""Racing Hogwild!: worker shards racing on a shared parameter (port of
``repro/distributed/hogwild_shards.py``).

The engine's Hogwild! (`repro_torch.core.algorithms.hogwild`) emulates
the lock-free race as a sequential staleness recurrence: gradient ``j``
is computed against the model of iteration ``j - tau``, ``tau`` cycling
over ``[1, m]`` (Thm 1).  That recurrence is the parity oracle.

This module runs the race.  The ``m`` workers are split into ``D``
shards, one per mesh entry, ``w = ceil(m / D)`` worker slots each (the
slots past ``m`` are masked out).  Each shard races on its own copy of
the parameter: its workers apply full-step SGD updates one after
another, each reading whatever its shard's copy holds.  Every
``sync_every`` rounds, and at every eval boundary, the shards reconcile
by adding every shard's delta to the shared parameter,
``x <- x_base + sum_k (x_k - x_base)`` (a sum, not a mean: every write
lands), the reference's ``psum``.  The shards of one device advance
together as the rows of one tensor; shards on different devices hold
their copies there, and a reconcile gathers their deltas onto the first
shard's device.

At ``m == D, sync_every=1`` every round's gradients read the previous
round boundary, which is exactly the oracle's ``tau`` structure, so the
two agree to float summation order.  A wider sync window lets shards race
ahead on parameters up to ``sync_every * m`` iterations stale.

The sample draws and the fault stream are the reference's, bit for bit:
samples are ``randint(key, (n_evals, rounds, D, w), 0, n)`` and faults
``faults.make_stream(spec, (n_evals, rounds, D, w))``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch import random as R
from repro_torch.core.algorithms.lr import LAMBDA, lr_grad, test_logloss
from repro_torch.distributed import mesh as mesh_mod
from repro_torch.resilience import faults
from repro_torch.telemetry import instrument, metrics, recorder

#: every reconcile (scheduled sync rounds plus the forced per-eval sync)
#: is one cross-shard reduction round
_PSUM_ROUNDS = metrics.counter(
    "repro_distributed_psum_rounds_total",
    help="psum reconcile rounds executed by the racing mode")


def _race(train, test, dmesh, samples, mask, fstream, fspec, *, w, gamma,
          lam, sync_every):
    """The racing pipeline: returns ``(x, losses)``, the reconciled model
    and the test loss at each eval boundary.  ``samples`` is ``(E, Rr, D,
    w)`` sample indices, ``mask`` ``(D, w)`` live slots, ``fstream`` the
    fault events of ``samples``' shape or None."""
    home = dmesh.devices[0]
    # shards grouped by device: (device, shard indices, X, y, local model)
    groups = {}
    for k, dev in enumerate(dmesh.devices):
        groups.setdefault(dev, []).append(k)
    d = train.X.shape[1]
    x_base = torch.zeros(d, device=home)
    shards = []
    for dev, ks in groups.items():
        idx = torch.tensor(ks, device=samples.device)
        shards.append({
            "dev": dev, "ks": ks,
            "X": train.X.to(dev), "y": train.y.to(dev),
            "samples": samples[:, :, idx].to(dev),
            "mask": mask[idx].to(dev),
            "faults": (None if fstream is None else
                       {n: v[:, :, idx].to(dev) for n, v in fstream.items()}),
            "x": x_base.to(dev).expand(len(ks), d).clone()})

    def reconcile():
        nonlocal x_base
        delta = sum((s["x"] - x_base.to(s["dev"])).sum(dim=0).to(home)
                    for s in shards)
        x_base = x_base + delta
        for s in shards:
            s["x"] = x_base.to(s["dev"]).expand(len(s["ks"]), d).clone()

    E, rounds = samples.shape[:2]
    losses = torch.empty(E, device=home)
    r = 0
    for e in range(E):
        for rr in range(rounds):
            for s in shards:
                x_loc = s["x"]
                b = x_loc            # the round-start model (straggler read)
                for j in range(w):
                    i = s["samples"][e, rr, :, j]
                    live = s["mask"][:, j]
                    Xi, yi = s["X"][i], s["y"][i]
                    if s["faults"] is None:
                        g = lr_grad(x_loc, Xi, yi, lam)
                        x_loc = x_loc - (gamma * live)[:, None] * g
                        continue
                    fd = {n: v[e, rr, :, j] for n, v in s["faults"].items()}
                    # both reads are evaluated and the gradient selected,
                    # as the reference does
                    g = torch.where(fd["straggle"][:, None] > 0,
                                    lr_grad(b, Xi, yi, lam),
                                    lr_grad(x_loc, Xi, yi, lam))
                    g = faults.corrupt(fspec, g, fd["corrupt"])
                    scale = faults.delivery_scale(fd)
                    x_loc = x_loc - (gamma * live * scale)[:, None] * g
                s["x"] = x_loc
            if r % sync_every == sync_every - 1:
                reconcile()
            r += 1
        # a sync at every eval boundary: the evaluated model is the
        # shared parameter
        reconcile()
        losses[e] = test_logloss(x_base, test.X.to(home), test.y.to(home))
    return x_base, losses


def run_hogwild_sharded(train, test, *, m: int = 8, iters: int = 4000,
                        gamma: float = 0.1, lam: float = LAMBDA,
                        eval_every: int = 100, key=None,
                        mesh: mesh_mod.MeshLike = None,
                        sync_every: int = 1,
                        fault: "faults.FaultLike" = None) -> Dict:
    """Race ``m`` workers over the mesh's shards; returns a curve dict.

    ``iters`` gradient applications in all, a test-loss eval every
    ``eval_every`` of them (a multiple of ``m``, so evals land on round
    boundaries).  ``mesh`` resolves through `mesh.get_mesh` against the
    training data's device type (auto = every device of that type);
    workers pad up to a multiple of the shard count with inert slots.
    ``fault`` injects per-(round, worker) delivery faults: a dropped
    update never enters its shard's delta, a duplicated one lands twice,
    a straggler reads its shard's round-start model, corruption rewrites
    the gradient.  At ``m == D * w`` the event stream is the sequential
    oracle's ``(iters,)`` stream, element for element."""
    dmesh = mesh_mod.get_mesh(mesh, device=train.X.device)
    fspec = faults.resolve(fault)
    D = dmesh.n_devices
    if eval_every % m:
        raise ValueError(
            f"eval_every={eval_every} must be a multiple of m={m}: the "
            f"racing mode applies m gradients per round and evals on "
            f"round boundaries")
    home = dmesh.devices[0]
    key = (key if key is not None else R.PRNGKey(0)).to(home)
    n = train.X.shape[0]
    w = -(-m // D)                       # worker slots per shard
    n_evals = iters // eval_every
    rounds_per_eval = eval_every // m
    shape = (n_evals, rounds_per_eval, D, w)
    # one sample per (round, worker slot); padded slots draw but never
    # apply, so live workers' streams do not depend on the mesh size
    samples = R.randint(key, shape, 0, n)
    mask = (torch.arange(w * D, device=home) < m).to(
        torch.float32).reshape(D, w)
    fstream = None if fspec is None else faults.make_stream(fspec, shape,
                                                            home)
    attrs = dict(m=m, devices=D, sync_every=sync_every)
    if fspec is not None:
        attrs["faulted"] = True
    x, losses = instrument.dispatch(
        lambda: _race(train, test, dmesh, samples, mask, fstream, fspec,
                      w=w, gamma=gamma, lam=lam, sync_every=sync_every),
        span_name="race", **attrs)
    # the pipeline's sync schedule: the round counter hits
    # r % sync_every == sync_every - 1 exactly r_total // sync_every
    # times, and every eval block forces one more reconcile
    r_total = n_evals * rounds_per_eval
    psum_rounds = r_total // sync_every + n_evals
    _PSUM_ROUNDS.inc(psum_rounds)
    recorder.publish("race", m=m, devices=D, sync_every=sync_every,
                     psum_rounds=psum_rounds, faulted=fspec is not None)
    out = {
        "algorithm": "hogwild_sharded",
        "m": m,
        "devices": D,
        "sync_every": sync_every,
        "iters": n_evals * eval_every,
        "eval_every": eval_every,
        "losses": losses.cpu().tolist(),
        "x": x,
        "iters_per_worker": iters / m,
        "psum_rounds": psum_rounds,
    }
    if fspec is not None:
        out["fault"] = fspec.to_dict()
    return out


def sweep_hogwild_sharded(train, test, ms: Sequence[int], *, iters: int,
                          eval_every: int, gamma: float = 0.1,
                          lam: float = LAMBDA, key=None,
                          mesh: mesh_mod.MeshLike = None,
                          sync_every: int = 1,
                          fault: "faults.FaultLike" = None) -> Dict:
    """Racing-mode m-grid, one race per m (this mode spreads work over
    shards, not grid members; the engine's grid with the staleness oracle
    stays the cached, mesh-invariant default).  Each m's eval cadence is
    aligned down to its round boundary (``ev_m = m * (eval_every // m)``,
    at least one round) and its budget to ``(iters // eval_every) *
    ev_m``, so every row has the same number of evals."""
    dmesh = mesh_mod.get_mesh(mesh, device=train.X.device)
    n_evals = iters // eval_every
    curves = []
    for m in ms:
        ev = int(m) * max(1, eval_every // int(m))
        curves.append(run_hogwild_sharded(
            train, test, m=int(m), iters=n_evals * ev, eval_every=ev,
            gamma=gamma, lam=lam, key=key, mesh=dmesh,
            sync_every=sync_every, fault=fault)["losses"])
    return {
        "algorithm": "hogwild_sharded",
        "problem": "logistic",
        "ms": [int(m) for m in ms],
        "devices": dmesh.n_devices,
        "iters": int(iters),
        "eval_every": int(eval_every),
        "n_seeds": 1,
        "losses": [[float(v) for v in row] for row in curves],
    }
