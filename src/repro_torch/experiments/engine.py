"""Batched m-sweep engine (port of ``repro/experiments/engine.py``).

Where the reference vmaps one masked, padded simulation over the worker
grid, this engine writes the batch dimension out: all members of a
bucket, times all seed replicates, are B independent simulations whose
state tensors share a leading axis of size B, and each member's live
worker count ``m`` is an entry of a ``(B,)`` tensor.  The iteration scan
is a Python loop over steps that each update all B simulations at once.

The contract kept from the reference:

  * workers with index >= m are masked out of every reduction and write,
    so the padded run is numerically the m-worker run;
  * all random draws (`Algorithm.make_draws`) are made once at the global
    ``m_top = max(ms)`` and sliced per pad width, so member m consumes the
    same draws in any bucket and execution mode;
  * bucketed padding (`_buckets`, ``MAX_PAD_RATIO = 2``) under each
    algorithm's ``bucketed_default`` / ``force_flat`` policy;
  * the seed axis: seed 0 draws with the caller's key, seed s with
    ``fold_in(key, s)``;
  * the same result dict (`_losses_dict`).

``per_m=True`` runs each m alone (padded to ``m_top``), the sequential
reference the equivalence tests compare with (the reference's
``use_vmap=False``).

``mesh=`` shards each bucket's (members x seeds) elements over a device
mesh through `repro_torch.distributed.partition`; a one-device mesh (and
``per_m``) takes the unsharded path bit for bit.

Telemetry keeps the reference's names: a ``grid`` span around the groups,
a ``bucket`` span per bucket (``grid_member`` per member under
``per_m``) through `repro_torch.telemetry.instrument`, the pad-waste gauge
and the flight recorder's ``grid`` event.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import random as R
from repro_torch.core import problems as problems_mod
from repro_torch.core.algorithms import base as alg_base
from repro_torch.distributed import mesh as dist_mesh
from repro_torch.distributed import partition as dist_partition
from repro_torch.telemetry import instrument, metrics, recorder, trace

#: Pad-waste bound for `_buckets`: within a bucket, the padded worker axis
#: is at most this multiple of the smallest member.
MAX_PAD_RATIO = 2.0

#: Fraction of the last grid's padded worker-axis work that was padding:
#: 1 - sum(m) / sum(m_pad per member).
_PAD_WASTE = metrics.gauge(
    "repro_engine_pad_waste_ratio",
    help="pad-waste fraction of the last grid: 1 - sum(m)/sum(m_pad)")


def _note_pad_waste(assignments) -> None:
    """Record the grid's pad waste from ``(m, m_pad)`` member pairs."""
    total = sum(pad for _, pad in assignments)
    if total:
        waste = 1.0 - sum(m for m, _ in assignments) / total
        _PAD_WASTE.set(waste)
        recorder.publish("grid", members=len(assignments),
                         pad_waste=round(waste, 4))


def _losses_dict(algorithm: str, ms, losses, iters: int, eval_every: int,
                 problem: str = "logistic", n_seeds: int = 1):
    """Engine output contract: ``losses`` (S, n_seeds, n_evals) becomes
    seed-0 curves per m, plus ``losses_seeds`` when n_seeds > 1."""
    losses = losses.detach().cpu().tolist()
    out = {
        "algorithm": algorithm,
        "problem": problem,
        "ms": [int(m) for m in ms],
        "iters": int(iters),
        "eval_every": int(eval_every),
        "n_seeds": int(n_seeds),
    }
    out["losses"] = [[float(v) for v in row[0]] for row in losses]
    if n_seeds > 1:
        out["losses_seeds"] = [[[float(v) for v in curve] for curve in row]
                               for row in losses]
    return out


def _buckets(ms: Sequence[int],
             max_pad_ratio: float = MAX_PAD_RATIO
             ) -> List[Tuple[Tuple[int, ...], int]]:
    """Greedy waste-bounded partition of the m-grid: ``[(positions,
    m_pad), ...]``; ascending, a member opens a new bucket when it would
    exceed ``max_pad_ratio *`` the bucket's smallest m."""
    order = sorted(range(len(ms)), key=lambda i: ms[i])
    out: List[Tuple[Tuple[int, ...], int]] = []
    cur: List[int] = []
    for i in order:
        if cur and ms[i] > max_pad_ratio * ms[cur[0]]:
            out.append((tuple(cur), ms[cur[-1]]))
            cur = []
        cur.append(i)
    if cur:
        out.append((tuple(cur), ms[cur[-1]]))
    return out


def prepare_bucket(alg, prob, train, members: Sequence[int], m_pad: int,
                   draws_by_seed, seeds: Optional[Sequence[int]] = None):
    """The batch of ``members`` x seeds at pad width ``m_pad``: returns
    ``(ctx, state, per_elem)``, where ``per_elem`` holds the draws with
    iteration leading, ``(iters, B, ...)``, so that iteration t's batch is
    ``map_draws(lambda a: a[t], per_elem)``.

    With ``seeds`` the elements are explicit: element b is member
    ``members[b]`` under seed ``seeds[b]`` (a shard's slice of a bucket);
    without, element b is member ``members[b // n_seeds]`` under seed
    ``b % n_seeds``.  Either way an element draws by its seed, never by
    its position in the batch."""
    dev = train.X.device
    n_seeds = len(draws_by_seed)
    if seeds is None:
        m = torch.tensor(members, dtype=torch.int64,
                         device=dev).repeat_interleave(n_seeds)
        seed_of = torch.arange(n_seeds, device=dev).repeat(len(members))
    else:
        m = torch.tensor(members, dtype=torch.int64, device=dev)
        seed_of = torch.tensor(seeds, dtype=torch.int64, device=dev)
    subs = [alg.slice_draws(d, m_pad) for d in draws_by_seed]
    if isinstance(subs[0], dict):
        stacked = {k: torch.stack([s[k] for s in subs]) for k in subs[0]}
    else:
        stacked = torch.stack(subs)
    # (iters, B, ...): iteration t's draws for every element, contiguous
    per_elem = alg_base.map_draws(
        lambda a: a[seed_of].movedim(1, 0).contiguous(), stacked)
    ctx = alg_base.SimContext(m, m_pad)
    return ctx, alg.init_state(prob, train, ctx), per_elem


def _simulate(alg, prob, train, test, members: Sequence[int], m_pad: int,
              draws_by_seed, iters: int, eval_every: int,
              seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Run the elements `prepare_bucket` makes of ``members`` (and
    ``seeds``) as one batch at pad width ``m_pad``; returns their losses
    ``(B, n_evals)``."""
    ctx, state, per_elem = prepare_bucket(alg, prob, train, members, m_pad,
                                          draws_by_seed, seeds)
    B = ctx.m.shape[0]
    n_evals = iters // eval_every
    losses = torch.empty(B, n_evals, device=train.X.device)
    for e in range(n_evals):
        for t in range(e * eval_every, (e + 1) * eval_every):
            state = alg.step(prob, train, ctx, state,
                             alg_base.map_draws(lambda a: a[t], per_elem), t)
        losses[:, e] = prob.test_loss(alg.readout(ctx, state), test.X,
                                      test.y)
    return losses


def _on(data, device):
    """``data`` (a `Dataset`) with its tensors on ``device``."""
    if data.X.device == device:
        return data
    return dataclasses.replace(data, X=data.X.to(device),
                               y=data.y.to(device))


def sweep(algorithm: Union[str, alg_base.Algorithm], train, test,
          ms: Sequence[int], *, iters: int, eval_every: int,
          problem="logistic", lam: Optional[float] = None, key=None,
          per_m: bool = False, bucketed: Optional[bool] = None,
          n_seeds: int = 1, mesh: "dist_mesh.MeshLike" = None,
          **alg_kwargs) -> Dict:
    """Run ``algorithm`` on ``problem`` over the worker grid ``ms``, on the
    device the training data lives on.

    ``algorithm`` is a registry name (instantiated with ``alg_kwargs``) or
    an `Algorithm` instance; ``problem`` a registry name / class /
    instance.  ``bucketed=None`` defers to the algorithm's policy;
    ``n_seeds > 1`` replicates every member over independent draws.
    ``mesh`` (None, ``"auto"``, an int or a `DeviceMesh`) shards each
    bucket's elements over a device mesh; results are mesh-invariant and
    a one-device mesh is bit-exact with ``mesh=None``."""
    if isinstance(algorithm, alg_base.Algorithm):
        if alg_kwargs:
            raise TypeError("pass algorithm kwargs either via the instance "
                            "or via **alg_kwargs, not both")
        alg = algorithm
    else:
        alg = alg_base.get_algorithm(algorithm)(**alg_kwargs)
    prob = problems_mod.resolve_problem(problem, lam)
    dev = train.X.device
    key = (key if key is not None else R.PRNGKey(0)).to(dev)
    if n_seeds < 1:
        raise ValueError(f"n_seeds={n_seeds} must be >= 1")

    ms = [int(m) for m in ms]
    m_top = max(ms)
    n, d = train.X.shape
    seed_keys = [key] + [R.fold_in(key, s) for s in range(1, n_seeds)]
    draws_by_seed = [alg.make_draws(k, n, iters, m_top, d)
                     for k in seed_keys]

    if bucketed is None:
        bucketed = alg.bucketed_default
    if alg.force_flat:
        bucketed = False
    if per_m:
        groups = [((i,), m_top) for i in range(len(ms))]
    elif bucketed:
        groups = _buckets(ms)
    else:
        groups = [(tuple(range(len(ms))), m_top)]
    _note_pad_waste([(ms[i], m_pad) for pos, m_pad in groups for i in pos])
    dmesh = dist_mesh.resolve(mesh, device=dev)

    def run(pos, m_pad):
        return _simulate(alg, prob, train, test, [ms[i] for i in pos],
                         m_pad, draws_by_seed, iters,
                         eval_every).reshape(len(pos), n_seeds, -1)

    with trace.span("grid", algorithm=alg.name, problem=prob.name,
                    members=len(ms), n_seeds=n_seeds):
        if dmesh is not None and dmesh.n_devices > 1 and not per_m:
            placed = {}

            def run_elements(m_list, s_list, m_pad, device):
                if device not in placed:
                    placed[device] = (
                        _on(train, device), _on(test, device),
                        [alg_base.map_draws(lambda a: a.to(device), dr)
                         for dr in draws_by_seed])
                tr, te, draws = placed[device]
                return _simulate(alg, prob, tr, te, m_list, m_pad, draws,
                                 iters, eval_every, seeds=s_list)

            losses = dist_partition.run_grid_sharded(
                run_elements, ms, n_seeds, dmesh, groups).to(dev)
        else:
            rows = [None] * len(ms)
            for pos, m_pad in groups:
                if per_m:
                    out = instrument.timed_call(
                        run, pos, m_pad, span_name="grid_member",
                        m=ms[pos[0]], m_pad=m_pad)
                else:
                    out = instrument.dispatch(
                        run, pos, m_pad, span_name="bucket", m_pad=m_pad,
                        members=len(pos))
                for k, i in enumerate(pos):
                    rows[i] = out[k]
            losses = torch.stack(rows)
    return _losses_dict(alg.name, ms, losses, iters, eval_every,
                        problem=prob.name, n_seeds=n_seeds)
