"""Sweep runner: SweepSpec -> datasets -> batched engine -> scalability
(port of ``repro/experiments/runner.py``).

For each job `run_sweep`

  1. materializes the job's dataset on the run's device and splits it
     70/20 per the spec's shuffle policy,
  2. runs the worker grid through `engine.sweep`,
  3. with an epsilon readout, derives epsilon from the probe-m curve,
     converts curves to per-worker costs (§V.A.1) and reads gain growth
     and the measured upper bound m_max (§V.B),
  4. if asked, runs the theory-side predictor of the algorithm's kind on
     the raw dataset characters.

Every dataset reports its §IV characters (`metrics.summarize`, capped at
`DEFAULT_CHARACTERS_ROWS` rows unless the spec asks for more).

Fault tolerance: every finished job is appended to a crash journal
(`repro_torch.resilience.journal`) beside the artifact, so a sweep killed
mid-run resumes from the completed jobs and still stores a byte-identical
artifact.  A job that raises is retried with backoff (``max_retries``);
each job carries a ``status`` — "ok", "retried:N", "diverged" (curves
not finite, kept for forensics) or "failed" (every attempt raised; a
structured stub) — and unhealthy jobs stay out of every readout
(`job_is_healthy`).  Running out of device memory is retried; any other
CUDA error leaves the context unusable, so it ends the job at once, and
no attempt ever moves to another device.

Results are plain JSON-serializable dicts, stored in the port's
content-hashed artifact cache; the per-run keys ``cache``,
``execution``, ``elapsed_s`` and the per-job wall ``timings`` are
attached after loading and never persisted.  ``execution`` names the
device and the resolved mesh (``devices``, ``sharded``); the mesh is an
execution resource only, so an artifact is byte-identical whichever mesh
computed it, and a cache hit never resolves one.
"""

from __future__ import annotations

import inspect
import math
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import fit as fit_mod
from repro_torch.core import metrics as MX
from repro_torch.core import scalability as SC
from repro_torch.core.algorithms import base as alg_base
from repro_torch.device import resolve_device
from repro_torch.distributed import mesh as dist_mesh
from repro_torch.experiments import cache as artifact_cache
from repro_torch.experiments import engine
from repro_torch.experiments import spec as spec_mod
from repro_torch.experiments.spec import SweepSpec
from repro_torch.resilience import journal as journal_mod
from repro_torch.telemetry import metrics, trace
from repro_torch.telemetry.recorder import publish as _flight

#: theory-side m_max predictor per Algorithm.predictor kind
_PREDICTORS = {
    "hogwild": fit_mod.predict_hogwild_mmax,
    "sync": fit_mod.predict_sync_mmax,
    "dadm": fit_mod.predict_dadm_mmax,
    "momentum": fit_mod.predict_momentum_mmax,
    "local_sgd": fit_mod.predict_local_sgd_mmax,
    "svrg": fit_mod.predict_svrg_mmax,
}

#: row cap for the always-on dataset-characters report
DEFAULT_CHARACTERS_ROWS = 512

#: sweeps actually computed (cache hits and dedup waits excluded); the
#: module-level ``SWEEP_COMPUTES`` read goes through ``__getattr__``
_SWEEP_COMPUTES = metrics.counter(
    "repro_sweep_computes_total",
    help="sweeps actually computed (cache hits / dedup waits excluded)")
_DEDUP_LEADER = metrics.counter(
    "repro_sweep_dedup_leader_total",
    help="single-flight leases won (this caller computed for the group)")
_DEDUP_WAITER = metrics.counter(
    "repro_sweep_dedup_waiter_total",
    help="single-flight waits (this caller blocked on a leader's compute)")
_JOB_RETRIES = metrics.counter(
    "repro_sweep_job_retries_total",
    help="job attempts beyond the first (raised or non-finite curves)")
_JOURNAL_APPENDS = metrics.counter(
    "repro_journal_appends_total",
    help="finished jobs appended to a crash journal")
_JOURNAL_REPLAYS = metrics.counter(
    "repro_journal_replays_total",
    help="jobs replayed from a crash journal instead of recomputed")


def __getattr__(name):
    if name == "SWEEP_COMPUTES":
        return _SWEEP_COMPUTES.value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


#: process-wide single-flight table for `run_sweep(dedup=True)` callers
_INFLIGHT = artifact_cache.InFlightTable()


def _predict(predictor: str, X, job_kwargs: Dict) -> Dict:
    """Run the theory-side predictor with the job hyperparameters its
    signature accepts."""
    fn = _PREDICTORS[predictor]
    accepted = inspect.signature(fn).parameters
    return fn(X, **{k: v for k, v in job_kwargs.items() if k in accepted})


def curves_by_m(job_result: Dict) -> Dict[int, List[float]]:
    """{worker count: convergence curve} view of a job result."""
    return {int(m): list(row) for m, row in
            zip(job_result["ms"], job_result["losses"])}


def _epsilon_from_probe(job_result: Dict, eps_spec) -> float:
    """Table II policy: epsilon is the loss the probe_m-worker run reaches
    after ``frac`` of its eval budget."""
    curve = curves_by_m(job_result)[eps_spec.probe_m]
    idx = min(int(len(curve) * eps_spec.frac), len(curve) - 1)
    return float(curve[idx])


def job_is_healthy(job_result: Dict) -> bool:
    """True when the job's curves are trustworthy inputs for readouts and
    fits: "ok" and "retried:N" are healthy, "diverged" and "failed" are
    not; a result without a status is healthy."""
    status = str(job_result.get("status", "ok"))
    return status == "ok" or status.startswith("retried")


def _finite(job_result: Dict) -> bool:
    return bool(np.isfinite(
        job_result.get("losses_seeds", job_result["losses"])).all())


def _retryable(exc: Exception) -> bool:
    """Whether another attempt of a job can succeed.  Running out of
    device memory can (the allocator's cache is emptied first).  Any
    other CUDA error leaves the context unusable, and a kernel that
    failed to build fails again, so those end the job at once."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return False
    msg = str(exc)
    return not any(s in msg for s in ("CUDA error", "cudaError",
                                      "Error building extension"))


def _run_job_with_retries(spec: SweepSpec, job, tr, te, dmesh, per_m: bool,
                          max_retries: int, retry_backoff_s: float,
                          verbose: bool):
    """Run one job with bounded retry-with-backoff; returns
    ``(job_result, status, attempts)``.  The engine is deterministic, so
    retries target transient failures, not numerics: a curve that
    diverges on
    every attempt is reported "diverged" with its curves intact, and a
    job whose attempts all raised becomes a structured "failed" stub."""
    last_exc: Optional[BaseException] = None
    jr: Optional[Dict] = None
    for attempt in range(max_retries + 1):
        if attempt:
            _JOB_RETRIES.inc()
            _flight("job_retried", sweep=spec.name, job=job.key,
                    attempt=attempt + 1)
            if retry_backoff_s > 0:
                time.sleep(retry_backoff_s * (2 ** (attempt - 1)))
        try:
            jr = engine.sweep(
                job.algorithm, tr, te, spec.ms, iters=spec.iters,
                eval_every=spec.eval_every, problem=job.problem,
                n_seeds=spec.n_seeds, per_m=per_m, mesh=dmesh,
                **job.kwargs)
        except Exception as exc:  # noqa: BLE001 — one job must not kill the sweep
            last_exc = exc
            if verbose:
                print(f"[{spec.name}] {job.key}: attempt {attempt + 1} "
                      f"raised {type(exc).__name__}: {exc}", flush=True)
            if not _retryable(exc):
                break
            if isinstance(exc, torch.cuda.OutOfMemoryError):
                torch.cuda.empty_cache()
            continue
        if _finite(jr):
            return (jr, "ok" if attempt == 0 else f"retried:{attempt}",
                    attempt + 1)
        if verbose:
            print(f"[{spec.name}] {job.key}: attempt {attempt + 1} "
                  f"produced non-finite curves", flush=True)
    if jr is not None:
        return jr, "diverged", attempt + 1
    return ({"algorithm": job.algorithm, "problem": job.problem,
             "error": f"{type(last_exc).__name__}: {last_exc}"}, "failed",
            attempt + 1)


def _cost_readout(job_result: Dict, epsilon: float, asynchronous: bool):
    iters = job_result["iters"]
    costs = []
    for m, losses in zip(job_result["ms"], job_result["losses"]):
        c = SC.cost_per_worker(
            {"losses": losses, "eval_every": job_result["eval_every"],
             "m": m}, epsilon, asynchronous=asynchronous)
        costs.append(float(c) if math.isfinite(c) else float(iters))
    gg = SC.gain_growth_from_costs(costs)
    bound = SC.measured_upper_bound(job_result["ms"][:-1], gg)
    return costs, gg, bound


def run_sweep(spec: SweepSpec, *, device="cuda", use_cache: bool = True,
              force: bool = False, cache_dir: Optional[str] = None,
              verbose: bool = False, per_m: bool = False,
              mesh: "dist_mesh.MeshLike" = None, journal: bool = True,
              max_retries: int = 1, retry_backoff_s: float = 0.25,
              dedup: bool = False, cache_cap: Optional[int] = None) -> Dict:
    """Execute (or fetch from the port's cache) the sweep a spec
    describes, on ``device`` (default the GPU; raises without one unless
    ``device="cpu"``).

    ``per_m`` runs each worker count alone (the sequential reference
    path, never sharded).  ``mesh`` (or, when None, the spec's
    execution-only ``devices``) shards every job's buckets over a device
    mesh of ``device``'s type (`repro_torch.distributed.get_mesh`);
    results and cache keys are mesh-invariant.

    ``journal=True`` (with ``use_cache``) appends every finished job to a
    crash journal beside the artifact and, on a re-run after a crash,
    replays journaled jobs instead of recomputing them.  ``max_retries``
    bounds the retry-with-backoff loop of a job that raises or produces
    non-finite curves.  ``dedup=True`` (with ``use_cache``) routes the
    call through a process-wide single-flight table: concurrent callers
    sharing this spec's fingerprint elect one leader that computes and
    stores the artifact while the rest wait and then load it
    (`SWEEP_COMPUTES` counts real executions).  ``cache_cap`` forwards to
    `cache.store(max_artifacts=...)`."""
    dev = resolve_device(device)
    spec.validate()
    cache_dir = cache_dir or artifact_cache.DEFAULT_CACHE_DIR
    fp = spec_mod.fingerprint(spec)
    execution = {"device": str(dev),
                 "device_name": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu")}

    leased = False
    while use_cache and not force:
        hit = artifact_cache.load(cache_dir, spec.name, fp)
        if hit is not None:
            if leased:
                _INFLIGHT.release(fp)
            hit["cache"] = {"hit": True, "path": artifact_cache.artifact_path(
                cache_dir, spec.name, fp)}
            # a hit executes nothing, so the mesh request is never
            # resolved: an artifact computed elsewhere serves even where
            # the spec's `devices` ask cannot be met
            hit["execution"] = {**execution,
                                "devices": len(dist_mesh.available(dev)),
                                "sharded": False}
            return hit
        if not dedup or leased:
            break
        if _INFLIGHT.lease(fp):
            # leader: re-check the cache once (a prior leader may have
            # stored between our miss and the lease), then compute
            leased = True
            _DEDUP_LEADER.inc()
            continue
        # follower: wait for the leader, then re-check the cache — a hit
        # on its success, the lease again on its failure
        _DEDUP_WAITER.inc()
        with trace.span("dedup_wait", fingerprint=fp[:12]):
            _INFLIGHT.wait(fp)

    try:
        with trace.span("sweep", spec=spec.name, fingerprint=fp[:12],
                        jobs=len(spec.jobs)):
            return _compute_sweep(
                spec, fp, cache_dir, dev, execution, use_cache=use_cache,
                force=force, verbose=verbose, per_m=per_m, mesh=mesh,
                journal=journal,
                max_retries=max_retries, retry_backoff_s=retry_backoff_s,
                cache_cap=cache_cap)
    finally:
        if leased:
            # success or failure, wake every dedup waiter
            _INFLIGHT.release(fp)


def _compute_sweep(spec: SweepSpec, fp: str, cache_dir: str, dev,
                   execution: Dict, *, use_cache: bool, force: bool,
                   verbose: bool, per_m: bool, mesh, journal: bool,
                   max_retries: int, retry_backoff_s: float,
                   cache_cap: Optional[int]) -> Dict:
    """The cache-miss path of `run_sweep`: journal replay, job execution,
    readouts, artifact store."""
    _SWEEP_COMPUTES.inc()
    dmesh = dist_mesh.resolve(mesh if mesh is not None else spec.devices,
                              device=dev)
    execution = {**execution,
                 "devices": dmesh.n_devices if dmesh is not None else 1,
                 "sharded": (dmesh is not None and dmesh.n_devices > 1
                             and not per_m)}
    jpath = journal_mod.journal_path(cache_dir, spec.name, fp)
    journaled: Dict[str, Dict] = {}
    if use_cache and journal and not force:
        with trace.span("journal_read"):
            journaled = journal_mod.read_entries(jpath, fp)
        if verbose and journaled:
            print(f"[{spec.name}] resuming: {len(journaled)} job(s) "
                  f"replayed from crash journal {jpath}", flush=True)
    _flight("sweep_started", sweep=spec.name, fingerprint=fp[:12],
            jobs=len(spec.jobs), replayed=len(journaled))

    t0 = time.perf_counter()
    result: Dict = {"name": spec.name, "backend": spec_mod.BACKEND,
                    "spec": spec_mod.computational_dict(spec),
                    "datasets": {}, "jobs": {}}
    timings: Dict[str, float] = {}
    with trace.span("datasets", count=len(spec.datasets)):
        datasets = {name: spec_mod.build_dataset(ds, dev)
                    for name, ds in spec.datasets.items()}
        splits = {name: spec_mod.split_dataset(spec.datasets[name], data,
                                               spec.split_seed)
                  for name, data in datasets.items()}
        for name, data in datasets.items():
            info: Dict = {"n": int(data.X.shape[0]),
                          "d": int(data.X.shape[1])}
            if spec.measure_csim > 0:
                info["csim"] = MX.csim(data.X[:spec.csim_rows],
                                       spec.measure_csim)
            rows = spec.characters_rows or DEFAULT_CHARACTERS_ROWS
            info["characters"] = MX.summarize(data.X[:rows])
            result["datasets"][name] = info
    timings["datasets"] = time.perf_counter() - t0

    for job in spec.jobs:
        if job.key in journaled:
            # crash-journal replay: the entry carries readouts,
            # predictions and status, a JSON round-trip of what an
            # uninterrupted run would have put here
            if verbose:
                print(f"[{spec.name}] {job.key}: resumed from journal",
                      flush=True)
            _JOURNAL_REPLAYS.inc()
            _flight("job_replayed", sweep=spec.name, job=job.key)
            result["jobs"][job.key] = journaled[job.key]
            continue
        t_job = time.perf_counter()
        if verbose:
            print(f"[{spec.name}] sweep {job.key} over m={list(spec.ms)}",
                  flush=True)
        alg_cls = alg_base.get_algorithm(job.algorithm)
        tr, te = splits[job.dataset]
        _flight("job_started", sweep=spec.name, job=job.key,
                algorithm=job.algorithm, dataset=job.dataset)
        with trace.span("job", key=job.key, algorithm=job.algorithm,
                        dataset=job.dataset):
            jr, status, attempts = _run_job_with_retries(
                spec, job, tr, te, dmesh, per_m, max_retries,
                retry_backoff_s, verbose)
        jr["dataset"] = job.dataset
        jr["status"] = status
        if status in ("diverged", "failed"):
            _flight(f"job_{status}", sweep=spec.name, job=job.key)
        if status == "diverged":
            warnings.warn(
                f"job {job.key!r}: non-finite loss curve — the step size "
                f"is likely unstable for problem {job.problem!r} on this "
                f"dataset; tune the job kwargs", RuntimeWarning,
                stacklevel=2)
        elif status == "failed":
            warnings.warn(
                f"job {job.key!r}: failed after {attempts} attempt(s) — "
                f"{jr['error']}; a structured stub is cached in its place",
                RuntimeWarning,
                stacklevel=2)
        healthy = job_is_healthy(jr)

        with trace.span("readout", key=job.key):
            if spec.epsilon is not None and healthy:
                eps = _epsilon_from_probe(jr, spec.epsilon)
                costs, gg, bound = _cost_readout(
                    jr, eps, asynchronous=alg_cls.asynchronous)
                jr.update(epsilon=eps, costs=costs, gain_growth=gg,
                          measured_m_max=int(bound))
            if job.predict and healthy:
                X = datasets[job.dataset].X
                if job.predict_rows > 0:
                    X = X[:job.predict_rows]
                jr["predicted"] = _predict(alg_cls.predictor, X, job.kwargs)
        result["jobs"][job.key] = jr
        # the readouts above copied the curves to the host, so the
        # device work of this job is done
        timings[job.key] = time.perf_counter() - t_job
        _flight("job_stored", sweep=spec.name, job=job.key, status=status,
                healthy=healthy)
        if use_cache and journal:
            with trace.span("journal_append", key=job.key):
                journal_mod.append_entry(jpath, fp, job.key, jr)
            _JOURNAL_APPENDS.inc()

    result["elapsed_s"] = time.perf_counter() - t0
    result["timings"] = timings
    path = None
    if use_cache:
        with trace.span("store"):
            path = artifact_cache.store(cache_dir, spec.name, fp, result,
                                        max_artifacts=cache_cap)
            if journal:
                journal_mod.consume(jpath)
    result["cache"] = {"hit": False, "path": path}
    result["execution"] = execution
    _flight("sweep_stored", sweep=spec.name, fingerprint=fp[:12],
            elapsed_s=round(result["elapsed_s"], 3), path=path)
    return result
