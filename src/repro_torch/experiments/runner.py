"""Sweep runner: SweepSpec -> datasets -> batched engine -> scalability
(port of ``repro/experiments/runner.py``; journaling, retries and per-job
retry status are not ported yet).

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
`DEFAULT_CHARACTERS_ROWS` rows unless the spec asks for more).  A job
whose curves are not finite is stored with status ``"diverged"`` and
skipped by every readout.
"""

from __future__ import annotations

import inspect
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import fit as fit_mod
from repro_torch.core import metrics as MX
from repro_torch.core import scalability as SC
from repro_torch.core.algorithms import base as alg_base
from repro_torch.device import resolve_device
from repro_torch.experiments import cache as artifact_cache
from repro_torch.experiments import engine
from repro_torch.experiments import spec as spec_mod
from repro_torch.experiments.spec import SweepSpec

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
              verbose: bool = False) -> Dict:
    """Execute (or fetch from the port's cache) the sweep a spec
    describes, on ``device`` (default the GPU; raises without one unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    spec.validate()
    cache_dir = cache_dir or artifact_cache.DEFAULT_CACHE_DIR
    fp = spec_mod.fingerprint(spec)
    execution = {"device": str(dev),
                 "device_name": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu")}
    if use_cache and not force:
        hit = artifact_cache.load(cache_dir, spec.name, fp)
        if hit is not None:
            hit["cache"] = {"hit": True, "path": artifact_cache.artifact_path(
                cache_dir, spec.name, fp)}
            hit["execution"] = execution
            return hit

    t0 = time.perf_counter()
    result: Dict = {"name": spec.name, "backend": spec_mod.BACKEND,
                    "spec": spec_mod.computational_dict(spec),
                    "datasets": {}, "jobs": {}}
    timings: Dict[str, float] = {}
    datasets = {name: spec_mod.build_dataset(ds, dev)
                for name, ds in spec.datasets.items()}
    splits = {name: spec_mod.split_dataset(spec.datasets[name], data,
                                           spec.split_seed)
              for name, data in datasets.items()}
    for name, data in datasets.items():
        info: Dict = {"n": int(data.X.shape[0]), "d": int(data.X.shape[1])}
        if spec.measure_csim > 0:
            info["csim"] = MX.csim(data.X[:spec.csim_rows], spec.measure_csim)
        rows = spec.characters_rows or DEFAULT_CHARACTERS_ROWS
        info["characters"] = MX.summarize(data.X[:rows])
        result["datasets"][name] = info
    timings["datasets"] = time.perf_counter() - t0

    for job in spec.jobs:
        t_job = time.perf_counter()
        if verbose:
            print(f"[{spec.name}] sweep {job.key} over m={list(spec.ms)}",
                  flush=True)
        alg_cls = alg_base.get_algorithm(job.algorithm)
        tr, te = splits[job.dataset]
        jr = engine.sweep(
            job.algorithm, tr, te, spec.ms, iters=spec.iters,
            eval_every=spec.eval_every, problem=job.problem,
            n_seeds=spec.n_seeds, **job.kwargs)
        jr["dataset"] = job.dataset
        finite = bool(np.isfinite(
            jr.get("losses_seeds", jr["losses"])).all())
        jr["status"] = "ok" if finite else "diverged"
        if spec.epsilon is not None and finite:
            eps = _epsilon_from_probe(jr, spec.epsilon)
            costs, gg, bound = _cost_readout(
                jr, eps, asynchronous=alg_cls.asynchronous)
            jr.update(epsilon=eps, costs=costs, gain_growth=gg,
                      measured_m_max=int(bound))
        if job.predict and finite:
            X = datasets[job.dataset].X
            if job.predict_rows > 0:
                X = X[:job.predict_rows]
            jr["predicted"] = _predict(alg_cls.predictor, X, job.kwargs)
        result["jobs"][job.key] = jr
        # the readouts above copied the curves to the host, so the
        # device work of this job is done
        timings[job.key] = time.perf_counter() - t_job

    result["elapsed_s"] = time.perf_counter() - t0
    result["timings"] = timings
    path = None
    if use_cache:
        path = artifact_cache.store(cache_dir, spec.name, fp, result)
    result["cache"] = {"hit": False, "path": path}
    result["execution"] = execution
    return result
