"""Named sweep specs (port of ``repro/experiments/registry.py``).  This
slice ports ``upper_bound``, the paper's Table II: the cost-per-worker
sweep with measured and predicted m_max."""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.experiments.spec import (DatasetSpec, EpsilonSpec, JobSpec,
                                          SweepSpec)


def _upper_bound(quick=False, iters: Optional[int] = None) -> SweepSpec:
    """Dataset sizes are fixed by §VII.E; ``quick`` and ``iters`` set the
    iteration budget."""
    iters = iters if iters is not None else (1200 if quick else 3000)
    datasets = {
        "ub": DatasetSpec("upper_bound",
                          {"n": 4000, "d": 400, "density": 0.7}),
        "dense": DatasetSpec("higgs_like", {"n": 4000, "d": 28}),
        "sparse8": DatasetSpec("realsim_like",
                               {"n": 1000, "d": 300, "density": 0.05}),
    }
    jobs = (
        JobSpec("hogwild", "ub", {"gamma": 0.05}, predict=True),
        JobSpec("minibatch", "dense", predict=True),
        JobSpec("ecd_psgd", "dense"),
        JobSpec("dadm", "sparse8", predict=True, predict_rows=600),
    )
    return SweepSpec(
        name="upper_bound",
        description="Table II: cost-per-worker sweep + predicted m_max",
        ms=(2, 4, 8, 16, 24), iters=iters, eval_every=iters // 20,
        datasets=datasets, jobs=jobs,
        epsilon=EpsilonSpec(probe_m=2, frac=0.7)).validate()


_BUILDERS = {
    "upper_bound": _upper_bound,
}

SPEC_IDS = sorted(_BUILDERS)


def get_spec(name: str, *, quick: bool = False,
             iters: Optional[int] = None,
             seeds: Optional[int] = None) -> SweepSpec:
    """Resolve a named spec; ``seeds`` overrides its ``n_seeds``."""
    if name not in _BUILDERS:
        raise KeyError(f"unknown sweep spec {name!r}; known: {SPEC_IDS}")
    spec = _BUILDERS[name](quick=quick, iters=iters)
    if seeds is not None and seeds != spec.n_seeds:
        spec = dataclasses.replace(spec, n_seeds=seeds).validate()
    return spec
