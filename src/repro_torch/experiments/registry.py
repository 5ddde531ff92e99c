"""Named sweep specs (port of ``repro/experiments/registry.py``), one per
paper figure or table, giving the same spec dicts:

  ``variance_sparsity``   Figs 3-5   dense-vs-sparse on minibatch/ECD/Hogwild!
  ``diversity``           Fig 6      duplication variants on DADM/minibatch
  ``ls``                  Figs 7-10  C_sim-controlled sequences, no shuffle
  ``upper_bound``         Table II   cost-per-worker m_max sweep + predictions
  ``scalability_study``   end-to-end characters + m=1 vs m=8 study
  ``problem_generality``  ridge and hinge on the label-noise and
                          heavy-tailed dataset variants
  ``character_surface``   the `character_knob` generator swept over
                          variance x density x duplication, seed-replicated
  ``critical_params``     momentum lr x local-SGD sync window x async-SVRG
                          anchor period at two dataset-character settings
  ``fault_tolerance``     Hogwild! and local SGD under seeded delivery
                          faults (straggle + sign-flip)

`get_spec` threads the ``iters`` / ``n`` / ``seeds`` overrides through
every spec.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.experiments.spec import (DatasetSpec, EpsilonSpec, JobSpec,
                                          SweepSpec)


def _variance_sparsity(quick=False, iters: Optional[int] = None,
                       n: Optional[int] = None) -> SweepSpec:
    iters = iters if iters is not None else (600 if quick else 1500)
    n = n if n is not None else (1000 if quick else 2000)
    datasets = {
        "higgs_like": DatasetSpec("higgs_like", {"n": n, "d": 28}),
        "realsim_like": DatasetSpec("realsim_like",
                                    {"n": n, "d": 400, "density": 0.05}),
    }
    jobs = tuple(JobSpec(algo, ds)
                 for ds in ("higgs_like", "realsim_like")
                 for algo in ("minibatch", "ecd_psgd", "hogwild"))
    return SweepSpec(
        name="variance_sparsity",
        description="Figs 3-5: feature-variance & sparsity vs parallel gain",
        ms=(1, 2, 4, 8), iters=iters, eval_every=iters // 10,
        datasets=datasets, jobs=jobs).validate()


def _diversity(quick=False, iters: Optional[int] = None,
               n: Optional[int] = None) -> SweepSpec:
    iters = iters if iters is not None else (400 if quick else 800)
    n = n if n is not None else (800 if quick else 1600)
    base = {"n": n, "d": 300, "density": 0.05}
    datasets = {v: DatasetSpec("realsim_like", base, variant=v)
                for v in ("high", "mid", "low")}
    jobs = tuple(JobSpec(algo, ds)
                 for ds in ("high", "mid", "low")
                 for algo in ("dadm", "minibatch"))
    return SweepSpec(
        name="diversity",
        description="Fig 6: sample-diversity duplication variants",
        ms=(1, 4, 16), iters=iters, eval_every=iters // 8,
        datasets=datasets, jobs=jobs).validate()


def _ls(quick=False, iters: Optional[int] = None,
        n: Optional[int] = None) -> SweepSpec:
    iters = iters if iters is not None else (500 if quick else 1200)
    n = n if n is not None else (1000 if quick else 2400)
    sparse = {"d": 200, "density": 0.05, "lo": 0, "hi": 1}
    datasets = {
        "small_ls_dense": DatasetSpec(
            "ls_sequence", {"n": n, "d": 28, "mutate_frac": 0.1},
            shuffle_split=False),
        "large_ls_dense": DatasetSpec(
            "ls_sequence", {"n": n, "d": 28, "mutate_frac": 0.9},
            shuffle_split=False),
        "small_ls_sparse": DatasetSpec(
            "ls_sequence", {"n": n, "mutate_frac": 0.1, **sparse},
            shuffle_split=False),
        "large_ls_sparse": DatasetSpec(
            "ls_sequence", {"n": n, "mutate_frac": 0.9, **sparse},
            shuffle_split=False),
    }
    jobs = tuple([JobSpec(a, ds) for ds in ("small_ls_dense",
                                            "large_ls_dense")
                  for a in ("minibatch", "ecd_psgd")]
                 + [JobSpec(a, ds) for ds in ("small_ls_sparse",
                                              "large_ls_sparse")
                    for a in ("hogwild", "dadm")])
    return SweepSpec(
        name="ls",
        description="Figs 7-10: sampling-sequence similarity (C_sim) sweeps",
        ms=(1, 4, 8), iters=iters, eval_every=iters // 8,
        datasets=datasets, jobs=jobs, measure_csim=8, csim_rows=400,
    ).validate()


def _upper_bound(quick=False, iters: Optional[int] = None,
                 n: Optional[int] = None) -> SweepSpec:
    if n is not None:
        warnings.warn("the upper_bound spec ignores the n override: "
                      "its dataset sizes are fixed by §VII.E")
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


def _scalability_study(quick=False, iters: Optional[int] = None,
                       n: Optional[int] = None) -> SweepSpec:
    iters = (800 if quick else 3000) if iters is None else iters
    n = (1500 if quick else 4000) if n is None else n
    datasets = {
        "higgs_like": DatasetSpec("higgs_like", {"n": n, "d": 28}),
        "realsim_like": DatasetSpec("realsim_like",
                                    {"n": n, "d": 400, "density": 0.05}),
    }
    jobs = tuple(JobSpec(algo, ds, predict=algo in ("hogwild", "minibatch"),
                         predict_rows=800)
                 for ds in ("higgs_like", "realsim_like")
                 for algo in ("minibatch", "hogwild", "ecd_psgd", "dadm"))
    return SweepSpec(
        name="scalability_study",
        description="end-to-end: characters + measured-vs-predicted study",
        ms=(1, 8), iters=iters, eval_every=iters // 8,
        datasets=datasets, jobs=jobs, characters_rows=800).validate()


def _problem_generality(quick=False, iters: Optional[int] = None,
                        n: Optional[int] = None) -> SweepSpec:
    """Stich-et-al-style generality check: the variance/sparsity story under
    ridge and hinge objectives, plus the label-noise and heavy-tailed
    dataset-character variants.  Every cell here reaches the engine purely
    through registry names — no engine edits for new losses or datasets.

    Ridge on the wide-range higgs_like features needs a tiny step size
    (squared-loss curvature ~ mean ||xi||^2), hence the per-job gamma.
    """
    iters = iters if iters is not None else (500 if quick else 1500)
    n = n if n is not None else (1000 if quick else 2000)
    datasets = {
        "higgs_like": DatasetSpec("higgs_like", {"n": n, "d": 28}),
        "noisy": DatasetSpec("label_noise",
                             {"base": "higgs_like", "flip_frac": 0.2,
                              "n": n, "d": 28}),
        "heavy": DatasetSpec("heavy_tailed", {"n": n, "d": 28, "df": 3.0}),
    }
    gammas = {"ridge": 0.003, "hinge": 0.05}
    jobs = tuple(
        JobSpec(algo, ds, kwargs={} if algo == "dadm"
                else {"gamma": gammas[prob]}, problem=prob)
        for ds in ("higgs_like", "noisy", "heavy")
        for prob in ("ridge", "hinge")
        for algo in ("minibatch", "dadm"))
    return SweepSpec(
        name="problem_generality",
        description="dataset characters beyond Eq. 4: ridge/hinge on "
                    "label-noise & heavy-tailed variants",
        ms=(1, 4, 8), iters=iters, eval_every=iters // 10,
        datasets=datasets, jobs=jobs).validate()


def _character_surface(quick=False, iters: Optional[int] = None,
                       n: Optional[int] = None) -> SweepSpec:
    """The paper's thesis as a surface: the `character_knob` generator
    over a (variance, density, duplication) grid, each cell
    seed-replicated, costed and predicted."""
    iters = iters if iters is not None else (400 if quick else 1200)
    n = n if n is not None else (512 if quick else 1536)
    variances = (0.25, 4.0) if quick else (0.25, 1.0, 4.0)
    densities = (0.15, 1.0) if quick else (0.1, 0.5, 1.0)
    dups = (0.0, 0.75) if quick else (0.0, 0.5, 0.75)
    datasets = {}
    for v in variances:
        for p in densities:
            for dup in dups:
                datasets[f"v{v}_p{p}_dup{dup}"] = DatasetSpec(
                    "character_knob",
                    {"n": n, "d": 48, "variance": v, "density": p,
                     "duplication": dup})
    jobs = tuple(JobSpec("minibatch", ds, predict=True) for ds in datasets)
    return SweepSpec(
        name="character_surface",
        description="m_max surface over continuous variance/sparsity/"
                    "diversity knobs (seed-replicated)",
        ms=(1, 2, 4, 8) if quick else (1, 2, 4, 8, 16),
        iters=iters, eval_every=iters // 10,
        datasets=datasets, jobs=jobs,
        epsilon=EpsilonSpec(probe_m=2, frac=0.7),
        # measure characters on EVERY row: character_knob tiles duplicates
        # after the unique head, so a row-capped summary would report
        # diversity_ratio 1.0 for every duplication level and corrupt the
        # characters -> m_max regression
        characters_rows=n,
        n_seeds=3 if quick else 8).validate()


def _critical_params(quick=False, iters: Optional[int] = None,
                     n: Optional[int] = None) -> SweepSpec:
    """The critical-parameter surface (Stich arXiv 2103.02351, Zhang
    arXiv 1508.01633): momentum's step size, local SGD's sync window and
    async-SVRG's anchor period, each swept at two `character_knob`
    settings.  The worker grid is the batch axis for the synchronous pair
    and the staleness axis (tau_max = m) for async-SVRG.  Knob labels
    disambiguate same-cell jobs (`JobSpec.label`); momentum gammas are
    pre-divided by 1/(1-beta) (see `Momentum.gamma_scale`)."""
    iters = iters if iters is not None else (400 if quick else 1200)
    n = n if n is not None else (512 if quick else 1536)
    datasets = {
        "lo_char": DatasetSpec(
            "character_knob",
            {"n": n, "d": 48, "variance": 0.25, "density": 0.5,
             "duplication": 0.75}),
        "hi_char": DatasetSpec(
            "character_knob",
            {"n": n, "d": 48, "variance": 4.0, "density": 1.0,
             "duplication": 0.0}),
    }
    gammas = (0.005, 0.02) if quick else (0.005, 0.01, 0.02)
    windows = (1, 8) if quick else (1, 4, 16)
    anchors = (25, 200) if quick else (25, 100, 400)
    jobs = []
    for ds in datasets:
        for g in gammas:
            jobs.append(JobSpec("momentum", ds, {"gamma": g},
                                predict=True, label=f"g{g}"))
        for w in windows:
            jobs.append(JobSpec("local_sgd", ds,
                                {"gamma": 0.1, "sync_every": w},
                                predict=True, label=f"H{w}"))
        for h in anchors:
            jobs.append(JobSpec("async_svrg", ds,
                                {"gamma": 0.1, "anchor_every": h},
                                predict=True, label=f"A{h}"))
    return SweepSpec(
        name="critical_params",
        description="critical-parameter surface: momentum lr x local-SGD "
                    "sync window x async-SVRG anchor period, per dataset "
                    "character setting",
        ms=(1, 2, 4, 8) if quick else (1, 2, 4, 8, 16),
        iters=iters, eval_every=iters // 10,
        datasets=datasets, jobs=tuple(jobs),
        epsilon=EpsilonSpec(probe_m=2, frac=0.7),
        # duplicates tile after the unique head — measure every row (see
        # _character_surface)
        characters_rows=n,
        n_seeds=3 if quick else 8).validate()


def _fault_tolerance(quick=False, iters: Optional[int] = None,
                     n: Optional[int] = None) -> SweepSpec:
    """Fault injection as a sweep axis: Hogwild! and local SGD under a
    grid of seeded delivery-fault rates (straggling + sign-flipped
    updates, `repro_torch.resilience.faults.FaultSpec`), each at the two
    `character_knob` settings of `critical_params`.  The fault seed is
    pinned, so every cell is reproducible and the seed replicates share
    the fault schedule.  The mix is straggle-dominant (extra staleness is
    capped at tau = m, so the serial probe, hence the epsilon probe
    m = 1, is straggle-immune); rates stop at 0.5; per-dataset step sizes
    equalize the clean baselines.  No predictions: the theory-side bounds
    model staleness, not faulty delivery."""
    iters = iters if iters is not None else (400 if quick else 1200)
    n = n if n is not None else (512 if quick else 1536)
    datasets = {
        "lo_char": DatasetSpec(
            "character_knob",
            {"n": n, "d": 48, "variance": 0.25, "density": 0.5,
             "duplication": 0.75}),
        "hi_char": DatasetSpec(
            "character_knob",
            {"n": n, "d": 48, "variance": 4.0, "density": 1.0,
             "duplication": 0.0}),
    }
    rates = (0.0, 0.25, 0.5) if quick else (0.0, 0.125, 0.25, 0.5)
    hogwild_gamma = {"lo_char": 0.1, "hi_char": 0.05}
    local_gamma = {"lo_char": 0.2, "hi_char": 0.1}
    jobs = []
    for ds in datasets:
        for rate in rates:
            fault = {"straggle_rate": rate, "straggle_rounds": 8,
                     "corrupt_rate": rate / 2,
                     "corrupt_kind": "sign_flip", "seed": 7}
            jobs.append(JobSpec("hogwild", ds,
                                {"gamma": hogwild_gamma[ds],
                                 "fault": fault},
                                label=f"f{rate}"))
            jobs.append(JobSpec("local_sgd", ds,
                                {"gamma": local_gamma[ds], "sync_every": 2,
                                 "fault": fault},
                                label=f"f{rate}"))
    return SweepSpec(
        name="fault_tolerance",
        description="measured m_max degradation vs injected fault rate "
                    "(straggle + sign-flip), per dataset character setting",
        ms=(1, 2, 3, 4, 6, 8) if quick else (1, 2, 3, 4, 6, 8, 12, 16),
        iters=iters, eval_every=iters // 10,
        datasets=datasets, jobs=tuple(jobs),
        epsilon=EpsilonSpec(probe_m=1, frac=0.7),
        # duplicates tile after the unique head — measure every row (see
        # _character_surface)
        characters_rows=n,
        n_seeds=3 if quick else 8).validate()


_BUILDERS = {
    "variance_sparsity": _variance_sparsity,
    "diversity": _diversity,
    "ls": _ls,
    "upper_bound": _upper_bound,
    "scalability_study": _scalability_study,
    "problem_generality": _problem_generality,
    "character_surface": _character_surface,
    "critical_params": _critical_params,
    "fault_tolerance": _fault_tolerance,
}

SPEC_IDS = sorted(_BUILDERS)


def get_spec(name: str, *, quick: bool = False,
             iters: Optional[int] = None,
             n: Optional[int] = None,
             seeds: Optional[int] = None) -> SweepSpec:
    """Resolve a named spec (``quick`` folds in CI-scale constants);
    ``iters`` and ``n`` override the budget and the dataset size,
    ``seeds`` the spec's ``n_seeds``."""
    if name not in _BUILDERS:
        raise KeyError(f"unknown sweep spec {name!r}; known: {SPEC_IDS}")
    spec = _BUILDERS[name](quick=quick, iters=iters, n=n)
    if seeds is not None and seeds != spec.n_seeds:
        spec = dataclasses.replace(spec, n_seeds=seeds).validate()
    return spec
