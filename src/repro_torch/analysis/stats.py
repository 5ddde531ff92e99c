"""Seed-replicated sweep statistics (port of ``repro/analysis/stats.py``;
numpy over the plain-dict job results of `experiments.runner.run_sweep`).

  `curve_stats`     per-(job, m) mean / std / bootstrap-CI loss curves
  `cost_samples`    the (n_seeds, S) per-worker cost block under the
                    paper's probe-epsilon policy, applied within-seed
  `mmax_bootstrap`  the bootstrap distribution of the measured m_max —
                    resample seeds, average cost curves, re-read §V.B

``losses`` is a job's seed-0 curve block and ``losses_seeds`` — present
when the spec ran with ``n_seeds > 1`` — the full (S, n_seeds, n_evals)
replicate block.  The vectorized §V helpers here have the scalar
oracles of `repro_torch.core.scalability`.  Bootstrap draws use a fixed
`numpy.random.default_rng` seed, so reports are reproducible.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.algorithms import base as alg_base

#: default bootstrap resamples / confidence level for the CI helpers
N_BOOT = 400
CI = 0.95


# ---------------------------------------------------------------------------
# views over job results
# ---------------------------------------------------------------------------

def seed_curves(job: Dict) -> np.ndarray:
    """(n_seeds, S, n_evals) float view of a job's loss curves.

    Single-seed results (no ``losses_seeds`` key — any pre-ENGINE_VERSION-4
    artifact, or ``n_seeds=1``) come back with a length-1 seed axis, so
    every statistic below degrades gracefully to the point estimate.
    """
    if "losses_seeds" in job:
        arr = np.asarray(job["losses_seeds"], dtype=float)  # (S, seeds, E)
        return np.moveaxis(arr, 1, 0)
    return np.asarray(job["losses"], dtype=float)[None]


def _async_flag(job: Dict, asynchronous: Optional[bool]) -> bool:
    """Resolve the §V.A.1 cost-division flag off the Algorithm registry
    when the caller doesn't pass it."""
    if asynchronous is not None:
        return asynchronous
    return alg_base.get_algorithm(job["algorithm"]).asynchronous


# ---------------------------------------------------------------------------
# vectorized §V measurement helpers (scalar oracles: core.scalability)
# ---------------------------------------------------------------------------

def iterations_to_epsilon(losses, eval_every: int, epsilon) -> np.ndarray:
    """Server iterations until loss <= epsilon, vectorized over leading
    axes of ``losses`` (..., n_evals); ``epsilon`` may be a scalar or an
    array aligned with the LEADING axes (e.g. shape (n_seeds,) against
    curves (n_seeds, S, n_evals) — one epsilon per seed).  inf where never
    hit — parity with `core.scalability.iterations_to_epsilon` per curve."""
    L = np.asarray(losses, dtype=float)
    eps = np.asarray(epsilon, dtype=float)
    if eps.ndim > L.ndim:
        raise ValueError(f"epsilon shape {eps.shape} has more axes than "
                         f"losses shape {L.shape}")
    # pad trailing axes so eps aligns with the leading axes of L, never
    # with the grid/eval axes
    eps = eps.reshape(eps.shape + (1,) * (L.ndim - eps.ndim))
    hit = L <= eps
    first = hit.argmax(axis=-1)
    return np.where(hit.any(axis=-1), (first + 1.0) * eval_every, np.inf)


def cost_per_worker(iters_to_eps, ms, asynchronous: bool) -> np.ndarray:
    """§V.A.1 cost: async algorithms divide server iterations among the
    workers (the Perfect Computer Assumption); ``ms`` broadcasts against
    the trailing grid axis."""
    it = np.asarray(iters_to_eps, dtype=float)
    return it / np.asarray(ms, dtype=float) if asynchronous else it


def gain_growth(costs) -> np.ndarray:
    """cost_m - cost_{m+1} along the trailing grid axis (positive =
    still gaining)."""
    c = np.asarray(costs, dtype=float)
    return c[..., :-1] - c[..., 1:]


def measured_upper_bound(ms: Sequence[int], gain_growths,
                         threshold: float = 0.0) -> np.ndarray:
    """First m whose gain growth drops to <= threshold (the lower of the
    paper's 'between two red values'), vectorized over leading axes of
    ``gain_growths``; ``ms`` aligns with its trailing axis and ``ms[-1]``
    is the not-reached fallback, exactly like the scalar oracle."""
    gg = np.asarray(gain_growths, dtype=float)
    ms = np.asarray(ms)
    below = gg <= threshold
    idx = below.argmax(axis=-1)
    return np.where(below.any(axis=-1), ms[idx], ms[-1])


# ---------------------------------------------------------------------------
# seed-replicated readouts
# ---------------------------------------------------------------------------

def epsilon_per_seed(job: Dict, probe_m: int, frac: float) -> np.ndarray:
    """Paper Table II policy applied within-seed: each replicate's epsilon
    is the loss *its own* probe_m-worker run reaches after ``frac`` of the
    eval budget (seed 0 therefore equals the runner's scalar
    ``job["epsilon"]``)."""
    curves = seed_curves(job)                       # (seeds, S, E)
    si = list(job["ms"]).index(probe_m)
    idx = min(int(curves.shape[-1] * frac), curves.shape[-1] - 1)
    return curves[:, si, idx]


def cost_samples(job: Dict, *, asynchronous: Optional[bool] = None,
                 probe_m: Optional[int] = None, frac: Optional[float] = None,
                 epsilon: Optional[float] = None) -> np.ndarray:
    """The (n_seeds, S) per-worker cost block.

    Epsilon policy: a shared scalar ``epsilon``, or the per-seed probe
    policy via ``probe_m``/``frac`` (mirroring the spec's `EpsilonSpec`).
    Never-reached costs clamp to the iteration budget, matching the
    runner's scalar readout.
    """
    if epsilon is None:
        if probe_m is None or frac is None:
            raise ValueError("pass either epsilon= or probe_m=/frac=")
        eps = epsilon_per_seed(job, probe_m, frac)   # (n_seeds,) per seed
    else:
        eps = float(epsilon)
    it = iterations_to_epsilon(seed_curves(job), job["eval_every"], eps)
    costs = cost_per_worker(it, job["ms"], _async_flag(job, asynchronous))
    return np.where(np.isfinite(costs), costs, float(job["iters"]))


def _resample(rng: np.random.Generator, n: int, n_boot: int) -> np.ndarray:
    return rng.integers(0, n, size=(n_boot, n))


def _ci_bounds(samples: np.ndarray, ci: float):
    lo_q = 100.0 * (1.0 - ci) / 2.0
    return (np.percentile(samples, lo_q, axis=0),
            np.percentile(samples, 100.0 - lo_q, axis=0))


def curve_stats(job: Dict, *, ci: float = CI, n_boot: int = N_BOOT,
                rng_seed: int = 0) -> Dict:
    """Per-(m, eval) statistics of the loss curves over the seed axis:
    mean, std (ddof=1 when replicated), and a bootstrap CI of the mean.
    All arrays are (S, n_evals) lists, row-aligned with ``job["ms"]``."""
    curves = seed_curves(job)                       # (seeds, S, E)
    n_seeds = curves.shape[0]
    mean = curves.mean(axis=0)
    std = (curves.std(axis=0, ddof=1) if n_seeds > 1
           else np.zeros_like(mean))
    if n_seeds > 1:
        idx = _resample(np.random.default_rng(rng_seed), n_seeds, n_boot)
        boot = curves[idx].mean(axis=1)             # (n_boot, S, E)
        lo, hi = _ci_bounds(boot, ci)
    else:
        lo = hi = mean
    return {"ms": [int(m) for m in job["ms"]], "n_seeds": n_seeds,
            "ci": ci, "mean": mean.tolist(), "std": std.tolist(),
            "lo": lo.tolist(), "hi": hi.tolist()}


def mmax_bootstrap(job: Dict, *, probe_m: int, frac: float,
                   asynchronous: Optional[bool] = None,
                   threshold: float = 0.0, ci: float = CI,
                   n_boot: int = N_BOOT, rng_seed: int = 0) -> Dict:
    """Bootstrap distribution of the measured scalability upper bound.

    Each resample draws seeds with replacement, averages their per-worker
    cost curves, and re-reads the §V.B bound off the averaged curve — the
    replication Stich et al. (2021) show these crossover points need
    before they stabilize.  Returns the point estimate (all-seed mean
    curve), per-seed bounds, the bootstrap samples' CI, and the
    distribution as {m: fraction of resamples}.
    """
    costs = cost_samples(job, asynchronous=asynchronous,
                         probe_m=probe_m, frac=frac)       # (seeds, S)
    ms = [int(m) for m in job["ms"]]
    grid = ms[:-1]                                  # gain growth pairs

    def bound_of(c):
        return measured_upper_bound(grid, gain_growth(c), threshold)

    point = int(bound_of(costs.mean(axis=0)))
    per_seed = bound_of(costs).astype(int)          # (seeds,) row-wise
    n_seeds = costs.shape[0]
    if n_seeds > 1:
        idx = _resample(np.random.default_rng(rng_seed), n_seeds, n_boot)
        samples = bound_of(costs[idx].mean(axis=1)).astype(int)
    else:
        samples = np.array([point])
    lo, hi = _ci_bounds(samples, ci)
    values, counts = np.unique(samples, return_counts=True)
    return {"m_max": point, "lo": int(lo), "hi": int(hi), "ci": ci,
            "median": int(np.median(samples)),
            "per_seed": per_seed.tolist(), "n_seeds": n_seeds,
            "distribution": {int(v): float(c) / samples.size
                             for v, c in zip(values, counts)},
            "cost_mean": costs.mean(axis=0).tolist(),
            "cost_std": (costs.std(axis=0, ddof=1) if n_seeds > 1
                         else np.zeros(costs.shape[1])).tolist()}
