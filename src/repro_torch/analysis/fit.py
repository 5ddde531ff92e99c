"""Scaling-law fits: the paper's theorems as fitted, testable models
(port of ``repro/analysis/fit.py``, numpy over port artifacts).

Thm 2 gives Hogwild!'s per-worker training cost the shape

    t/m = (1/m + a + b m) * c        i.e.   cost(m) = A/m + B + C m

:func:`fit_cost_curve` least-squares fits that law to a measured cost
curve and :func:`fit_job` adds a bootstrap CI over seeds.
:func:`characters_regression` regresses log2(m_max) on the measured §IV
characters across sweep cells, and :func:`analytic_confidence` turns its
residuals into the advisor service's tier gate.

The module also hosts the vectorized theory-side m_max predictors, one
per `Algorithm.predictor` kind (sync, DADM, Hogwild!, and the
critical-parameter bounds of momentum, local SGD and async-SVRG), each
in a characters-dict form (``*_from_characters``, what the service's
batched path feeds) that the dataset-level ``predict_*_mmax`` wrappers
delegate to.  The scalar loops in `repro_torch.core.scalability` are the
oracles of the first three.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.analysis import stats
from repro_torch.core import metrics as MX

#: predictor search cap, matching the scalar oracles in core.scalability
M_CAP = 4096


# ---------------------------------------------------------------------------
# vectorized theory-side predictors (scalar oracles: core.scalability)
# ---------------------------------------------------------------------------

def sync_mmax(sigma: float, parallel_cost: float = 1e-3,
              m_cap: int = M_CAP) -> int:
    """First m where the Thm-3 gain growth sigma (1/sqrt(m) - 1/sqrt(m+1))
    can no longer cover the parallel cost — the vectorized form of the
    `predict_sync_mmax` while-loop (same answer for every input)."""
    ms = np.arange(1, m_cap, dtype=float)
    stop = sigma * (1.0 / np.sqrt(ms) - 1.0 / np.sqrt(ms + 1.0)) \
        <= parallel_cost
    return int(ms[stop.argmax()]) if stop.any() else m_cap


def dadm_mmax(diversity_ratio: float, parallel_cost: float = 1e-3,
              m_cap: int = M_CAP) -> int:
    """First m where the diversity-limited 1/m gain growth falls below the
    parallel cost (vectorized `predict_dadm_mmax` search)."""
    ms = np.arange(1, m_cap, dtype=float)
    stop = diversity_ratio * (1.0 / ms - 1.0 / (ms + 1.0)) <= parallel_cost
    return int(ms[stop.argmax()]) if stop.any() else m_cap


def hogwild_mmax(omega_frac: float, delta: float, rho: float,
                 m_cap: int = M_CAP) -> int:
    """Largest m whose Thm-2 cost still beats the 1-worker cost, scanning
    contiguously from m=2 (vectorized form of the `predict_hogwild_mmax`
    for/break loop: the first non-improving m stops the scan)."""
    ms = np.arange(2, m_cap + 1, dtype=float)
    cost = 1.0 / ms + 6.0 * rho + 6.0 * ms * omega_frac * math.sqrt(delta)
    c1 = 1.0 + 6.0 * rho + 6.0 * omega_frac * math.sqrt(delta)
    fails = cost >= c1
    if not fails.any():
        return m_cap
    return int(fails.argmax()) + 1          # m before the first failure


def momentum_mmax(sigma: float, beta: float = 0.9,
                  parallel_cost: float = 1e-3, m_cap: int = M_CAP) -> int:
    """Critical batch size under heavy-ball momentum: the buffer already
    geometrically averages ~1/(1-beta) past gradients, consuming part of
    the noise budget batch parallelism would otherwise spend, so the
    Thm-3 gain growth runs on an effective sigma sqrt(1-beta) and the
    cliff moves DOWN with beta (beta=0 recovers :func:`sync_mmax`)."""
    return sync_mmax(sigma * math.sqrt(max(1.0 - beta, 0.0)),
                     parallel_cost, m_cap)


def local_sgd_mmax(sigma: float, sync_every: int = 4,
                   parallel_cost: float = 1e-3, m_cap: int = M_CAP) -> int:
    """Critical worker count under a local-update window: communication is
    paid once per ``sync_every`` local steps, so the per-iteration parallel
    cost divides by the window and the cliff moves UP with it
    (sync_every=1 recovers :func:`sync_mmax`)."""
    return sync_mmax(sigma, parallel_cost / max(int(sync_every), 1), m_cap)


def svrg_mmax(omega_frac: float, delta: float, rho: float,
              theta: float = 0.5, m_cap: int = M_CAP) -> int:
    """Critical staleness under semi-stochastic gradients: near the anchor
    the two point-gradient terms cancel, damping the Thm-2 coordination
    term 6 m omega sqrt(delta) by a variance-reduction factor
    theta in (0, 1] (theta=1 recovers :func:`hogwild_mmax`; theta -> 0 is
    the full-gradient limit with unbounded staleness tolerance)."""
    return hogwild_mmax(omega_frac * min(max(theta, 0.0), 1.0), delta, rho,
                        m_cap)


def predict_sync_from_characters(ch: Dict, *, parallel_cost: float = 1e-3,
                                 m_cap: int = M_CAP) -> Dict:
    """Sync predictor from an already-measured characters dict (the
    batched-service path: `repro_torch.service.tiers` feeds the
    masked-batch characters here, so N probes never re-touch the raw
    data).  The X-level :func:`predict_sync_mmax` delegates here — one
    formula, two entry points, identical answers by construction."""
    sigma = math.sqrt(max(ch["mean_feature_variance"], 1e-12))
    return {"sigma_proxy": sigma, "parallel_cost": parallel_cost,
            "predicted_m_max": sync_mmax(sigma, parallel_cost, m_cap)}


def predict_sync_mmax(X, *, parallel_cost: float = 1e-3,
                      m_cap: int = M_CAP) -> Dict:
    """Dataset-level sync predictor (vectorized `core.scalability` twin)."""
    return predict_sync_from_characters(
        {"mean_feature_variance": MX.mean_feature_variance(X)},
        parallel_cost=parallel_cost, m_cap=m_cap)


def predict_dadm_from_characters(ch: Dict, *, parallel_cost: float = 1e-3,
                                 m_cap: int = M_CAP) -> Dict:
    div = ch["diversity_ratio"]
    return {"diversity_ratio": div, "parallel_cost": parallel_cost,
            "predicted_m_max": dadm_mmax(div, parallel_cost, m_cap)}


def predict_dadm_mmax(X, *, parallel_cost: float = 1e-3,
                      m_cap: int = M_CAP) -> Dict:
    return predict_dadm_from_characters(
        {"diversity_ratio": MX.diversity_ratio(X)},
        parallel_cost=parallel_cost, m_cap=m_cap)


def predict_hogwild_from_characters(ch: Dict, *, m_cap: int = M_CAP) -> Dict:
    hw = {k: ch[k] for k in ("omega", "omega_frac", "delta", "rho")}
    omega_term = hw["omega_frac"] * math.sqrt(hw["delta"])
    m_star = 1.0 / math.sqrt(6.0 * omega_term) if omega_term > 0 else m_cap
    return {**hw, "omega_delta_term": omega_term, "m_star": m_star,
            "predicted_m_max": hogwild_mmax(hw["omega_frac"], hw["delta"],
                                            hw["rho"], m_cap)}


def predict_hogwild_mmax(X, *, m_cap: int = M_CAP) -> Dict:
    return predict_hogwild_from_characters(MX.hogwild_params(X), m_cap=m_cap)


def predict_momentum_from_characters(ch: Dict, *, beta: float = 0.9,
                                     parallel_cost: float = 1e-3,
                                     m_cap: int = M_CAP) -> Dict:
    sigma = math.sqrt(max(ch["mean_feature_variance"], 1e-12))
    return {"sigma_proxy": sigma, "beta": beta,
            "parallel_cost": parallel_cost,
            "predicted_m_max": momentum_mmax(sigma, beta, parallel_cost,
                                             m_cap)}


def predict_momentum_mmax(X, *, beta: float = 0.9,
                          parallel_cost: float = 1e-3,
                          m_cap: int = M_CAP) -> Dict:
    """Dataset-level critical batch size for momentum mini-batch SGD; the
    job's ``beta`` reaches here via the runner's predictor-kwargs pass."""
    return predict_momentum_from_characters(
        {"mean_feature_variance": MX.mean_feature_variance(X)},
        beta=beta, parallel_cost=parallel_cost, m_cap=m_cap)


def predict_local_sgd_from_characters(ch: Dict, *, sync_every: int = 4,
                                      parallel_cost: float = 1e-3,
                                      m_cap: int = M_CAP) -> Dict:
    sigma = math.sqrt(max(ch["mean_feature_variance"], 1e-12))
    return {"sigma_proxy": sigma, "sync_every": int(sync_every),
            "parallel_cost": parallel_cost,
            "predicted_m_max": local_sgd_mmax(sigma, sync_every,
                                              parallel_cost, m_cap)}


def predict_local_sgd_mmax(X, *, sync_every: int = 4,
                           parallel_cost: float = 1e-3,
                           m_cap: int = M_CAP) -> Dict:
    """Dataset-level critical worker count for local SGD at a given sync
    window (the window amortizes the communication cost)."""
    return predict_local_sgd_from_characters(
        {"mean_feature_variance": MX.mean_feature_variance(X)},
        sync_every=sync_every, parallel_cost=parallel_cost, m_cap=m_cap)


def predict_svrg_from_characters(ch: Dict, *, anchor_every: int = 100,
                                 m_cap: int = M_CAP) -> Dict:
    """Needs the Thm-2 params plus ``n`` (the epoch length that sets the
    variance-reduction factor theta = H / (H + n))."""
    hw = {k: ch[k] for k in ("omega", "omega_frac", "delta", "rho")}
    theta = anchor_every / (anchor_every + ch["n"])
    return {**hw, "anchor_every": int(anchor_every), "theta": theta,
            "predicted_m_max": svrg_mmax(hw["omega_frac"], hw["delta"],
                                         hw["rho"], theta, m_cap)}


def predict_svrg_mmax(X, *, anchor_every: int = 100,
                      m_cap: int = M_CAP) -> Dict:
    """Dataset-level critical staleness for async-SVRG.  The variance-
    reduction factor interpolates with the anchor period H relative to the
    epoch length n: theta = H / (H + n) — a fresh anchor every step
    (H -> 0) is the full-gradient limit, a never-refreshed anchor
    (H -> inf) degenerates to raw Hogwild!."""
    return predict_svrg_from_characters(
        {**MX.hogwild_params(X), "n": X.shape[0]},
        anchor_every=anchor_every, m_cap=m_cap)


#: characters-dict predictor per kind — what `repro_torch.service.tiers` and any
#: other batched-characters consumer dispatches through (the X-level
#: ``predict_*_mmax`` wrappers above delegate to these, so both entry
#: points give identical answers for identical characters)
PREDICTORS_FROM_CHARACTERS = {
    "sync": predict_sync_from_characters,
    "dadm": predict_dadm_from_characters,
    "hogwild": predict_hogwild_from_characters,
    "momentum": predict_momentum_from_characters,
    "local_sgd": predict_local_sgd_from_characters,
    "svrg": predict_svrg_from_characters,
}


# ---------------------------------------------------------------------------
# measured-cost-curve fits (Thm 2 / Thm 3 shape)
# ---------------------------------------------------------------------------

def _law_mmax(A: float, B: float, C: float, m_cap: int = M_CAP) -> int:
    """Largest m whose fitted cost A/m + B + C m still beats the 1-worker
    cost, same contiguous-scan semantics as the theory-side predictors.
    A non-positive coordination term C means the fitted law never turns
    up within the cap."""
    ms = np.arange(2, m_cap + 1, dtype=float)
    fails = A / ms + B + C * ms >= A + B + C
    if not fails.any():
        return m_cap
    return int(fails.argmax()) + 1


def fit_cost_curve(ms: Sequence[int], costs: Sequence[float], *,
                   m_cap: int = M_CAP) -> Dict:
    """Least-squares fit of cost(m) = A/m + B + C m to a measured curve.

    Returns the raw coefficients, the paper's (a, b, c) parameterization
    of ``t/m = (1/m + a + b m) c`` (c = A, a = B/A, b = C/A), the analytic
    interior minimum ``m_star = sqrt(A/C)``, the integer ``fitted_m_max``
    (largest m still beating the 1-worker fitted cost, scanned like the
    theory predictors), the fitted curve, and R^2.
    """
    ms_arr = np.asarray(ms, dtype=float)
    y = np.asarray(costs, dtype=float)
    F = np.stack([1.0 / ms_arr, np.ones_like(ms_arr), ms_arr], axis=1)
    coef, *_ = np.linalg.lstsq(F, y, rcond=None)
    A, B, C = (float(v) for v in coef)
    pred = F @ coef
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    m_star = math.sqrt(A / C) if A > 0 and C > 0 else math.inf
    return {"A": A, "B": B, "C": C,
            "c": A, "a": B / A if A else math.nan,
            "b": C / A if A else math.nan,
            "m_star": m_star, "fitted_m_max": _law_mmax(A, B, C, m_cap),
            "r2": r2, "fitted": pred.tolist()}


def fit_job(job: Dict, *, probe_m: int, frac: float,
            asynchronous: Optional[bool] = None, m_cap: int = M_CAP,
            ci: float = stats.CI, n_boot: int = stats.N_BOOT,
            rng_seed: int = 0) -> Dict:
    """Fit the cost law to a job's seed-mean cost curve, with a bootstrap
    CI over ``fitted_m_max`` (resample seeds, re-average, refit)."""
    costs = stats.cost_samples(job, asynchronous=asynchronous,
                               probe_m=probe_m, frac=frac)   # (seeds, S)
    ms = [int(m) for m in job["ms"]]
    out = fit_cost_curve(ms, costs.mean(axis=0), m_cap=m_cap)
    n_seeds = costs.shape[0]
    if n_seeds > 1:
        idx = stats._resample(np.random.default_rng(rng_seed), n_seeds,
                              n_boot)
        samples = np.array([
            fit_cost_curve(ms, costs[i].mean(axis=0),
                           m_cap=m_cap)["fitted_m_max"] for i in idx])
    else:
        samples = np.array([out["fitted_m_max"]])
    lo, hi = stats._ci_bounds(samples, ci)
    out.update(fitted_m_max_lo=int(lo), fitted_m_max_hi=int(hi),
               fitted_m_max_median=int(np.median(samples)),
               ci=ci, n_seeds=n_seeds)
    return out


# ---------------------------------------------------------------------------
# characters -> m_max regression (the thesis as a fitted model)
# ---------------------------------------------------------------------------

#: character keys regressed on (order fixes the coefficient layout)
REGRESSION_FEATURES = ("log10_variance", "sparsity", "diversity_ratio")


def collect_character_points(results: Iterable[Dict]) -> List[Dict]:
    """Harvest (characters, m_max) points from `run_sweep` results — every
    *healthy* job with a cost readout contributes one point, using the
    bootstrap point estimate when the job carries seed replicates and the
    scalar seed-0 bound otherwise.  Diverged/failed jobs (the runner's
    ``status`` field) are excluded — one NaN curve must not bend the
    regression for its healthy neighbors."""
    points = []
    for result in results:
        eps = (result.get("spec") or {}).get("epsilon") or {}
        for key, jr in result.get("jobs", {}).items():
            status = str(jr.get("status", "ok"))
            if not (status == "ok" or status.startswith("retried")):
                continue
            if "measured_m_max" not in jr:
                continue
            ch = result["datasets"][jr["dataset"]].get("characters")
            if not ch:
                continue
            m_max = jr["measured_m_max"]
            if jr.get("n_seeds", 1) > 1:
                m_max = stats.mmax_bootstrap(
                    jr, probe_m=eps.get("probe_m", jr["ms"][0]),
                    frac=eps.get("frac", 0.7))["m_max"]
            points.append({"sweep": result.get("name", "?"), "job": key,
                           "characters": ch, "m_max": int(m_max),
                           "predicted_m_max": (jr.get("predicted") or {})
                           .get("predicted_m_max")})
    return points


def characters_regression(points: Sequence[Dict]) -> Optional[Dict]:
    """Linear regression log2(m_max) ~ 1 + log10(variance) + sparsity +
    diversity_ratio across sweep cells.  Needs more points than
    coefficients; returns None otherwise.  The paper's claim says variance
    should push the bound up for the sync algorithms and duplication pull
    it down — here those are fitted signs with an R^2, testable."""
    if len(points) < len(REGRESSION_FEATURES) + 2:
        return None
    rows, y = [], []
    for p in points:
        ch = p["characters"]
        rows.append([1.0,
                     math.log10(max(ch["mean_feature_variance"], 1e-12)),
                     ch["sparsity"], ch["diversity_ratio"]])
        y.append(math.log2(max(p["m_max"], 1)))
    X = np.asarray(rows)
    y = np.asarray(y)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    pred = X @ coef
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return {"n_points": len(points),
            "coef": {name: float(c) for name, c in
                     zip(("intercept",) + REGRESSION_FEATURES, coef)},
            "r2": 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0,
            "predicted_log2_mmax": pred.tolist(),
            # residual scale + fitted-cloud envelope, the inputs of
            # `analytic_confidence` (log2 units: rmse 1 = a factor-2
            # miss on m_max)
            "residual_rmse": math.sqrt(ss_res / len(points)),
            "feature_mean": {name: float(X[:, i + 1].mean()) for i, name
                             in enumerate(REGRESSION_FEATURES)},
            "feature_std": {name: float(X[:, i + 1].std()) for i, name
                            in enumerate(REGRESSION_FEATURES)}}


# ---------------------------------------------------------------------------
# analytic-tier confidence (the service's early-exit gate)
# ---------------------------------------------------------------------------

#: confidence assigned to an analytic answer when no characters->m_max
#: regression history exists yet — the theory predictors are the only
#: evidence, so this is a prior, not a measurement (`repro_torch.service`
#: escalates below its threshold; the default threshold sits under this
#: prior, so a fresh service trusts the theory until history says not to)
CONFIDENCE_PRIOR = 0.75


def _regression_features(ch: Dict) -> Dict[str, float]:
    return {"log10_variance":
            math.log10(max(ch["mean_feature_variance"], 1e-12)),
            "sparsity": ch["sparsity"],
            "diversity_ratio": ch["diversity_ratio"]}


def analytic_confidence(model: Optional[Dict], ch: Dict) -> Dict:
    """How much to trust an *analytic* (predictor-only) answer for a
    dataset with characters ``ch``, derived from the characters->m_max
    regression residuals (:func:`characters_regression` over the measured
    sweeps already in the artifact cache):

      confidence = clip(R^2, 0, 1) * exp(-residual_rmse)
                   * exp(-max(z - 2, 0) / 2)

    — the regression's explanatory power, discounted by its residual
    scale (rmse in log2(m_max): a 1-bit typical miss costs e^-1) and by
    extrapolation (z = the character point's largest |z-score| against
    the fitted cloud; inside 2 sigma is free, beyond decays).  With no
    model (an empty cache) the answer is the :data:`CONFIDENCE_PRIOR`.
    Deterministic and unit-tested — the service's tier gate, not a
    calibrated probability."""
    if model is None:
        return {"confidence": CONFIDENCE_PRIOR, "source": "prior",
                "detail": "no measured characters->m_max history yet"}
    feats = _regression_features(ch)
    z = 0.0
    for name, v in feats.items():
        std = model["feature_std"].get(name, 0.0)
        mean = model["feature_mean"].get(name, 0.0)
        if std <= 1e-9:
            z = max(z, 0.0 if abs(v - mean) <= 1e-9 else math.inf)
        else:
            z = max(z, abs(v - mean) / std)
    r2 = min(max(model["r2"], 0.0), 1.0)
    rmse = model["residual_rmse"]
    conf = r2 * math.exp(-rmse) * math.exp(-max(z - 2.0, 0.0) / 2.0)
    coef = model["coef"]
    log2_mmax = coef["intercept"] + sum(
        coef[name] * v for name, v in feats.items())
    return {"confidence": float(conf), "source": "regression",
            "r2": r2, "residual_rmse": rmse, "extrapolation_z": float(z),
            "n_points": model["n_points"],
            "regression_log2_mmax": float(log2_mmax)}
