"""Gain / gain-growth / upper-bound machinery, paper §V (port of
``repro/core/scalability.py``).

  cost        = iterations per worker to reach a fixed epsilon
  gain growth = cost difference between m and the next m of the grid
  m_max       = first m whose gain growth drops to <= threshold

Theory side (Thm 2): Hogwild!'s per-worker cost has the shape
1/m + 6 rho + 6 m Omega delta^{1/2}.  These are the scalar single-curve
oracles; the runner's predictors are the vectorized scans in
`repro_torch.analysis.fit`.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from repro_torch.core import metrics as MX


# ---------------------------------------------------------------------------
# Measurement side
# ---------------------------------------------------------------------------

def iterations_to_epsilon(losses, eval_every: int, epsilon: float) -> float:
    """Server iterations until test loss <= epsilon (inf if never)."""
    hits = np.nonzero(np.asarray(losses) <= epsilon)[0]
    if len(hits) == 0:
        return math.inf
    return float((hits[0] + 1) * eval_every)


def cost_per_worker(result: Dict, epsilon: float, *, asynchronous: bool):
    """The paper's 'cost': iterations each worker performs to reach eps.
    Async algorithms divide server iterations among workers (§V.A.1)."""
    it = iterations_to_epsilon(result["losses"], result["eval_every"], epsilon)
    return it / result["m"] if asynchronous else it


def gain_growth_from_costs(costs: List[float]) -> List[float]:
    """cost_m - cost_{m+1} (positive = still gaining)."""
    return [costs[i] - costs[i + 1] for i in range(len(costs) - 1)]


def gain_growth_from_losses(results: List[Dict], at_iteration: int):
    """First definition: loss(m) - loss(m+1) at a fixed server iteration.

    The eval index clamps to [0, n_evals): iterations below one eval
    period read the first eval and iterations beyond the budget read the
    last."""
    vals = []
    for r in results:
        i = min(at_iteration // r["eval_every"], len(r["losses"])) - 1
        vals.append(float(r["losses"][max(i, 0)]))
    return [vals[i] - vals[i + 1] for i in range(len(vals) - 1)]


def measured_upper_bound(ms: List[int], gain_growths: List[float],
                         threshold: float = 0.0) -> int:
    """First m whose gain growth drops to <= threshold (the lower of the
    paper's 'two red values'); the last m if the bound is not reached."""
    for i, g in enumerate(gain_growths):
        if g <= threshold:
            return ms[i]
    return ms[-1]


# ---------------------------------------------------------------------------
# Theory side (dataset characters -> predicted m_max)
# ---------------------------------------------------------------------------

def hogwild_cost_model(m, omega, delta, rho):
    """Thm 2 per-worker cost shape: 1/m + 6 rho + 6 m Omega delta^{1/2}."""
    return 1.0 / m + 6.0 * rho + 6.0 * m * omega * math.sqrt(delta)


def predict_hogwild_mmax(X, *, m_cap=4096) -> Dict:
    """Dataset -> predicted Hogwild! scalability upper bound."""
    hw = MX.hogwild_params(X)
    omega_term = hw["omega_frac"] * math.sqrt(hw["delta"])
    m_star = 1.0 / math.sqrt(6.0 * omega_term) if omega_term > 0 else m_cap
    args = (hw["omega_frac"], hw["delta"], hw["rho"])
    c1 = hogwild_cost_model(1, *args)
    m_max = 1
    for m in range(2, m_cap + 1):
        if hogwild_cost_model(m, *args) < c1:
            m_max = m
        else:
            break
    return {**hw, "omega_delta_term": omega_term,
            "m_star": m_star, "predicted_m_max": m_max}


def predict_sync_gain_growth(m, variance_proxy):
    """Thm 3/4: gain growth sigma (1/sqrt(m) - 1/sqrt(m+1))."""
    return variance_proxy * (1.0 / math.sqrt(m) - 1.0 / math.sqrt(m + 1))


def predict_sync_mmax(X, *, parallel_cost=1e-3, m_cap=4096) -> Dict:
    """Mini-batch SGD / ECD-PSGD: m_max where the variance-driven gain
    growth can no longer cover the parallel cost."""
    sigma = math.sqrt(max(MX.mean_feature_variance(X), 1e-12))
    m = 1
    while m < m_cap and predict_sync_gain_growth(m, sigma) > parallel_cost:
        m += 1
    return {"sigma_proxy": sigma, "parallel_cost": parallel_cost,
            "predicted_m_max": m}


def predict_dadm_mmax(X, *, parallel_cost=1e-3, m_cap=4096) -> Dict:
    """DADM gain ~ 1/m scaled by the diversity ratio."""
    div = MX.diversity_ratio(X)
    m = 1
    while m < m_cap and div * (1.0 / m - 1.0 / (m + 1)) > parallel_cost:
        m += 1
    return {"diversity_ratio": div, "parallel_cost": parallel_cost,
            "predicted_m_max": m}
