"""Vectorized theory-side m_max predictors (the three the ``upper_bound``
slice runs, ported from ``repro/analysis/fit.py``).  The scalar loops in
`repro_torch.core.scalability` are their oracles."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from repro_torch.core import metrics as MX

#: predictor search cap, matching the scalar oracles in core.scalability
M_CAP = 4096


def sync_mmax(sigma: float, parallel_cost: float = 1e-3,
              m_cap: int = M_CAP) -> int:
    """First m where sigma (1/sqrt(m) - 1/sqrt(m+1)) <= parallel cost."""
    ms = np.arange(1, m_cap, dtype=float)
    stop = sigma * (1.0 / np.sqrt(ms) - 1.0 / np.sqrt(ms + 1.0)) \
        <= parallel_cost
    return int(ms[stop.argmax()]) if stop.any() else m_cap


def dadm_mmax(diversity_ratio: float, parallel_cost: float = 1e-3,
              m_cap: int = M_CAP) -> int:
    """First m where the diversity-limited 1/m gain growth falls below the
    parallel cost."""
    ms = np.arange(1, m_cap, dtype=float)
    stop = diversity_ratio * (1.0 / ms - 1.0 / (ms + 1.0)) <= parallel_cost
    return int(ms[stop.argmax()]) if stop.any() else m_cap


def hogwild_mmax(omega_frac: float, delta: float, rho: float,
                 m_cap: int = M_CAP) -> int:
    """Largest m whose Thm-2 cost still beats the 1-worker cost, scanning
    contiguously from m=2."""
    ms = np.arange(2, m_cap + 1, dtype=float)
    cost = 1.0 / ms + 6.0 * rho + 6.0 * ms * omega_frac * math.sqrt(delta)
    c1 = 1.0 + 6.0 * rho + 6.0 * omega_frac * math.sqrt(delta)
    fails = cost >= c1
    if not fails.any():
        return m_cap
    return int(fails.argmax()) + 1          # m before the first failure


def predict_sync_mmax(X, *, parallel_cost: float = 1e-3,
                      m_cap: int = M_CAP) -> Dict:
    sigma = math.sqrt(max(MX.mean_feature_variance(X), 1e-12))
    return {"sigma_proxy": sigma, "parallel_cost": parallel_cost,
            "predicted_m_max": sync_mmax(sigma, parallel_cost, m_cap)}


def predict_dadm_mmax(X, *, parallel_cost: float = 1e-3,
                      m_cap: int = M_CAP) -> Dict:
    div = MX.diversity_ratio(X)
    return {"diversity_ratio": div, "parallel_cost": parallel_cost,
            "predicted_m_max": dadm_mmax(div, parallel_cost, m_cap)}


def predict_hogwild_mmax(X, *, m_cap: int = M_CAP) -> Dict:
    hw = MX.hogwild_params(X)
    omega_term = hw["omega_frac"] * math.sqrt(hw["delta"])
    m_star = 1.0 / math.sqrt(6.0 * omega_term) if omega_term > 0 else m_cap
    return {**hw, "omega_delta_term": omega_term, "m_star": m_star,
            "predicted_m_max": hogwild_mmax(hw["omega_frac"], hw["delta"],
                                            hw["rho"], m_cap)}
