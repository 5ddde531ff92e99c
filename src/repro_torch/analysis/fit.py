"""Vectorized theory-side m_max predictors (ported from
``repro/analysis/fit.py``): one per `Algorithm.predictor` kind — sync,
DADM, Hogwild!, and the critical-parameter bounds of momentum, local SGD
and async-SVRG, which rescale the first and third.  The scalar loops in
`repro_torch.core.scalability` are the oracles of the first three."""

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


def momentum_mmax(sigma: float, beta: float = 0.9,
                  parallel_cost: float = 1e-3, m_cap: int = M_CAP) -> int:
    """Critical batch size under heavy-ball momentum: the sync bound on an
    effective sigma sqrt(1 - beta) (beta = 0 is :func:`sync_mmax`)."""
    return sync_mmax(sigma * math.sqrt(max(1.0 - beta, 0.0)),
                     parallel_cost, m_cap)


def local_sgd_mmax(sigma: float, sync_every: int = 4,
                   parallel_cost: float = 1e-3, m_cap: int = M_CAP) -> int:
    """Critical worker count under a local-update window: the parallel
    cost divides by the window (sync_every = 1 is :func:`sync_mmax`)."""
    return sync_mmax(sigma, parallel_cost / max(int(sync_every), 1), m_cap)


def svrg_mmax(omega_frac: float, delta: float, rho: float,
              theta: float = 0.5, m_cap: int = M_CAP) -> int:
    """Critical staleness under semi-stochastic gradients: Thm 2's
    coordination term damped by theta in (0, 1] (theta = 1 is
    :func:`hogwild_mmax`)."""
    return hogwild_mmax(omega_frac * min(max(theta, 0.0), 1.0), delta, rho,
                        m_cap)


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
    """Dataset-level critical batch size of momentum mini-batch SGD."""
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
    """Dataset-level critical worker count of local SGD at a window."""
    return predict_local_sgd_from_characters(
        {"mean_feature_variance": MX.mean_feature_variance(X)},
        sync_every=sync_every, parallel_cost=parallel_cost, m_cap=m_cap)


def predict_svrg_from_characters(ch: Dict, *, anchor_every: int = 100,
                                 m_cap: int = M_CAP) -> Dict:
    """Thm 2's parameters plus ``n``, which sets the variance-reduction
    factor theta = H / (H + n)."""
    hw = {k: ch[k] for k in ("omega", "omega_frac", "delta", "rho")}
    theta = anchor_every / (anchor_every + ch["n"])
    return {**hw, "anchor_every": int(anchor_every), "theta": theta,
            "predicted_m_max": svrg_mmax(hw["omega_frac"], hw["delta"],
                                         hw["rho"], theta, m_cap)}


def predict_svrg_mmax(X, *, anchor_every: int = 100,
                      m_cap: int = M_CAP) -> Dict:
    """Dataset-level critical staleness of async-SVRG."""
    return predict_svrg_from_characters(
        {**MX.hogwild_params(X), "n": X.shape[0]},
        anchor_every=anchor_every, m_cap=m_cap)
