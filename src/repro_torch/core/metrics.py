"""The paper's dataset-character indices, §IV (port of
``repro/core/metrics.py``).

  feature_variance   per-feature variance over the dataset (§IV.B)
  sparsity/density   fraction of zero elements (§IV.B)
  diversity          number of distinct sample kinds (§IV.C)
  C_sim_range        Eq. 3: windowed mean L0 distance along the sampling
                     sequence
  LS_A(D, S)         local similarity per algorithm class (§IV.A):
                       async (Hogwild!): C_sim_{tau_max} over the sequence
                       sync  (mini-batch/ECD-PSGD/DADM): the max over batches
                       of the batch-internal similarity

Every L0 count goes through `repro_torch.kernels.csim`: the shift sums of
C_sim and of the batch-internal similarity through K2 (``l0_shift_sum``),
the per-row support sizes behind sparsity and Thm 2's Omega through K1
(``l0_rows`` against zero, from X alone).  The wrappers launch the CUDA
kernels on CUDA tensors and run their plain versions on CPU tensors,
the counterpart of the reference's ``_default_use_kernel``.  The counts
are exact integers; the ratios are formed in float32 as the reference
forms them (a multiply by the float32 reciprocal).  The ``*_ref`` oracles
are kept as test references.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import csim as kcsim


def _f32_reciprocal(den) -> float:
    return float(np.float32(1.0) / np.float32(den))


def _f32_ratio(num, den) -> float:
    """``num / den`` as the reference computes it: its compiler turns a
    division by a constant into a float32 multiply by the reciprocal."""
    return float(np.float32(num) * np.float32(_f32_reciprocal(den)))


def feature_mean(X):
    return X.mean(dim=0)


def feature_variance(X):
    """Per-feature variance (paper's 'feature variance_k')."""
    return X.var(dim=0, correction=0)


def mean_feature_variance(X):
    return float(feature_variance(X).mean())


def row_l0(X, tol=0.0):
    """Per-row support size ``||x_i||_0 = ||x_i - 0||_0`` through K1,
    read from X alone (no zero tensor)."""
    return kcsim.l0_rows(X.float().contiguous(), None, tol)


def sparsity(X, tol=0.0):
    """Fraction of zero elements."""
    n, d = X.shape
    nnz = int(row_l0(X, tol).to(torch.int64).sum())
    return _f32_ratio(n * d - nnz, n * d)


def density(X, tol=0.0):
    return 1.0 - sparsity(X, tol)


def diversity(X, *, decimals=6):
    """Number of distinct sample kinds (exact row dedup on the host)."""
    Xr = np.round(X.detach().cpu().numpy(), decimals)
    return int(np.unique(Xr, axis=0).shape[0])


def diversity_ratio(X, **kw):
    return diversity(X, **kw) / X.shape[0]


# ---------------------------------------------------------------------------
# C_sim (Eq. 3) and LS_A
# ---------------------------------------------------------------------------

def l0_distance(a, b, tol=0.0):
    """||a - b||_0 — number of differing coordinates."""
    return (torch.abs(a - b) > tol).to(torch.float32).sum(dim=-1)


def csim_ref(X, rng: int, tol=0.0):
    """Eq. 3: C_sim_range = (1/n) sum_i (1/range) sum_{j=1..range}
    ||xi_i - xi_{(i+j) % n}||_0   (Python-loop oracle for :func:`csim`)."""
    n = X.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=X.device)
    for j in range(1, rng + 1):
        total = total + l0_distance(X, torch.roll(X, -j, dims=0), tol).sum()
    return _f32_ratio(float(total), n * rng)


def csim(X, rng: int, tol=0.0):
    """Eq. 3 through K2 (one launch over all ``rng`` shifts, the shifted
    rows read in place).  Oracle: :func:`csim_ref`."""
    n = X.shape[0]
    total = kcsim.l0_shift_sum(X.float().contiguous()[None], rng, tol)
    return _f32_ratio(int(total[0]), n * rng)


def _pairwise_l0_means(batches, tol=0.0):
    """(nb, b, d) -> (nb,) float32 mean pairwise L0 distance within each
    batch: the b-1 in-batch cyclic shifts cover every ordered pair once,
    all batches in one K2 launch."""
    nb, b, _ = batches.shape
    tot = kcsim.l0_shift_sum(batches.float().contiguous(), b - 1, tol)
    return tot.to(torch.float32) * _f32_reciprocal(b * (b - 1) + 1e-9)


def batch_internal_similarity_ref(Xb, tol=0.0):
    """(b, b, d)-broadcast oracle for :func:`batch_internal_similarity`."""
    b = Xb.shape[0]
    diff = torch.abs(Xb[:, None, :] - Xb[None, :, :]) > tol
    d = diff.to(torch.float32).sum(dim=-1)
    off = d.sum() - torch.diagonal(d).sum()
    return _f32_ratio(float(off), b * (b - 1) + 1e-9)


def batch_internal_similarity(Xb, tol=0.0):
    """Mean pairwise L0 distance within a batch — the tractable proxy for
    the paper's 'max C_sim over orderings of the batch'.
    Oracle: :func:`batch_internal_similarity_ref`."""
    return float(_pairwise_l0_means(Xb[None], tol)[0])


def ls_async(X, tau_max: int, tol=0.0):
    """LS_A for asynchronous algorithms (Hogwild!): C_sim_{tau_max}."""
    return csim(X, tau_max, tol)


def ls_sync_ref(X, batch_size: int, tol=0.0):
    """Per-batch Python-loop oracle for :func:`ls_sync`."""
    n = (X.shape[0] // batch_size) * batch_size
    batches = X[:n].reshape(-1, batch_size, X.shape[1])
    return float(max(batch_internal_similarity_ref(batches[i], tol)
                     for i in range(batches.shape[0])))


def ls_sync(X, batch_size: int, tol=0.0):
    """LS_A for synchronous algorithms: max over batches of the batch's
    internal similarity, every batch in one K2 launch.
    Oracle: :func:`ls_sync_ref`."""
    n = (X.shape[0] // batch_size) * batch_size
    batches = X[:n].reshape(-1, batch_size, X.shape[1])
    return float(_pairwise_l0_means(batches, tol).max())


def ls_auto(X, algorithm: str, window: int = 8, tol=0.0):
    """LS_A resolved through the Algorithm registry: asynchronous
    algorithms read C_sim with the window as tau_max, synchronous ones the
    max batch-internal similarity with the window as the batch size."""
    from repro_torch.core.algorithms import base as alg_base
    if alg_base.get_algorithm(algorithm).asynchronous:
        return ls_async(X, window, tol)
    return ls_sync(X, window, tol)


# ---------------------------------------------------------------------------
# Hogwild! theorem-2 parameters (Omega, delta, rho) from the dataset
# ---------------------------------------------------------------------------

def hogwild_params(X, tol=0.0):
    """Estimate (Omega, delta, rho) of Thm 2 for a linear model, where the
    gradient sparsity pattern equals the sample sparsity pattern.

      Omega: max #nonzeros in a sample (K1 row supports)
      delta: max frequency of any feature being nonzero
      rho:   max probability two random samples share a nonzero feature
    """
    omega = float(row_l0(X, tol).max())
    freq = (torch.abs(X) > tol).to(torch.float32).mean(dim=0)    # (d,)
    delta = float(freq.max())
    # P(collision) <= sum_k freq_k^2  (union bound over features)
    rho = float(torch.clamp_max((freq * freq).sum(), 1.0))
    return {"omega": omega, "omega_frac": omega / X.shape[1],
            "delta": delta, "rho": rho}


def summarize(X, *, tau_max=8, batch_size=8):
    """All paper indices in one report."""
    hw = hogwild_params(X)
    return {
        "n": int(X.shape[0]), "d": int(X.shape[1]),
        "mean_feature_variance": mean_feature_variance(X),
        "sparsity": sparsity(X),
        "density": density(X),
        "diversity": diversity(X),
        "diversity_ratio": diversity_ratio(X),
        "csim_async": ls_async(X, tau_max),
        "csim_sync": ls_sync(X, batch_size),
        **hw,
    }
