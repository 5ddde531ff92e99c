"""ScalabilityAdvisor — measure the dataset or gradient characters a
trainer sees and report the predicted scalability envelope (port of
``repro/core/advisor.py``).

    advisor = ScalabilityAdvisor()                  # on the GPU
    report = advisor.from_grads(per_shard_grads)    # gradient-level
    report = advisor.from_dataset(X)                # raw-dataset level

Both return {characters..., predicted m_max per strategy, recommendation}.
Invalid probes (empty or single-shard lists, non-finite values, datasets
too small) return a structured low-confidence report (``valid: False`` +
``reason``) instead of NaN characters or a raise.  The advisor works on
its ``device`` (the GPU unless the caller names the CPU): inputs given as
numpy arrays, lists or tensors are moved there as float32.

Batched probes: :func:`masked_dataset_characters` and
:func:`masked_grad_characters` are the slot-batched twins of the scalar
measurements, over a zero-padded ``(n_slots, ...)`` batch with row and
column validity masks, so `repro_torch.service.batcher` answers N
concurrent probes with one call.  The row supports behind sparsity and
Thm 2's Omega come from one K1 launch (`metrics.row_l0`) over the whole
flattened slot batch; that count reads no mask, so it is exact only
because every padded cell of the batch is zero (the batcher writes a
probe's whole zero-padded envelope into its slot).  The per-column
reductions are mask-weighted tensor code.  Gradient pytrees are
flattened leaf by leaf in the reference's order: dict entries by sorted
key, lists and tuples in order.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import fit as FIT
from repro_torch.core import metrics as MX
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.tree import flatten

#: default |g| <= tol sparsity threshold shared by the scalar and masked
#: gradient paths (ScalabilityAdvisor(sparsity_tol=) overrides per
#: instance for the scalar path)
SPARSITY_TOL = 1e-8

#: the (n_slots,)-shaped characters :func:`masked_dataset_characters`
#: returns
DATASET_KEYS = ("n", "d", "mean_feature_variance", "sparsity", "density",
                "omega", "omega_frac", "delta", "rho")


def tree_leaves(tree) -> List:
    """A pytree's leaves in the reference's order."""
    return flatten(tree)[0]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(x, device) -> torch.Tensor:
    """float32 tensor on ``device`` (numpy is cast on the host first, as
    the reference's ``jnp.asarray`` casts it)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


# ---------------------------------------------------------------------------
# masked (slot-batched) characters — the service's batched path
# ---------------------------------------------------------------------------

def masked_dataset_characters(Xs, row_mask, col_mask) -> Dict:
    """Slot-batched §IV dataset characters under validity masks.

    ``Xs``: ``(n_slots, R, D)`` float32 datasets, zero wherever the masks
    are zero; ``row_mask`` ``(n_slots, R)`` and ``col_mask``
    ``(n_slots, D)`` are 1.0 on real rows and columns.  Returns
    ``(n_slots,)`` tensors for every maskable character (variance,
    sparsity, density, the Thm-2 Hogwild! parameters); `diversity` needs
    an exact row dedup and stays a host-side per-slot pass.  All-padding
    slots give zeros, never NaN."""
    s, R, D = Xs.shape
    rm = row_mask[:, :, None]                        # (s, R, 1)
    cm = col_mask[:, None, :]                        # (s, 1, D)
    cell = rm * cm                                   # (s, R, D)
    n = row_mask.sum(dim=1)                          # (s,)
    d = col_mask.sum(dim=1)
    n_safe = n.clamp_min(1.0)
    d_safe = d.clamp_min(1.0)

    mean = (Xs * cell).sum(dim=1) / n_safe[:, None]              # (s, D)
    var_k = ((((Xs - mean[:, None, :]) * rm) ** 2) * cm).sum(
        dim=1) / n_safe[:, None]                                 # (s, D)
    mean_feature_variance = (var_k * col_mask).sum(dim=1) / d_safe

    # every row's support size, one K1 launch over all slots; padded
    # cells are zero, so they add nothing (integers, exact in float32)
    support = MX.row_l0(Xs.reshape(s * R, D)).reshape(s, R)
    sparsity = (n * d - support.sum(dim=1)) / (n_safe * d_safe)
    omega = support.max(dim=1).values

    nz = (torch.abs(Xs) > 0.0).to(torch.float32) * cell          # (s, R, D)
    freq = nz.sum(dim=1) / n_safe[:, None]                       # (s, D)
    delta = freq.max(dim=1).values
    rho = (freq * freq).sum(dim=1).clamp_max(1.0)
    return {
        "n": n, "d": d,
        "mean_feature_variance": mean_feature_variance,
        "sparsity": sparsity,
        "density": 1.0 - sparsity,
        "omega": omega,
        "omega_frac": omega / d_safe,
        "delta": delta,
        "rho": rho,
    }


def masked_grad_characters(flats, shard_mask, param_mask) -> Dict:
    """Slot-batched gradient-level characters under validity masks.

    ``flats``: ``(n_slots, M, P)`` zero-padded flattened per-shard grads;
    ``shard_mask`` ``(n_slots, M)`` / ``param_mask`` ``(n_slots, P)`` mark
    real shards and parameters.  The proxies of
    `ScalabilityAdvisor.grad_characters`, mask-weighted."""
    sm = shard_mask[:, :, None]                      # (s, M, 1)
    pm = param_mask[:, None, :]                      # (s, 1, P)
    cell = sm * pm
    m = shard_mask.sum(dim=1)                        # (s,)
    p = param_mask.sum(dim=1)
    m_safe = m.clamp_min(1.0)
    p_safe = p.clamp_min(1.0)

    mean = (flats * cell).sum(dim=1) / m_safe[:, None]           # (s, P)
    var = ((((flats - mean[:, None, :]) * sm) ** 2) * pm).sum(
        dim=1) / m_safe[:, None]
    gvar = (var * param_mask).sum(dim=1) / p_safe
    gmean_sq = ((mean ** 2) * param_mask).sum(dim=1) / p_safe
    small = (torch.abs(flats) <= SPARSITY_TOL).to(torch.float32)
    sparsity = (small * cell).sum(dim=(1, 2)) / (m_safe * p_safe)

    masked = flats * cell
    normed = masked / (torch.linalg.vector_norm(masked, dim=2, keepdim=True)
                       + 1e-9)
    cos = torch.einsum("smp,snp->smn", normed, normed)
    pair = sm * shard_mask[:, None, :]               # (s, M, M)
    off = ((cos * pair).sum(dim=(1, 2)) - m) / (m * (m - 1.0) + 1e-9)
    return {
        "grad_variance": gvar,
        "grad_noise_scale": gvar / (gmean_sq + 1e-12),
        "grad_sparsity": sparsity,
        "shard_cosine_similarity": off,
    }


def _to_host(batched: Dict) -> Dict[str, np.ndarray]:
    """One device-to-host copy for a dict of equal-length vectors."""
    keys = list(batched)
    stacked = torch.stack([batched[k].to(torch.float32) for k in keys])
    return dict(zip(keys, stacked.cpu().numpy()))


class ScalabilityAdvisor:
    def __init__(self, *, parallel_cost=1e-3, sparsity_tol=SPARSITY_TOL,
                 device=DEFAULT_DEVICE):
        self.parallel_cost = parallel_cost
        self.tol = sparsity_tol
        self.device = resolve_device(device)

    # -- input validation (the service front door hits these) ---------------
    @staticmethod
    def validate_grads(per_shard_grads) -> Optional[str]:
        """None when the shard list supports character measurement, else a
        human-readable reason (empty list, a single shard — no cross-shard
        signal — or non-finite gradient values)."""
        if per_shard_grads is None or len(per_shard_grads) == 0:
            return "empty shard list — no gradients to measure"
        if len(per_shard_grads) == 1:
            return ("single gradient shard — cross-shard variance and "
                    "similarity need >= 2 shards")
        for i, g in enumerate(per_shard_grads):
            leaves = [_host(x) for x in tree_leaves(g)]
            if not leaves or all(x.size == 0 for x in leaves):
                return f"shard {i} carries no gradient values"
            if not all(bool(np.isfinite(x).all()) for x in leaves):
                return f"shard {i} contains non-finite gradient values"
        return None

    @staticmethod
    def validate_dataset(X) -> Optional[str]:
        """None when X supports character measurement, else the reason
        (empty, not a matrix, < 2 rows, or non-finite values)."""
        if X is None:
            return "no dataset provided"
        shape = tuple(X.shape) if isinstance(X, torch.Tensor) \
            else np.shape(X)
        if len(shape) != 2:
            return f"dataset must be a (rows, features) matrix, got " \
                   f"shape {shape}"
        if shape[0] < 2 or shape[1] < 1:
            return (f"dataset of shape {shape} is too small — "
                    f"character measurement needs >= 2 rows and >= 1 "
                    f"feature")
        finite = (torch.isfinite(X).all() if isinstance(X, torch.Tensor)
                  else np.isfinite(np.asarray(X, dtype=np.float64)).all())
        if not bool(finite):
            return "dataset contains non-finite values"
        return None

    @staticmethod
    def invalid_report(kind: str, reason: str) -> Dict:
        """Structured low-confidence report for an unmeasurable probe: the
        conservative m_max is 1 worker, confidence is 0, and the caller is
        told to fix the probe — never NaN characters, never a raise."""
        return {
            "valid": False, "kind": kind, "reason": reason,
            "confidence": 0.0,
            "predicted_m_max_conservative": 1,
            "recommendation": (f"invalid {kind} probe: {reason}; fix the "
                               f"probe input — no scalability estimate is "
                               f"trustworthy for it"),
        }

    def _flatten(self, tree) -> torch.Tensor:
        return torch.cat([as_tensor(x, self.device).reshape(-1)
                          for x in tree_leaves(tree)])

    # -- gradient-level characters ------------------------------------------
    def grad_characters(self, per_shard_grads: List) -> Dict:
        """per_shard_grads: list of grad pytrees, one per data shard (or
        per microbatch) — the sample-difference proxies of §IV measured
        on the gradients the optimizer consumes."""
        flats = torch.stack([self._flatten(g) for g in per_shard_grads])
        gvar = float(flats.var(dim=0, correction=0).mean())
        gmean_sq = float((flats.mean(dim=0) ** 2).mean())
        sparsity = float((torch.abs(flats) <= self.tol)
                         .to(torch.float32).mean())
        # pairwise cosine similarity across shards = LS proxy
        normed = flats / (torch.linalg.vector_norm(flats, dim=1,
                                                   keepdim=True) + 1e-9)
        cos = normed @ normed.T
        m = flats.shape[0]
        off = (cos.sum() - m) / (m * (m - 1) + 1e-9)
        return {
            "grad_variance": gvar,
            "grad_noise_scale": gvar / (gmean_sq + 1e-12),
            "grad_sparsity": sparsity,
            "shard_cosine_similarity": float(off),
        }

    def _grad_report(self, ch: Dict) -> Dict:
        """Predictions + recommendation from measured gradient characters
        (shared by `from_grads` and the service's batched path)."""
        # gradient-noise-scale plays sigma's role in the Thm 3 curve
        sigma = ch["grad_noise_scale"] ** 0.5
        ch["predicted_m_max_sync"] = FIT.sync_mmax(sigma, self.parallel_cost)
        # Hogwild staleness tolerance needs gradient sparsity
        om = (1.0 - ch["grad_sparsity"])
        ch["predicted_m_max_stale"] = max(
            1, int((1.0 / (6.0 * max(om, 1e-6))) ** 0.5))
        ch["recommendation"] = self._recommend(ch)
        ch["valid"] = True
        return ch

    def from_grads(self, per_shard_grads: List) -> Dict:
        reason = self.validate_grads(per_shard_grads)
        if reason is not None:
            return self.invalid_report("grads", reason)
        return self._grad_report(self.grad_characters(per_shard_grads))

    # -- dataset-level characters -------------------------------------------
    def from_dataset(self, X, *, tau_max=8, batch_size=8, beta=0.9,
                     sync_every=4, anchor_every=100) -> Dict:
        """Characters of X (C_sim and LS_sync through K2, row supports
        through K1 on the GPU) and every predictor's m_max."""
        reason = self.validate_dataset(X)
        if reason is not None:
            return self.invalid_report("dataset", reason)
        X = as_tensor(X, self.device)
        ch = MX.summarize(X, tau_max=tau_max, batch_size=batch_size)
        ch["hogwild"] = FIT.predict_hogwild_mmax(X)
        ch["sync"] = FIT.predict_sync_mmax(X, parallel_cost=self.parallel_cost)
        ch["dadm"] = FIT.predict_dadm_mmax(X, parallel_cost=self.parallel_cost)
        # critical-parameter envelopes: same characters, knob-shifted cliffs
        ch["momentum"] = FIT.predict_momentum_mmax(
            X, beta=beta, parallel_cost=self.parallel_cost)
        ch["local_sgd"] = FIT.predict_local_sgd_mmax(
            X, sync_every=sync_every, parallel_cost=self.parallel_cost)
        ch["svrg"] = FIT.predict_svrg_mmax(X, anchor_every=anchor_every)
        ch["recommendation"] = self._recommend_dataset(ch)
        ch["valid"] = True
        return ch

    # -- batched probes (one masked-batch call for N requests) --------------
    def dataset_characters_batch(self, Xs: List, n_slots: int = 0
                                 ) -> List[Optional[Dict]]:
        """Characters for N raw datasets in one masked-batch computation.

        Pads every dataset to the group's (rows, features) envelope and a
        slot count of ``max(n_slots, len(Xs))`` — zeros everywhere else,
        which K1's count relies on — runs
        :func:`masked_dataset_characters` once, then finishes the exact
        row dedup (`diversity`) per slot on the host.  Invalid entries
        come back as None; the dicts carry exactly the characters the
        `analysis.fit` ``*_from_characters`` predictors consume."""
        reasons = [self.validate_dataset(X) for X in Xs]
        valid = [i for i, r in enumerate(reasons) if r is None]
        out: List[Optional[Dict]] = [None] * len(Xs)
        if not valid:
            return out
        slots = max(int(n_slots), len(Xs))
        arrs = [as_tensor(Xs[i], self.device) for i in valid]
        R = max(a.shape[0] for a in arrs)
        D = max(a.shape[1] for a in arrs)
        Xp = torch.zeros((slots, R, D), dtype=torch.float32,
                         device=self.device)
        row_m = torch.zeros((slots, R), dtype=torch.float32,
                            device=self.device)
        col_m = torch.zeros((slots, D), dtype=torch.float32,
                            device=self.device)
        for s, a in enumerate(arrs):
            Xp[s, :a.shape[0], :a.shape[1]] = a
            row_m[s, :a.shape[0]] = 1.0
            col_m[s, :a.shape[1]] = 1.0
        batched = _to_host(masked_dataset_characters(Xp, row_m, col_m))
        for s, (i, a) in enumerate(zip(valid, arrs)):
            ch = {k: (int(v[s]) if k in ("n", "d") else float(v[s]))
                  for k, v in batched.items()}
            ch["diversity"] = MX.diversity(a)
            ch["diversity_ratio"] = ch["diversity"] / max(ch["n"], 1)
            out[i] = ch
        return out

    def grad_characters_batch(self, grads_list: List, n_slots: int = 0
                              ) -> List[Optional[Dict]]:
        """Gradient characters for N per-shard-grad probes in one masked
        batch; invalid entries come back as None."""
        reasons = [self.validate_grads(g) for g in grads_list]
        valid = [i for i, r in enumerate(reasons) if r is None]
        out: List[Optional[Dict]] = [None] * len(grads_list)
        if not valid:
            return out
        slots = max(int(n_slots), len(grads_list))
        flats = [[self._flatten(g) for g in grads_list[i]] for i in valid]
        M_ = max(len(f) for f in flats)
        P = max(f[0].shape[0] for f in flats)
        Fp = torch.zeros((slots, M_, P), dtype=torch.float32,
                         device=self.device)
        shard_m = torch.zeros((slots, M_), dtype=torch.float32,
                              device=self.device)
        param_m = torch.zeros((slots, P), dtype=torch.float32,
                              device=self.device)
        for s, shards in enumerate(flats):
            for j, f in enumerate(shards):
                Fp[s, j, :f.shape[0]] = f
            shard_m[s, :len(shards)] = 1.0
            param_m[s, :shards[0].shape[0]] = 1.0
        batched = _to_host(masked_grad_characters(Fp, shard_m, param_m))
        for s, i in enumerate(valid):
            out[i] = {k: float(v[s]) for k, v in batched.items()}
        return out

    def _recommend(self, ch: Dict) -> str:
        if ch["grad_sparsity"] > 0.5:
            return ("sparse gradients: async/stale exchange scales "
                    f"(predicted m_max ~{ch['predicted_m_max_stale']}); "
                    "sync batch scaling limited")
        if ch["grad_noise_scale"] > 1.0:
            return ("high gradient noise: sync batch scaling pays off up to "
                    f"m~{ch['predicted_m_max_sync']}")
        return ("low gradient noise: batch scaling saturates early "
                f"(m_max~{ch['predicted_m_max_sync']}); consider gossip to "
                "cut exchange cost instead of adding workers")

    def _recommend_dataset(self, ch: Dict) -> str:
        if ch["sparsity"] > 0.9:
            return ("sparse + low-variance dataset: Hogwild!-class (predicted "
                    f"m_max {ch['hogwild']['predicted_m_max']}, "
                    f"{ch['svrg']['predicted_m_max']} with semi-stochastic "
                    "gradients); mini-batch gains will be minor (paper "
                    "Fig 3b)")
        if ch["mean_feature_variance"] > 1.0:
            return ("dense high-variance dataset: mini-batch SGD/ECD-PSGD "
                    f"class, m_max ~{ch['sync']['predicted_m_max']} "
                    "(paper Fig 3a)")
        if ch["diversity_ratio"] < 0.5:
            return ("low diversity: DADM and all model-average methods "
                    "saturate early (paper Fig 6); deduplicate or reshuffle")
        return ("balanced characters: any strategy; bound set by parallel "
                "cost — a local-SGD sync window amortizes it (predicted "
                f"m_max {ch['local_sgd']['predicted_m_max']} vs sync "
                f"{ch['sync']['predicted_m_max']})")
