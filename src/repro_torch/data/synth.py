"""Synthetic datasets matching the paper's Table I constructions (port of
``repro/data/synth.py``).

Generators register by name in :data:`GENERATORS`, which specs reference
and whose sources the spec fingerprint hashes.  Each generator takes a
key from `repro_torch.random` and draws on the key's device, so the data
is made where it is used and, for the same key, is bit-identical to the
reference's.  Registered: ``realsim_like``, ``higgs_like``,
``ls_sequence``, ``upper_bound``, ``one_sample``, ``label_noise``,
``character_knob`` and ``heavy_tailed``; :func:`make_diversity_variants`
derives the diversity spec's duplication variants from a dataset.

Labels follow the paper: label_i = sign(xi_i . ruler),
ruler = (-1, 2, -3, 4, ..., (-1)^d * d).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch import random as R

#: name -> generator ``fn(key, **kwargs) -> Dataset``; latest wins.
GENERATORS: Dict[str, Callable] = {}


def register_generator(name: str):
    """Decorator: register a dataset generator under a spec-facing name."""
    def deco(fn):
        GENERATORS[name] = fn
        return fn
    return deco


def get_generator(name: str) -> Callable:
    try:
        return GENERATORS[name]
    except KeyError:
        raise KeyError(f"unknown generator {name!r}; "
                       f"known: {sorted(GENERATORS)}") from None


def ruler(d, device="cpu"):
    r = torch.arange(1, d + 1, dtype=torch.float32, device=device)
    return r * torch.pow(-1.0, r)


def label_with_ruler(X):
    y = torch.sign(X @ ruler(X.shape[1], X.device))
    return torch.where(y == 0, torch.ones_like(y), y)


@dataclasses.dataclass
class Dataset:
    X: torch.Tensor              # (n, d) float32
    y: torch.Tensor              # (n,) in {-1, +1}
    name: str = ""

    def split(self, train_frac=0.7, valid_frac=0.2, key=None,
              with_test=False):
        """Paper §VII.A fractions: 70% train / 20% valid / 10% held-out
        test.  ``key=None`` keeps the row order (the sampling order is a
        dataset character); a key shuffles with `random.permutation`.
        The tail is returned as a third dataset when ``with_test``."""
        if not (0.0 < train_frac <= 1.0 and 0.0 <= valid_frac <= 1.0
                and train_frac + valid_frac <= 1.0 + 1e-9):
            raise ValueError(
                f"bad split fractions: train={train_frac} valid={valid_frac}"
                f" (need 0 < train, 0 <= valid, train + valid <= 1)")
        n = self.X.shape[0]
        idx = (R.permutation(key, n).to(self.X.device) if key is not None
               else torch.arange(n, device=self.X.device))
        ntr = int(n * train_frac)
        nva = int(n * valid_frac)
        parts = [(idx[:ntr], ":train"), (idx[ntr:ntr + nva], ":valid")]
        if with_test:
            parts.append((idx[ntr + nva:], ":test"))
        return tuple(Dataset(self.X[i], self.y[i], self.name + tag)
                     for i, tag in parts)


def _masked_uniform(key, n, d, density, lo, hi):
    k1, k2 = R.split(key)
    mask = R.bernoulli(k1, density, (n, d))
    vals = R.uniform(k2, (n, d), minval=lo, maxval=hi)
    return torch.where(mask, vals, torch.zeros_like(vals))


@register_generator("realsim_like")
def make_realsim_like(key, n=8000, d=2000, density=0.03, lo=0.0, hi=1.0):
    """Sparse, small-feature-variance dataset (real-sim analogue)."""
    X = _masked_uniform(key, n, d, density, lo, hi)
    return Dataset(X, label_with_ruler(X), "realsim_like")


@register_generator("higgs_like")
def make_higgs_like(key, n=8000, d=28, lo=-4.0, hi=3.0):
    """Dense, large-feature-variance dataset (HIGGS analogue)."""
    X = R.uniform(key, (n, d), minval=lo, maxval=hi)
    return Dataset(X, label_with_ruler(X), "higgs_like")


@register_generator("ls_sequence")
def make_ls_sequence(key, n=8000, d=28, mutate_frac=0.1, density=1.0,
                     lo=-4.0, hi=3.0, first_sample=None):
    """LS-controlled sampling sequence (§VII.A): sample t is sample t-1 with
    ``mutate_frac`` of its features redrawn (small frac: small C_sim);
    below full density every sample is re-sparsified by a fresh mask.

    The reference scans the rows one by one.  Here every row's draws are
    made at once, from the same keys, and the scan is evaluated in closed
    form: a feature holds the value of its last event (a redraw, or a
    mask that zeroes it) at or before the row, or the first sample's."""
    keys = R.split(key, 4)
    if first_sample is None:
        first_sample = R.uniform(keys[0], (d,), lo, hi)
        if density < 1.0:
            m0 = R.bernoulli(keys[1], density, (d,))
            first_sample = torch.where(m0, first_sample,
                                       torch.zeros_like(first_sample))
    first_sample = torch.as_tensor(first_sample, dtype=torch.float32,
                                   device=key.device)
    n_mut = max(1, int(mutate_frac * d))
    k_idx, k_val, k_keep = R.split(R.split(keys[2], n), 3).unbind(-2)
    # choice(replace=False) is the head of a permutation
    idx = R.permutation(k_idx, d)[:, :n_mut]                  # (n, n_mut)
    redrawn = torch.zeros(n, d, dtype=torch.bool, device=key.device)
    redrawn.scatter_(1, idx, True)
    value = torch.zeros(n, d, device=key.device)
    value.scatter_(1, idx, R.uniform(k_val, (n_mut,), lo, hi))
    event = redrawn
    if density < 1.0:
        keep = R.bernoulli(k_keep, density, (d,))
        value = torch.where(keep, value, torch.zeros_like(value))
        event = redrawn | ~keep
    rows = torch.arange(n, device=key.device)[:, None].expand(n, d)
    last = torch.cummax(torch.where(event, rows, -1), dim=0).values
    X = torch.where(last >= 0, value.gather(0, last.clamp_min(0)),
                    first_sample.expand(n, d))
    return Dataset(X, label_with_ruler(X), f"ls_seq_mut{mutate_frac}")


def make_diversity_variants(base: Dataset):
    """real_sim / real_sim2 / real_sim4 duplication construction (§VII.A):
    cut into 4 equal parts; middle = {p1,p1,p2,p2}; low = {p1,p1,p1,p1}."""
    n = (base.X.shape[0] // 4) * 4
    X, y = base.X[:n], base.y[:n]
    q = n // 4
    high = Dataset(X, y, base.name + ":div_high")
    mid = Dataset(torch.cat([X[:q], X[:q], X[q:2 * q], X[q:2 * q]]),
                  torch.cat([y[:q], y[:q], y[q:2 * q], y[q:2 * q]]),
                  base.name + ":div_mid")
    low = Dataset(torch.cat([X[:q]] * 4), torch.cat([y[:q]] * 4),
                  base.name + ":div_low")
    return high, mid, low


@register_generator("upper_bound")
def make_upper_bound_dataset(key, n=6000, d=400, density=0.7, lo=0.0, hi=1.0):
    """§VII.E: 70%-density simulated dataset whose Hogwild! upper bound is
    reachable with few workers."""
    X = _masked_uniform(key, n, d, density, lo, hi)
    return Dataset(X, label_with_ruler(X), "upper_bound_sim")


@register_generator("one_sample")
def make_one_sample_dataset(key, n=1024, d=64):
    """Example 12: dataset = one sample duplicated n times (diversity 1)."""
    x = R.uniform(key, (d,))
    X = x[None].repeat(n, 1)
    return Dataset(X, label_with_ruler(X), "one_sample")


@register_generator("label_noise")
def make_label_noise(key, base="higgs_like", flip_frac=0.2, **base_kwargs):
    """Label-noise variant of any registered base generator: ruler labels
    with a ``flip_frac`` fraction flipped uniformly at random; the
    features are the base's."""
    kb, kf = R.split(key)
    ds = get_generator(base)(kb, **base_kwargs)
    flip = R.bernoulli(kf, flip_frac, tuple(ds.y.shape))
    return Dataset(ds.X, torch.where(flip, -ds.y, ds.y),
                   f"{ds.name}:noise{flip_frac}")


@register_generator("character_knob")
def make_character_knob(key, n=1024, d=64, variance=1.0, density=1.0,
                        duplication=0.0):
    """Continuous §IV character surface, three independent knobs:
    ``variance`` (per-feature variance as measured: the uniform span
    compensates the density mask), ``density`` (nonzero fraction) and
    ``duplication`` (fraction of rows replaced by copies of the retained
    head, tiled in order)."""
    if not (0.0 <= duplication < 1.0):
        raise ValueError(f"duplication={duplication} must be in [0, 1)")
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density={density} must be in (0, 1]")
    k1, k2 = R.split(key)
    half_span = 0.5 * (12.0 * variance / density) ** 0.5
    X = R.uniform(k1, (n, d), -half_span, half_span)
    if density < 1.0:
        X = torch.where(R.bernoulli(k2, density, (n, d)), X,
                        torch.zeros_like(X))
    n_unique = max(1, int(round(n * (1.0 - duplication))))
    if n_unique < n:
        X = X[torch.arange(n, device=X.device) % n_unique]
    return Dataset(X, label_with_ruler(X),
                   f"character_knob_v{variance}_p{density}_dup{duplication}")


@register_generator("heavy_tailed")
def make_heavy_tailed(key, n=8000, d=28, df=3.0, scale=1.0):
    """Heavy-tailed features: Student-t with ``df`` degrees of freedom
    (``df >= 2``), dense like higgs_like but with rare huge samples."""
    X = R.t(key, df, (n, d)) * scale
    return Dataset(X, label_with_ruler(X), f"heavy_tailed_t{df}")
