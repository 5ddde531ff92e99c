"""Token-stream pipeline for the LM trainer (the port of
``repro/data/lm.py``): a synthetic corpus with learnable n-gram
structure, so a few hundred steps show a real loss drop, and the paper's
dataset-character probes applied to token space.

The generator is a tiny deterministic HMM over the vocab: the hidden state
walks a ring; emissions are state-local vocab bands.  Its numpy generator
is seeded from ``random.randint(key, (), 0, 2**31 - 1)``, the bit-exact
counterpart of the reference's ``jax.random.randint``, so both packages
yield the same tokens for the same key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class LMConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    n_states: int = 64
    band: int = 32            # emissions per hidden state


def hmm_stream(key, cfg: LMConfig, steps: int, device=DEFAULT_DEVICE):
    """Yields ``steps`` batches of {tokens, labels}, int32 (B, S) tensors
    on ``device``; ``key`` is a ``random.PRNGKey``."""
    dev = resolve_device(device)
    seed = int(R.randint(key.cpu(), (), 0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    trans_jump = rng.integers(1, 7, size=cfg.n_states)
    for _ in range(steps):
        B, S = cfg.batch_size, cfg.seq_len
        state = rng.integers(0, cfg.n_states, size=B)
        toks = np.zeros((B, S + 1), np.int32)
        for t in range(S + 1):
            base = (state * cfg.band) % max(cfg.vocab_size - cfg.band, 1)
            toks[:, t] = base + rng.integers(0, cfg.band, size=B)
            state = (state + trans_jump[state]) % cfg.n_states
        yield {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
               "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


def token_characters(tokens, *, window=8):
    """Paper indices in token space: one-hot sparsity is 1 - 1/V by
    construction, so the informative characters are diversity (distinct
    sequences) and the windowed similarity of consecutive sequences."""
    t = (tokens.cpu().numpy() if isinstance(tokens, torch.Tensor)
         else np.asarray(tokens))
    B = t.shape[0]
    uniq = len({t[i].tobytes() for i in range(B)})
    # consecutive-sequence hamming distance (token-level L0), windowed
    dists = []
    for j in range(1, min(window, B)):
        dists.append((t != np.roll(t, -j, axis=0)).mean())
    return {"sequence_diversity": uniq / B,
            "token_csim": float(np.mean(dists)) if dists else 0.0}
