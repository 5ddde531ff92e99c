"""Threefry-2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011; 20 rounds) and the key derivation and uniform draw of
``jax.random`` in its partitionable form with 32-bit types, written from
the published algorithm.

32-bit words live in int64 tensors and are masked after every addition
and rotation.  A key is a ``(..., 2)`` int64 tensor of two words.

  key(seed)        [0, seed]
  fold_in(k, d)    threefry(k, (0, d))
  split(k, n)      threefry(k, (0, i)) for i < n, each pair a key
  uniform(k, n)    bits_i = xor of threefry(k, (0, i)); the top 23 bits
                   as the mantissa of a float in [1, 2), minus 1
"""

from __future__ import annotations

import torch

M32 = (1 << 32) - 1
PARITY = 0x1BD11BDA
ROT = (13, 15, 26, 6, 17, 29, 16, 24)
#: counters hashed at once per key, so temporaries stay bounded
SLICE = 1 << 23


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def hash_pair(k0, k1, c0, c1):
    """The two output words of Threefry-2x32 under key (k0, k1) for the
    counter pair (c0, c1); broadcastable int64 tensors of 32-bit words."""
    ks = [k0, k1, k0 ^ k1 ^ PARITY]
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for group in range(5):
        for j in range(4):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, ROT[4 * (group % 2) + j]) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & M32
    return x0, x1


def key(seed: int, device="cpu"):
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(k, data):
    """``k`` (..., 2) and integer data (broadcasting against the key's
    batch) -> new keys."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    a, b = hash_pair(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([a, b], -1)


def split(k, n: int):
    """``k`` (..., 2) -> (..., n, 2)."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    a, b = hash_pair(k[..., 0:1], k[..., 1:2], torch.zeros_like(i), i)
    return torch.stack([a, b], -1)


def uniform(k, n: int):
    """float32 uniforms on [0, 1): ``k`` (r, 2) -> (r, n)."""
    r = k.shape[0]
    out = torch.empty((r, n), dtype=torch.float32, device=k.device)
    k0, k1 = k[:, 0:1], k[:, 1:2]
    for lo in range(0, n, SLICE):
        hi = min(lo + SLICE, n)
        c = torch.arange(lo, hi, dtype=torch.int64, device=k.device)[None]
        a, b = hash_pair(k0, k1, torch.zeros_like(c), c)
        mant = ((a ^ b) >> 9) | 0x3F800000
        out[:, lo:hi] = mant.to(torch.int32).view(torch.float32) - 1.0
    return out
