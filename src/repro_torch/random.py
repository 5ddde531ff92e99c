"""Threefry-2x32 counter-based random numbers on tensors.

A bit-exact port of the generator the reference draws every dataset and
every sweep sample from: ``jax.random`` with the ``threefry2x32``
implementation, ``jax_threefry_partitionable=True`` and 64-bit types off
(the defaults of jax 0.9.0).  Keys are explicit values — a ``(..., 2)``
int64 tensor holding two unsigned 32-bit words — passed from call to
call, so there is no global generator state.  Leading dimensions of a key
are batch dimensions: a ``(k, 2)`` key draws ``k`` independent blocks in
one call, which is how ECD-PSGD's per-(iteration, worker) noise is made.

The 32-bit words live in int64 tensors and every operation masks back to
32 bits, since PyTorch has no complete unsigned 32-bit arithmetic.

Samplers provided are exactly those the ``upper_bound`` slice uses:
``uniform``, ``bernoulli``, ``randint`` and ``permutation``, plus
``PRNGKey``, ``split`` and ``fold_in``.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcastable int64 tensors of 32-bit
    words.  Returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """Key for a non-negative integer seed below 2**31 (``jax.random.
    PRNGKey`` with 64-bit types off: the high word is zero)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} must be in [0, 2**31)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _words(key):
    return key[..., 0:1], key[..., 1:2]


def _hash_counts(key, shape):
    """Threefry of the row-major linear index of ``shape`` under ``key``:
    the partitionable layout, where element ``i`` is hashed from the
    counter pair ``(i >> 32, i & 0xFFFFFFFF)``.  Output has shape
    ``key.shape[:-1] + shape``."""
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise ValueError("draws of 2**32 or more elements are not supported")
    batch = key.shape[:-1]
    k0, k1 = _words(key.reshape(-1, 2))
    counts = torch.arange(size, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(counts), counts[None])
    return b0.reshape(*batch, *shape), b1.reshape(*batch, *shape)


def split(key, num: int = 2) -> torch.Tensor:
    """``num`` new keys from ``key``: shape ``key.shape[:-1] + (num, 2)``."""
    b0, b1 = _hash_counts(key, (num,))
    return torch.stack([b0, b1], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """New key from ``key`` and an integer (or an integer tensor, which
    broadcasts against the key's batch dimensions)."""
    k0, k1 = key[..., 0], key[..., 1]
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(data), data & _MASK)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key, shape) -> torch.Tensor:
    """Uniform 32-bit words (as int64) of ``key.shape[:-1] + shape``."""
    b0, b1 = _hash_counts(key, tuple(shape))
    return b0 ^ b1


def uniform(key, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 uniform on ``[minval, maxval)``: the top 23 bits become the
    mantissa of a float in ``[1, 2)``, shifted and scaled in float32."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # the reference's compiler fuses ``floats * span + lo`` into one
    # multiply-add rounded once; float64 holds the float32 product exactly
    # and, for bounds of similar magnitude (every generator's), the sum
    # too, so one rounding of the float64 result gives the same float32
    span = (hi - lo).double()
    scaled = (floats.double() * span + lo.double()).to(torch.float32)
    return torch.maximum(lo, scaled)


def bernoulli(key, p: float, shape) -> torch.Tensor:
    """Boolean draws with probability ``p`` (compared in float32)."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                             device=key.device)


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """int64 integers on ``[minval, maxval)`` from two 32-bit words per
    element, reduced with the reference's wrapping uint32 arithmetic."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint bounds must fit in int32")
    k1, k2 = split(key)
    hi = random_bits(k1, shape)
    lo = random_bits(k2, shape)
    span = max(maxval - minval, 1) & _MASK
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span     # uint32 product
    off = (((hi % span) * mult) & _MASK) + lo % span
    return minval + (off & _MASK) % span


def permutation(key, n: int) -> torch.Tensor:
    """Random permutation of ``range(n)``: rounds of stable sorts on fresh
    32-bit keys, as many rounds as the reference's collision heuristic."""
    x = torch.arange(n, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
