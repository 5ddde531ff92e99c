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

Samplers: ``uniform``, ``bernoulli``, ``randint``, ``permutation``,
``normal``, ``gamma`` and ``t``, plus ``PRNGKey``, ``split`` and
``fold_in``.  ``normal`` and ``gamma`` evaluate the reference's float32
``erf_inv`` and ``log`` (its compiler's polynomials) as explicit
products, sums, quotients and square roots, each rounded once as the
reference's CPU build rounds it (one rounding for the multiply-adds its
compiler fuses), so the CPU and the GPU draw the same bits.
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


def _hash_counts(key, shape, lo=0, hi=None):
    """Threefry of the row-major linear index of ``shape`` under ``key``:
    the partitionable layout, where element ``i`` is hashed from the
    counter pair ``(i >> 32, i & 0xFFFFFFFF)``.  Output has shape
    ``key.shape[:-1] + shape``; with ``lo``/``hi`` only the counters
    ``[lo, hi)`` of the flattened shape are hashed, ``key.shape[:-1] +
    (hi - lo,)``."""
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise ValueError("draws of 2**32 or more elements are not supported")
    batch = key.shape[:-1]
    k0, k1 = _words(key.reshape(-1, 2))
    whole = hi is None
    hi = size if whole else hi
    counts = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(counts), counts[None])
    out = shape if whole else (hi - lo,)
    return b0.reshape((*batch, *out)), b1.reshape((*batch, *out))


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


# counters hashed at once per key by :func:`uniform`: a larger draw goes in
# slices of the counter range, which keeps its int64 temporaries (about
# 8 bytes x keys x DRAW_SLICE each) bounded; element i hashes counter i, so
# the slices give the same bits as one draw
DRAW_SLICE = 1 << 24


def uniform(key, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 uniform on ``[minval, maxval)``: the top 23 bits become the
    mantissa of a float in ``[1, 2)``, shifted and scaled in float32."""
    shape = tuple(shape)
    size = math.prod(shape)
    batch = key.shape[:-1]
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    if size <= DRAW_SLICE:
        return _uniform_bits(random_bits(key, shape), lo, hi)
    out = torch.empty((*batch, size), dtype=torch.float32, device=key.device)
    for start in range(0, size, DRAW_SLICE):
        stop = min(start + DRAW_SLICE, size)
        b0, b1 = _hash_counts(key, shape, start, stop)
        out[..., start:stop] = _uniform_bits(b0 ^ b1, lo, hi)
    return out.reshape(*batch, *shape)


def _uniform_bits(bits, lo, hi):
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
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
    32-bit keys, as many rounds as the reference's collision heuristic.
    A ``(..., 2)`` key draws one permutation per key: ``(..., n)``."""
    x = torch.arange(n, device=key.device).expand(*key.shape[:-1], n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))
    for _ in range(rounds):
        key, sub = split(key).unbind(-2)
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


# ---------------------------------------------------------------------------
# normal, gamma and Student's t
# ---------------------------------------------------------------------------

def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else float(v)


def fma(a, b, c):
    """``a * b + c`` of float32 values rounded once to float32.  The
    product is exact in float64; the float64 sum is rounded to odd (an
    inexact sum with an even last bit moves one ulp toward its error), so
    the final rounding to float32 is the correct one.  (`core.numerics.
    fma` rounds the sum twice; the fused ECD-PSGD kernel reproduces that
    bit for bit, so it stays as it is.)"""
    p = _f64(a) * _f64(b)
    c = torch.as_tensor(_f64(c), dtype=torch.float64, device=p.device)
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.to(torch.float32)


def _div(a, b):
    """Correctly rounded float32 quotient (through float64, where one
    more rounding cannot change it)."""
    return (_f64(a) / _f64(b)).to(torch.float32)


def _sqrt(a):
    """Correctly rounded float32 square root (through float64)."""
    return torch.sqrt(a.double()).to(torch.float32)


def _daz(x):
    """Subnormal inputs read as (signed) zero, as in the reference's CPU
    build."""
    return torch.where(torch.abs(x) < 2.0 ** -126, x * 0.0, x)


def _c(h: str) -> float:
    """A float32 constant, written exactly in hex."""
    return float.fromhex(h)


# the reference's float32 log: Cephes logf on the mantissa in
# [sqrt(1/2), sqrt(2)), with the exponent split into two parts
_LOG_P = [_c(h) for h in (
    "0x1.204376p-4", "-0x1.d7a37p-4", "-0x1.fcba9ep-4", "0x1.23d37ep-3",
    "0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.de4a34p-4", "-0x1.555cap-3",
    "0x1.555554p-2")]
_LOG_Q1, _LOG_Q2 = _c("-0x1.bd0106p-13"), _c("0x1.63p-1")
_SQRT_HALF = _c("0x1.6a09e6p-1")
# log1p's rational approximation below sqrt(2) - 1 (Cephes)
_LOG1P_DEN = [_c(h) for h in (
    "0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7", "0x1.351946p+8",
    "0x1.b0db14p+7", "0x1.e0f304p+5")]
_LOG1P_NUM = [_c(h) for h in (
    "0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2", "0x1.de9738p+4",
    "0x1.e798ecp+5", "0x1.c8e75ap+5", "0x1.40a202p+4")]
_LOG1P_SMALL = _c("0x1.a8279ap-2")
# erf_inv (Giles): coefficients for w < 5 and for w >= 5
_ERFINV_LO = [_c(h) for h in (
    "0x1.e2cb1p-26", "0x1.70966cp-22", "-0x1.d8e6aep-19", "-0x1.26b582p-18",
    "0x1.ca65b6p-13", "-0x1.48a81p-10", "-0x1.11c9dep-8", "0x1.f91ec6p-3",
    "0x1.805c5ep+0")]
_ERFINV_HI = [_c(h) for h in (
    "-0x1.a3e136p-13", "0x1.a76ad6p-14", "0x1.61b8e4p-10", "-0x1.e17bcep-9",
    "0x1.7824f6p-8", "-0x1.f38baep-8", "0x1.354afcp-7", "0x1.006db6p+0",
    "0x1.6a9efcp+1")]
_SQRT2 = _c("0x1.6a09e6p+0")
_ONE_THIRD = _c("0x1.555556p-2")
_SQUEEZE = _c("0x1.0f27bcp-5")            # 0.0331 in float32


def log_f32(x):
    """Natural log of float32 ``x`` as the reference computes it (finite,
    zero, negative, infinite and NaN inputs included)."""
    x = _daz(x)
    v = torch.clamp_min(x, 2.0 ** -126)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    y = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = torch.where(low, e - 1.0, e)
    y2 = y * y
    y3 = y2 * y
    p = [fma(y, _LOG_P[2 * i], _LOG_P[2 * i + 1]) for i in range(3)]
    q = [fma(p[i], y, _LOG_P[6 + i]) for i in range(3)]
    r = fma(fma(q[0], y3, q[1]), y3, q[2])
    tail = fma(r, y3, e * _LOG_Q1)
    out = fma(e, _LOG_Q2, fma(y2, -0.5, y) + tail)
    out = torch.where(x > 0, out, torch.full_like(out, math.nan))
    out = torch.where(x == 0, torch.full_like(out, -math.inf), out)
    return torch.where(x == math.inf, x, out)


def log1p_f32(z):
    """``log(1 + z)`` for float32 ``z`` as the reference computes it."""
    z = _daz(z)
    large = log_f32(z + 1.0)
    z2 = z * z
    den = torch.ones_like(z)
    for c in _LOG1P_DEN:
        den = fma(den, z, c)
    num = torch.full_like(z, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma(num, z, c)
    small = z + fma(z2, -0.5, (z * z2) * _div(num, den))
    return torch.where(torch.abs(z) < _LOG1P_SMALL, small, large)


def erf_inv_f32(x):
    """Inverse error function of float32 ``x`` in [-1, 1] as the
    reference computes it (Giles' single-precision polynomials)."""
    x = _daz(x)
    lp = log1p_f32(x * -x)
    near = -lp < 5.0
    w = torch.where(near, -2.5 - lp, _sqrt(-lp) - 3.0)
    p = torch.where(near, _ERFINV_LO[0], _ERFINV_HI[0])
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = fma(p, w, torch.where(near, lo, hi))
    p = torch.where(torch.abs(x) == 1.0, torch.full_like(p, math.inf), p)
    return x * p


def normal(key, shape) -> torch.Tensor:
    """Standard normal float32 draws: ``sqrt(2) erf_inv(u)`` of a uniform
    ``u`` on ``[nextafter(-1, 0), 1)``."""
    u = uniform(key, shape, _c("-0x1.fffffep-1"), 1.0)
    return erf_inv_f32(u) * _SQRT2


def _rsqrt_f32(d: float) -> float:
    """``1/sqrt(d)`` as the reference's CPU build computes it: an
    estimate refined by two Newton steps with fused multiply-adds.  The
    correctly rounded estimate stands in for the hardware's; two steps
    leave no trace of the difference for the arguments tested."""
    d = torch.tensor(d, dtype=torch.float32)
    y = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    for _ in range(2):
        y = fma(y * -0.5, fma(d * y, y, -1.0), y)
    return float(y)


def gamma(key, a: float, shape) -> torch.Tensor:
    """Gamma(a) float32 draws, ``a >= 1``, by Marsaglia and Tsang's
    rejection method: element i runs its own loop on the i-th of
    ``split(key, prod(shape))``, as the reference's vectorised loop does
    (every element redraws until it accepts)."""
    a = float(torch.tensor(a, dtype=torch.float32))
    if not a >= 1.0:
        raise ValueError(f"gamma: a={a} < 1 is not supported")
    count = math.prod(shape)
    dev = key.device
    d = float(torch.tensor(a, dtype=torch.float32) - _ONE_THIRD)
    c = float(torch.tensor(_ONE_THIRD, dtype=torch.float32)
              * _rsqrt_f32(d))
    # the second half of each element's split feeds the reference's
    # a < 1 boost only
    keys, _ = split(split(key, count)).unbind(-2)
    X = torch.zeros(count, device=dev)
    V = torch.ones(count, device=dev)
    U = torch.full((count,), 2.0, device=dev)

    def reject(X, V, U):
        return (U >= fma(X * X, -_SQUEEZE, 1.0)) & (
            log_f32(U) >= X * 0.5 + d * ((1.0 - V) + log_f32(V)))

    live = reject(X, V, U)
    while bool(live.any()):
        nxt, x_key, u_key = split(keys, 3).unbind(-2)
        x = torch.zeros(count, device=dev)
        v = torch.full((count,), -1.0, device=dev)
        redraw = v <= 0
        while bool(redraw.any()):
            x_key, sub = split(x_key).unbind(-2)
            xn = normal(sub, ())
            x = torch.where(redraw, xn, x)
            v = torch.where(redraw, fma(xn, c, 1.0), v)
            redraw = v <= 0
        keys = torch.where(live[:, None], nxt, keys)
        X = torch.where(live, x * x, X)
        V = torch.where(live, v * v * v, V)
        U = torch.where(live, uniform(u_key, ()), U)
        live = reject(X, V, U)
    return (d * V).reshape(shape)


def t(key, df: float, shape) -> torch.Tensor:
    """Student's t float32 draws with ``df`` degrees of freedom (``df >=
    2``): ``normal * sqrt((df/2) / gamma(df/2))``."""
    key_n, key_g = split(key).unbind(-2)
    half = float(torch.tensor(df, dtype=torch.float32) * 0.5)
    n = normal(key_n, shape)
    g = gamma(key_g, half, shape)
    return n * _sqrt(_div(half, g))
