"""L0-distance kernels K1 and K2 (CUDA source: ``csrc/l0.cu``).

K1 :func:`l0_rows` replaces the Pallas kernel ``repro/kernels/csim.py``
``_l0_kernel`` / ``l0_rows``: the per-row count ``sum_k [|x_ik - y_ik| >
tol]``, or ``sum_k [|x_ik| > tol]`` when ``y`` is None (the row supports,
read from one input).  K2 :func:`l0_shift_sum` replaces ``csim_kernel``'s
scan over rolled copies of X: for a batched ``(nb, b, d)`` input it
returns each batch's integer total ``sum_{j=1..r} sum_i ||x_i -
x_{(i+j) % b}||_0``.  One kernel serves Eq. 3's C_sim (``nb=1, b=n,
r=range``) and the within-batch pair scan of LS_sync (``r=b-1``).

K1 is bound by bytes read.  K2 is bound by launch latency at the main
path's shapes: it is one launch with no fill, its blocks staging their
rows in shared memory and meeting through counters that the wrapper
keeps per (device, stream), zeroed once (:func:`shift_sum_plan` picks
the blocks and the kernel takes them as given; ``csrc/l0.cu`` says
why).
Counts are exact integers, so kernel and plain version agree exactly
whatever the order of summation.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build

# K2's blocks: rows a block owns, the shared memory it may stage (the
# static 48 KB, no opt-in, less the kernel's own; the launch refuses
# more), the narrowest feature slice, the grid it aims for (about two
# blocks per SM of an H100; of 4 or 8 rows and 128 or 256 blocks, 8 with
# 256 timed best on an H100), and the bits of a packed counter that hold
# a batch's total
ROWS_PER_BLOCK = 8
SMEM_BYTES = 47 * 1024
MIN_WIDTH = 32
TARGET_BLOCKS = 256
_PACK_BITS = 40
_INT31 = 2 ** 31 - 1


def _check_float32(name, *tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def l0_rows_plain(x, y=None, tol=0.0):
    """Plain version of K1: ``(n, d) x (n, d) -> (n,)`` float32 counts;
    ``y=None`` counts against zero."""
    diff = torch.abs(x.float() if y is None else x.float() - y.float()) > tol
    return diff.sum(dim=1).to(torch.float32)


def l0_rows(x, y=None, tol=0.0):
    """K1: per-row L0 distance, ``(n, d) x (n, d) -> (n,)`` float32;
    ``y=None`` counts against zero from ``x`` alone.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (float32, contiguous, same shape and device)."""
    if x.device.type == "cpu":
        return l0_rows_plain(x, y, tol)
    others = () if y is None else (y,)
    if x.device.type != "cuda" or any(t.device != x.device for t in others):
        raise ValueError(f"l0_rows: unsupported devices {x.device}, "
                         f"{[t.device for t in others]}")
    if x.dim() != 2 or any(t.shape != x.shape for t in others):
        raise ValueError(f"l0_rows: shapes {tuple(x.shape)} and "
                         f"{[tuple(t.shape) for t in others]} must be equal "
                         f"and 2-D")
    _check_float32("l0_rows", x, *others)
    n, d = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.extension().l0_rows(x.data_ptr(),
                                    0 if y is None else y.data_ptr(),
                                    out.data_ptr(), n, d, float(tol), stream)
    build.check(err, "l0_rows")
    build.count_launch(l0_rows)
    return out


l0_rows.launches = 0


def l0_shift_sum_plain(X, r: int, tol=0.0):
    """Plain version of K2: ``(nb, b, d) -> (nb,)`` int64 totals of the
    L0 distances between row i and row (i + j) % b, j = 1..r."""
    nb, b, _ = X.shape
    rows = torch.arange(b, device=X.device)
    tot = torch.zeros(nb, dtype=torch.int64, device=X.device)
    for j in range(1, r + 1):
        rolled = X[:, (rows + j) % b]
        tot += (torch.abs(X - rolled) > tol).sum(dim=(1, 2))
    return tot


@dataclasses.dataclass(frozen=True)
class ShiftPlan:
    """How one K2 launch cuts ``(nb, b, d)`` with ``r`` shifts into blocks.

    ``r = q * b + rem``; the distinct offsets are ``s_lo .. s_lo + n_off
    - 1`` (all of ``0 .. b-1`` once ``r >= b``), offset s weighing q + 1
    for s in 1..rem and q otherwise.  A block owns ``rows`` consecutive
    rows of a batch (``tiles`` per batch), ``chunk`` of the offsets
    (``chunks``) and ``width`` features (``slices``), and stages
    ``stage_rows`` rows of ``width`` floats in shared memory.  ``packed``:
    a batch's blocks meet through one packed atomic (its total, at most
    ``b d r``, fits ``_PACK_BITS``), else through accumulator and ticket."""
    rows: int
    width: int
    chunk: int
    tiles: int
    chunks: int
    slices: int
    s_lo: int
    n_off: int
    q: int
    rem: int
    stage_rows: int
    blocks: int
    packed: bool

    @property
    def smem_bytes(self) -> int:
        return self.stage_rows * self.width * 4


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def shift_sum_plan(nb: int, b: int, d: int, r: int) -> ShiftPlan:
    """K2's blocks for ``(nb, b, d)`` and ``r`` shifts (``b >= 1``,
    ``r >= 0``): ``ROWS_PER_BLOCK`` rows a block, the whole row when its
    staged range fits ``SMEM_BYTES``, else the widest slice that fits (a
    multiple of 4 floats, keeping 16-byte copies), else ``MIN_WIDTH``
    features and offsets in chunks; then slices narrowed towards
    ``TARGET_BLOCKS`` blocks, never below ``MIN_WIDTH``.  The kernel
    takes every field as given."""
    q, rem = divmod(r, b)
    s_lo, n_off = (0, b) if q else (1, r)
    rows = min(ROWS_PER_BLOCK, b)
    tiles = _ceil_div(b, rows)
    cap = SMEM_BYTES // 4
    one = s_lo + n_off + rows - 1          # staged rows with one chunk
    width, chunk = d, max(n_off, 1)
    if one * d > cap:
        width = cap // one // 4 * 4
        if width < min(d, MIN_WIDTH):
            width = min(d, MIN_WIDTH)
            chunk = min(chunk, cap // width - 2 * rows + 1)
    chunks = _ceil_div(n_off, chunk) if n_off > chunk else 1
    if nb * tiles * chunks < TARGET_BLOCKS and width > MIN_WIDTH:
        want = _ceil_div(TARGET_BLOCKS, nb * tiles * chunks)
        narrow = _ceil_div(_ceil_div(d, want), 4) * 4
        width = min(width, max(MIN_WIDTH, narrow))
    slices = _ceil_div(d, width) if d > width else 1
    stage_rows = one if chunks == 1 else 2 * rows + chunk - 1
    per_batch = tiles * chunks * slices
    packed = b * d * r < 2 ** _PACK_BITS and per_batch < 2 ** (64 - _PACK_BITS)
    return ShiftPlan(rows, width, chunk, tiles, chunks, slices, s_lo, n_off,
                     q, rem, stage_rows, nb * per_batch, packed)


# K2's counters, int64 tensors of 2 * cap words (cap accumulators, then
# cap tickets), all zero between launches: one per (device index, stream)
# for launches outside a graph capture, and one for the capture under way
# (zeroed inside the graph, so every replay starts from zero).  A new
# capture's buffer replaces the last one's, so at most one buffer outlives
# its graph, and a graph's launches never share counters with a stream's.
_counters = {}
_capture_counters = {}


def _shift_counters(device, stream: int, nb: int):
    capture = build.extension().capture_id(stream)
    cache = _capture_counters if capture else _counters
    key = (device.index, stream, capture)
    buf = cache.get(key)
    if buf is None or buf.numel() < 2 * nb:
        if capture:
            cache.clear()
        buf = torch.zeros(2 * max(nb, 1024), dtype=torch.int64,
                          device=device)
        cache[key] = buf
    return buf


def l0_shift_sum(X, r: int, tol=0.0):
    """K2: per-batch L0 totals over the cyclic shifts ``1..r``,
    ``(nb, b, d) -> (nb,)`` int64.  Plain version on a CPU tensor, the
    kernel on a CUDA tensor (float32, contiguous): one launch, no fill."""
    if X.device.type == "cpu":
        return l0_shift_sum_plain(X, r, tol)
    if X.device.type != "cuda":
        raise ValueError(f"l0_shift_sum: unsupported device {X.device}")
    if X.dim() != 3:
        raise ValueError(f"l0_shift_sum: expected (nb, b, d), got "
                         f"{tuple(X.shape)}")
    _check_float32("l0_shift_sum", X)
    nb, b, d = X.shape
    r = max(int(r), 0)
    if nb == 0 or b == 0:
        return torch.zeros(nb, dtype=torch.int64, device=X.device)
    plan = shift_sum_plan(nb, b, d, r)
    if b * d > _INT31 or r > _INT31 or plan.blocks > _INT31:
        raise ValueError(f"l0_shift_sum: {tuple(X.shape)} with r={r} "
                         f"exceeds the kernel's 31-bit indices")
    out = torch.empty(nb, dtype=torch.int64, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    counters = _shift_counters(X.device, stream, nb)
    err = build.extension().l0_shift_sum(
        X.data_ptr(), out.data_ptr(), counters.data_ptr(),
        counters.numel() // 2, b, d, plan.rows, plan.width, plan.chunk,
        plan.tiles, plan.chunks, plan.slices, plan.s_lo, plan.n_off, plan.q,
        plan.rem, plan.stage_rows, plan.blocks,
        _PACK_BITS if plan.packed else 0, float(tol), stream)
    build.check(err, "l0_shift_sum")
    build.count_launch(l0_shift_sum)
    return out


l0_shift_sum.launches = 0


def empty_launch(device) -> None:
    """Launch an empty kernel on ``device``'s current stream: the launch
    floor K1's and K2's times are read against (not counted)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    build.check(build.extension().empty(stream), "empty")
