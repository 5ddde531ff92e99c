"""L0-distance kernels K1 and K2 (CUDA source: ``csrc/l0.cu``).

K1 :func:`l0_rows` replaces the Pallas kernel ``repro/kernels/csim.py``
``_l0_kernel`` / ``l0_rows``: the per-row count ``sum_k [|x_ik - y_ik| >
tol]``.  K2 :func:`l0_shift_sum` replaces ``csim_kernel``'s scan over
rolled copies of X: for a batched ``(nb, b, d)`` input it returns each
batch's integer total ``sum_{j=1..r} sum_i ||x_i - x_{(i+j) % b}||_0``,
reading row ``(i + j) % b`` in place.  One kernel serves Eq. 3's C_sim
(``nb=1, b=n, r=range``) and the within-batch pair scan of LS_sync
(``r=b-1``).

Both are bound by bytes read on the card: each input element is read
once from device memory.  Counts are exact integers, so kernel and plain
version agree exactly whatever the order of summation.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def _check_float32(name, *tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")


def l0_rows_plain(x, y, tol=0.0):
    """Plain version of K1: ``(n, d) x (n, d) -> (n,)`` float32 counts."""
    diff = torch.abs(x.float() - y.float()) > tol
    return diff.sum(dim=1).to(torch.float32)


def l0_rows(x, y, tol=0.0):
    """K1: per-row L0 distance, ``(n, d) x (n, d) -> (n,)`` float32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (float32, contiguous, same shape and device)."""
    if x.device.type == "cpu":
        return l0_rows_plain(x, y, tol)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"l0_rows: unsupported devices {x.device}, "
                         f"{y.device}")
    if x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"l0_rows: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} must be equal and 2-D")
    _check_float32("l0_rows", x, y)
    n, d = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.extension().l0_rows(x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), n, d, float(tol), stream)
    build.check(err, "l0_rows")
    l0_rows.launches += 1
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


def l0_shift_sum(X, r: int, tol=0.0):
    """K2: per-batch L0 totals over the cyclic shifts ``1..r``,
    ``(nb, b, d) -> (nb,)`` int64.  Plain version on a CPU tensor, the
    kernel on a CUDA tensor (float32, contiguous)."""
    if X.device.type == "cpu":
        return l0_shift_sum_plain(X, r, tol)
    if X.device.type != "cuda":
        raise ValueError(f"l0_shift_sum: unsupported device {X.device}")
    if X.dim() != 3:
        raise ValueError(f"l0_shift_sum: expected (nb, b, d), got "
                         f"{tuple(X.shape)}")
    _check_float32("l0_shift_sum", X)
    nb, b, d = X.shape
    out = torch.zeros(nb, dtype=torch.int64, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = build.extension().l0_shift_sum(X.data_ptr(), out.data_ptr(), nb, b,
                                         d, int(r), float(tol), stream)
    build.check(err, "l0_shift_sum")
    l0_shift_sum.launches += 1
    return out


l0_shift_sum.launches = 0
