"""Stochastic-quantization kernels K3 and K4, and ECD-PSGD's compression
tail fused into one kernel (CUDA source: ``csrc/quantize.cu``).

K3 :func:`quantize_rows` replaces the Pallas kernel
``repro/kernels/quantize.py`` ``_quant_kernel`` / ``quantize_stochastic_2d``
and K4 :func:`dequantize_rows` replaces ``_dequant_kernel`` /
``dequantize_2d``.  Where the reference takes one scale per tensor, these
take one per row, a ``(r,)`` tensor, so ECD-PSGD quantizes every worker's
vector in one launch; the per-tensor case is a single row.

  q = clip(floor(x / scale + u), -qmax - 1, qmax),  qmax = 2**(bits-1) - 1
  x' = q * scale

``q`` is int8 for bits 4 and 8 and int16 for bits 16, as in the
reference; the uniform noise ``u`` is an input.  Both kernels are bound
by bytes moved on the card.

:func:`ecd_compress_rows` is K3 and K4 redesigned for the ECD-PSGD step:
the per-row scale, quantize, dequantize and the three elementwise updates
around C(.) in one launch, with the step's coefficients as kernel
arguments, so the step neither syncs nor builds a device scalar.  Its
plain version :func:`ecd_compress_rows_plain` is the step's former
sequence of PyTorch operations, and the kernel reproduces each of its
roundings.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.numerics import fma
from repro_torch.kernels import build

BITS = (4, 8, 16)


def qmax_of(bits: int) -> float:
    if bits not in BITS:
        raise ValueError(f"bits={bits} must be one of {BITS}")
    return 2.0 ** (bits - 1) - 1.0


def qdtype_of(bits: int) -> torch.dtype:
    return torch.int8 if qmax_of(bits) < 128 else torch.int16


def row_scales(x2, bits: int = 8):
    """Per-row scale ``max(max_k |x_rk|, 1e-12) / qmax`` as float32 (r,).
    The division is an IEEE float32 division, as in the reference's
    engine; it divides by a tensor on x's device because PyTorch on CUDA
    turns a division by a Python number into a multiply by its
    reciprocal.  ``torch.full`` fills that tensor on the device: a tensor
    built from a host value would be a copy that waits on the stream."""
    qmax = torch.full((), qmax_of(bits), dtype=torch.float32,
                      device=x2.device)
    return torch.clamp_min(torch.abs(x2).amax(dim=1), 1e-12) / qmax


def quantize_rows_plain(x, u, scale, bits: int = 8):
    """Plain version of K3: ``(r, d)`` float32 -> int8 / int16."""
    qmax = qmax_of(bits)
    q = torch.floor(x / scale[:, None] + u)
    q = torch.clamp(q, -qmax - 1.0, qmax)
    return q.to(qdtype_of(bits))


def quantize_rows(x, u, scale, bits: int = 8):
    """K3: stochastic rounding of each row of ``x`` (r, d) at its own
    ``scale`` (r,) with noise ``u`` (r, d).  Plain version on a CPU
    tensor, the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, u, scale, bits)
    if x.device.type != "cuda" or u.device != x.device \
            or scale.device != x.device:
        raise ValueError("quantize_rows: x, u and scale must share one "
                         "CUDA device")
    if x.dim() != 2 or u.shape != x.shape or scale.shape != x.shape[:1]:
        raise ValueError(f"quantize_rows: shapes x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)}, scale {tuple(scale.shape)}")
    for t in (x, u, scale):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("quantize_rows: inputs must be contiguous "
                            "float32")
    qmax = qmax_of(bits)
    q = torch.empty(x.shape, dtype=qdtype_of(bits), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.extension().quantize_rows(
        x.data_ptr(), u.data_ptr(), scale.data_ptr(), q.data_ptr(),
        x.shape[0], x.shape[1], qmax, q.element_size(), stream)
    build.check(err, "quantize_rows")
    build.count_launch(quantize_rows)
    return q


quantize_rows.launches = 0


def dequantize_rows_plain(q, scale):
    """Plain version of K4: ``(r, d)`` int8 / int16 -> float32."""
    return q.to(torch.float32) * scale[:, None]


def dequantize_rows(q, scale):
    """K4: ``q * scale`` per row, ``(r, d)`` int8 / int16 -> float32.
    Plain version on a CPU tensor, the kernel on a CUDA tensor."""
    if q.device.type == "cpu":
        return dequantize_rows_plain(q, scale)
    if q.device.type != "cuda" or scale.device != q.device:
        raise ValueError("dequantize_rows: q and scale must share one CUDA "
                         "device")
    if q.dim() != 2 or scale.shape != q.shape[:1]:
        raise ValueError(f"dequantize_rows: shapes q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if q.dtype not in (torch.int8, torch.int16) or not q.is_contiguous():
        raise TypeError("dequantize_rows: q must be contiguous int8/int16")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        raise TypeError("dequantize_rows: scale must be contiguous float32")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.extension().dequantize_rows(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), q.shape[0],
        q.shape[1], q.element_size(), stream)
    build.check(err, "dequantize_rows")
    build.count_launch(dequantize_rows)
    return out


dequantize_rows.launches = 0


def ecd_coefficients(gamma: float, t: int) -> dict:
    """ECD-PSGD's step coefficients at 0-based iteration ``t`` as Python
    floats, rounded as the reference rounds them: ``t + 1``, ``t/2`` and
    ``2/t`` in float32; ``-gamma`` and ``1 - t/2`` enter a float64
    product as they are."""
    tf = np.float32(t + 1)
    half = float(tf / np.float32(2.0))
    two_t = np.float32(2.0) / tf
    return {"neg_gamma": float(-gamma), "z_keep": 1.0 - half, "half": half,
            "y_keep": float(np.float32(1.0) - two_t), "two_t": float(two_t)}


def ecd_compress_rows_plain(grads, x_half, xs, ys, u, gamma: float, t: int,
                            bits: int = 8):
    """Plain version of :func:`ecd_compress_rows`: ``(r, d)`` float32 rows
    -> ``(x_new, y_new)``."""
    c = ecd_coefficients(gamma, t)
    x_new = fma(c["neg_gamma"], grads, x_half)
    # z = (1 - t/2) x_t + (t/2) x_{t+1};  y = (1-2/t) y + (2/t) C(z)
    z = fma(c["z_keep"], xs, c["half"] * x_new)
    scale = row_scales(z, bits)
    cz = dequantize_rows_plain(quantize_rows_plain(z, u, scale, bits), scale)
    return x_new, fma(c["y_keep"], ys, c["two_t"] * cz)


def ecd_compress_rows(grads, x_half, xs, ys, u, gamma: float, t: int,
                      bits: int = 8):
    """ECD-PSGD's compression tail at iteration ``t`` on rows ``r =
    members * m_pad`` of width ``d``, all ``(r, d)`` contiguous float32:

      x_new = x_half - gamma grads;  z = (1 - t/2) xs + (t/2) x_new
      y_new = (1 - 2/t) ys + (2/t) dequantize(quantize(z, u))

    with one scale per row.  Returns ``(x_new, y_new)``.  Plain version on
    CPU tensors, one kernel launch on CUDA tensors."""
    qmax = qmax_of(bits)
    ins = (grads, x_half, xs, ys, u)
    dev = grads.device
    if any(a.device != dev for a in ins):
        raise ValueError("ecd_compress_rows: inputs must share one device")
    if grads.dim() != 2 or grads.shape[1] == 0 \
            or any(a.shape != grads.shape for a in ins):
        raise ValueError("ecd_compress_rows: inputs must be (r, d) with d > "
                         f"0 and one shape, got "
                         f"{[tuple(a.shape) for a in ins]}")
    for a in ins:
        if a.dtype != torch.float32 or not a.is_contiguous():
            raise TypeError("ecd_compress_rows: inputs must be contiguous "
                            "float32")
    if dev.type == "cpu":
        return ecd_compress_rows_plain(grads, x_half, xs, ys, u, gamma, t,
                                       bits)
    if dev.type != "cuda":
        raise ValueError(f"ecd_compress_rows: device {dev} is neither the "
                         "CPU nor CUDA")
    c = ecd_coefficients(gamma, t)
    x_new = torch.empty(grads.shape, dtype=torch.float32, device=dev)
    y_new = torch.empty(grads.shape, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.extension().ecd_compress_rows(
        *(a.data_ptr() for a in ins), x_new.data_ptr(), y_new.data_ptr(),
        grads.shape[0], grads.shape[1], c["neg_gamma"], c["z_keep"],
        c["y_keep"], c["half"], c["two_t"], qmax, stream)
    build.check(err, "ecd_compress_rows")
    build.count_launch(ecd_compress_rows)
    return x_new, y_new


ecd_compress_rows.launches = 0
