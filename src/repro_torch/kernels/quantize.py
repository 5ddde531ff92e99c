"""Stochastic-quantization kernels K3 and K4 (CUDA source:
``csrc/quantize.cu``).

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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

BITS = (4, 8, 16)


def qmax_of(bits: int) -> float:
    if bits not in BITS:
        raise ValueError(f"bits={bits} must be one of {BITS}")
    return 2.0 ** (bits - 1) - 1.0


def qdtype_of(bits: int) -> torch.dtype:
    return torch.int8 if qmax_of(bits) < 128 else torch.int16


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
    quantize_rows.launches += 1
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
    dequantize_rows.launches += 1
    return out


dequantize_rows.launches = 0
