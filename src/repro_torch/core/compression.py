"""Stochastic quantization — ECD-PSGD's compression operator C(.) (port of
``repro/core/compression.py``).

Unbiased (E[dequantize(quantize(x))] = x, the paper's Eq. 7) stochastic
rounding to ``bits``-bit integers.  The uniform noise ``u`` is an input,
drawn by the caller with `repro_torch.random`, so the operator is
deterministic given its inputs.  The scale is ``max(max|x|, 1e-12) /
qmax``, the maximum taken with ``torch.amax``; the elementwise passes go
through K3 and K4 (`repro_torch.kernels.quantize`), which run their plain
versions on CPU tensors.  :func:`quantize_rows_stochastic` gives each row of a
2-D input its own scale — ECD-PSGD's per-worker compression in one call;
:func:`quantize_stochastic` is the per-tensor (one-row) case.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import quantize as kq


def row_scales(x2, bits: int = 8):
    """Per-row scale ``max(max_k |x_rk|, 1e-12) / qmax`` as float32 (r,).
    The division is an IEEE float32 division, as in the reference's
    engine; it divides by a tensor on x's device because PyTorch on CUDA
    turns a division by a Python number into a multiply by its
    reciprocal."""
    qmax = torch.tensor(kq.qmax_of(bits), dtype=torch.float32,
                        device=x2.device)
    return torch.clamp_min(torch.abs(x2).amax(dim=1), 1e-12) / qmax


def quantize_rows_stochastic(x2, u, *, bits=8):
    """(r, d) -> (q int8/int16 (r, d), scale (r,)), one scale per row."""
    x2 = x2.float().contiguous()
    scale = row_scales(x2, bits)
    return kq.quantize_rows(x2, u.contiguous(), scale, bits), scale


def dequantize_rows(q, scale):
    """(r, d) integers at per-row scales (r,) -> float32."""
    return kq.dequantize_rows(q.contiguous(), scale.contiguous())


def quantize_stochastic(x, u, *, bits=8):
    """x -> (q int8/int16 of x's shape, scale f32 scalar), one scale for
    the whole tensor."""
    q, scale = quantize_rows_stochastic(x.reshape(1, -1), u.reshape(1, -1),
                                        bits=bits)
    return q.reshape(x.shape), scale[0]


def dequantize(q, scale):
    x = dequantize_rows(q.reshape(1, -1), scale.reshape(1))
    return x.reshape(q.shape)
