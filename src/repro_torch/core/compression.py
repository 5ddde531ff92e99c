"""Stochastic quantization — ECD-PSGD's compression operator C(.) (port of
``repro/core/compression.py``).

Unbiased (E[dequantize(quantize(x))] = x, the paper's Eq. 7) stochastic
rounding to ``bits``-bit integers.  The uniform noise ``u`` is an input,
drawn by the caller with `repro_torch.random`, so the operator is
deterministic given its inputs.  The scale is ``max(max|x|, 1e-12) /
qmax``, the maximum taken with ``torch.amax`` (:func:`row_scales`); the
elementwise passes go through K3 and K4 (`repro_torch.kernels.quantize`),
which run their plain versions on CPU tensors.  ECD-PSGD's step does not
come here: it calls the fused kernel ``kernels.quantize.
ecd_compress_rows``.  :func:`quantize_rows_stochastic` gives each row of a
2-D input its own scale; :func:`quantize_stochastic` is the per-tensor
(one-row) case.
"""

from __future__ import annotations

from repro_torch.kernels import quantize as kq

row_scales = kq.row_scales


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


def quantize_error(x, u, *, bits=8):
    """C(x) - x: the error of one stochastic quantization of ``x`` with
    noise ``u`` (one scale for the whole tensor), float32."""
    q, scale = quantize_stochastic(x, u, bits=bits)
    return dequantize(q, scale) - x.float()
