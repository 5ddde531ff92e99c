"""Fused RMSNorm kernel K5 (CUDA source: ``csrc/rmsnorm.cu``).

:func:`rmsnorm_2d` replaces the Pallas kernel ``repro/kernels/rmsnorm.py``
``_rmsnorm_kernel`` / ``rmsnorm_2d``; :func:`rmsnorm` is the any-rank
wrapper, the counterpart of ``repro/kernels/ops.py`` ``rmsnorm``.  The
function is the reference model's ``apply_rmsnorm`` (``ref.rmsnorm_ref``)::

    y = x * (1 / sqrt(mean(x**2) + eps)) * gain   (float32, cast to x's type)

The float32 squares are summed in float64 and the mean rounded once to
float32, so the result does not depend on the order of summation: kernel
and plain version agree to the last bit but for rare ties, and both are
within the reference's 1e-6 of its float32 sum.  It is bound by bytes
moved on the card: each row is read once and written once.  Every RMSNorm
of the port's model goes through :func:`rmsnorm`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

EPS = 1e-6
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x, gain, eps=EPS):
    """Plain version of K5, any rank: normalizes the last dimension."""
    xf = x.to(torch.float32)
    var = torch.mean((xf * xf).to(torch.float64), dim=-1,
                     keepdim=True).to(torch.float32)
    inv = torch.reciprocal(torch.sqrt(var + eps))
    return (xf * inv * gain.to(torch.float32)).to(x.dtype)


def rmsnorm_2d(x, gain, eps=EPS):
    """K5: ``x`` (n, d), ``gain`` (d,) -> (n, d) in x's type.  Plain
    version on a CPU tensor, the kernel on a CUDA tensor (float32 or
    bfloat16, contiguous, gain of x's type and device)."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gain, eps)
    if x.device.type != "cuda" or gain.device != x.device:
        raise ValueError(f"rmsnorm_2d: x and gain must share one CUDA "
                         f"device, got {x.device} and {gain.device}")
    if x.dim() != 2 or gain.shape != x.shape[1:]:
        raise ValueError(f"rmsnorm_2d: shapes x {tuple(x.shape)}, gain "
                         f"{tuple(gain.shape)}")
    if x.dtype not in DTYPES or gain.dtype != x.dtype:
        raise TypeError(f"rmsnorm_2d: x and gain must both be float32 or "
                        f"bfloat16, got {x.dtype} and {gain.dtype}")
    if not (x.is_contiguous() and gain.is_contiguous()):
        raise ValueError("rmsnorm_2d: x and gain must be contiguous")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.extension().rmsnorm(
        x.data_ptr(), gain.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], float(eps), DTYPES[x.dtype], stream)
    build.check(err, "rmsnorm")
    build.count_launch(rmsnorm_2d)
    return out


rmsnorm_2d.launches = 0


def rmsnorm(x, gain, eps=EPS):
    """Any-rank wrapper of K5: normalizes the last dimension."""
    shape = x.shape
    return rmsnorm_2d(x.reshape(-1, shape[-1]), gain, eps).reshape(shape)
