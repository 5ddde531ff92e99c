"""Float32 arithmetic as the reference's compiler performs it.

On the CPU the reference's compiler contracts ``a * b + c`` into one
fused multiply-add, rounded once.  PyTorch runs each operation as its own
kernel and rounds every product.  Where a step feeds a rounding
threshold — ECD-PSGD's ``floor`` in the quantizer — one such rounding
turns into a whole quantum, so those steps use :func:`fma`: the float32
product is exact in float64, and the float64 sum rounded once to
float32 matches the fused result (up to a double rounding on an exact
tie).
"""

from __future__ import annotations

import torch


def fma(a, b, c):
    """``a * b + c`` rounded once to float32; tensors or Python floats
    that are float32 values."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else float(v)
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)
