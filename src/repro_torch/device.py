"""Device resolution shared by every entry point.

The port runs on the GPU unless the caller names the CPU: ``"cuda"`` is
the default everywhere, and asking for it on a host without a GPU raises
rather than quietly running on the CPU.  Resolving a device also turns
TF32 off for matrix products and convolutions, because the reference
computes in float32 throughout and the parity checks are 1e-5-class.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``"cuda"`` / ``"cpu"`` / a ``torch.device`` -> ``torch.device``;
    raises ``RuntimeError`` for a CUDA device on a host without one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_device_or_meta(device=DEFAULT_DEVICE) -> torch.device:
    """:func:`resolve_device`, but ``"meta"`` (shapes only) passes
    through."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)
