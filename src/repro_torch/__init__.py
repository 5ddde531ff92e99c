"""PyTorch port of `repro`, the dataset-characters scalability study.

The package mirrors the JAX reference's module layout (``data``, ``core``,
``kernels``, ``analysis``, ``experiments``, ``configs``, ``models``,
``serve``, ``launch``) so each module's counterpart is found by path.  It
runs on an NVIDIA GPU by default: entry points take ``device="cuda"`` and
raise when no GPU is present unless the caller asks for the CPU
explicitly.  Hand-written CUDA kernels in ``kernels/csrc`` carry the
L0-distance characters, ECD-PSGD's stochastic quantization, and the
language model's RMSNorm and flash attention; their plain PyTorch
versions serve CPU tensors and act as the kernels' oracles.
"""

from repro_torch.device import resolve_device  # noqa: F401
