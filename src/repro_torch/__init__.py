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

#: the reference's modules with no port of that name, and why: every other
#: module of ``repro`` has a counterpart here by path, and every name a
#: ``repro`` package exports resolves in the port's package of that path
#: (``tests/test_torch_surface.py`` reads this list)
NOT_PORTED = {
    "kernels.ops": "the jnp / Pallas dispatch of the reference's kernels; "
                   "the port's wrappers live beside each kernel "
                   "(kernels/csim.py, quantize.py, rmsnorm.py, "
                   "flash_attention.py)",
    "kernels.ref": "the reference's pure-jnp kernel references; each port "
                   "kernel module holds its plain PyTorch version",
    "launch.hlo_stats": "parses compiled HLO text, which an eager port has "
                        "none of; launch/comm_stats.py records the same "
                        "statistics as the step runs",
}
