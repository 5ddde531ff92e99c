"""Build and load the CUDA extension from the sources in ``csrc/``.

The first kernel launch of a process compiles ``csrc/*.cu`` with ``nvcc``
for ``sm_90a`` (Hopper) and the CPython binding with the host compiler,
all in one ``torch.utils.cpp_extension.load`` call, into
``build/torch_kernels/`` at the repository root; later calls reuse the
loaded module.  Fast math is deliberately off: the quantization kernel
must divide and round exactly as the reference does.  The build and the
wrappers' launch counters are safe to use from several threads (the
advisor service launches kernels from its request threads).
"""

from __future__ import annotations

import functools
import os
import threading

from repro_torch.telemetry import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", name)
           for name in ("bind.cpp", "l0.cu", "quantize.cu", "rmsnorm.cu",
                        "flash_attention.cu")]
BUILD_DIR = os.path.join(_HERE, os.pardir, os.pardir, os.pardir, "build",
                         "torch_kernels")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


def ptxas_command(name: str) -> list[str]:
    """The ``nvcc`` command that compiles ``csrc/<name>`` alone with the
    build's flags and ``-Xptxas -v``, printing each kernel's registers,
    spills and shared memory to stderr; its object file is discarded."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    return [nvcc, *CUDA_FLAGS, "-Xptxas=-v", "-c",
            os.path.join(_HERE, "csrc", name), "-o", os.devnull]


_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load():
    from torch.utils.cpp_extension import load
    build_dir = os.path.normpath(BUILD_DIR)
    os.makedirs(build_dir, exist_ok=True)
    return load(name="repro_torch_kernels", sources=SOURCES,
                build_directory=build_dir, extra_cflags=["-O3"],
                extra_cuda_cflags=CUDA_FLAGS, verbose=False)


def extension():
    """The loaded ``repro_torch_kernels`` module (built on first call;
    concurrent first calls build once).  The build is a ``compile`` span
    under an active tracer."""
    with _BUILD_LOCK:
        if _load.cache_info().currsize:
            return _load()
        with trace.span("compile", sources=len(SOURCES)):
            return _load()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: launches from
    concurrent threads are all counted."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
