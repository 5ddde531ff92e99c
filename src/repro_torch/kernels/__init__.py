"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  ``csim.l0_rows``            K1, per-row L0 distance
  ``csim.l0_shift_sum``       K2, per-batch L0 totals over cyclic shifts
  ``quantize.quantize_rows``  K3, row-scaled stochastic quantization
  ``quantize.dequantize_rows``  K4, row-scaled dequantization

Each wrapper runs its plain version on a CPU tensor and launches its
kernel on a CUDA tensor (building the extension on first use); it never
falls back from one to the other.  ``wrapper.launches`` counts kernel
launches.  :func:`launch_counts` / :func:`reset_launch_counts` read and
clear all four counters.
"""

from repro_torch.kernels import csim, quantize

WRAPPERS = {
    "l0_rows": csim.l0_rows,
    "l0_shift_sum": csim.l0_shift_sum,
    "quantize_rows": quantize.quantize_rows,
    "dequantize_rows": quantize.dequantize_rows,
}


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
