"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

  ``csim.l0_rows``            K1, per-row L0 distance
  ``csim.l0_shift_sum``       K2, per-batch L0 totals over cyclic shifts
  ``quantize.quantize_rows``  K3, row-scaled stochastic quantization
  ``quantize.dequantize_rows``  K4, row-scaled dequantization
  ``quantize.ecd_compress_rows``  K3 and K4 fused with ECD-PSGD's updates,
                              one launch per step (the sweep's path)
  ``rmsnorm.rmsnorm_2d``      K5, fused RMSNorm (``rmsnorm.rmsnorm``: any rank)
  ``flash_attention.flash_attention_bhsd``  K6, causal / sliding-window GQA
                              flash attention (``flash_attention.
                              flash_attention``: the model's layout)

Each wrapper runs its plain version on a CPU tensor and launches its
kernel on a CUDA tensor (building the extension on first use); it never
falls back from one to the other.  ``wrapper.launches`` counts kernel
launches.  :func:`launch_counts` / :func:`reset_launch_counts` read and
clear all seven counters.
"""

from repro_torch.kernels import csim, flash_attention, quantize, rmsnorm

WRAPPERS = {
    "l0_rows": csim.l0_rows,
    "l0_shift_sum": csim.l0_shift_sum,
    "quantize_rows": quantize.quantize_rows,
    "dequantize_rows": quantize.dequantize_rows,
    "ecd_compress_rows": quantize.ecd_compress_rows,
    "rmsnorm": rmsnorm.rmsnorm_2d,
    "flash_attention": flash_attention.flash_attention_bhsd,
}


def launch_counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
