"""non_gemm_ms_per_step.train: device milliseconds per step of every
kernel that is not a matrix product (copies and fills aside).  A kernel
is a matrix product when its name holds one of ``GEMM``."""

GEMM = ("nvjet", "xmma", "gemm", "cutlass")


def read(ctx):
    t = ctx.trace
    if t.steps == 0:
        return None
    ms = sum((e - s) / 1e3 for name, s, e in t.device
             if not name.startswith(("Memcpy", "Memset"))
             and not any(g in name.lower() for g in GEMM))
    return ms / t.steps
