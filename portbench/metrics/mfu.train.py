"""mfu.train: the traced window's model FLOPs (``counts.flops``: every
application of a shared block, Mamba2's sequence sum; not the input
lookup, not the recomputation) over its host-clock seconds, as a share
of the card's bf16 peak (``peaks.json``), in %."""


def read(ctx):
    t = ctx.trace
    if t.steps == 0 or t.window_s <= 0:
        return None
    done = ctx.flops_per_token * ctx.tokens_per_step * t.steps
    return 100.0 * done / t.window_s / ctx.peaks["bf16_flops_per_s"]
