"""recompute_ms_per_step.train: device ms per traced step of the
checkpoints' recompute in the backward pass, the program's ``model.block``
and ``model.ce`` spans of phase ``recompute``."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_step(spans.RECOMPUTE)
