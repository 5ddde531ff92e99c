"""backward_ms_per_step.train: device ms per traced step of the backward
pass without the recompute nested in it: the program's ``train.backward``
span less its ``recompute`` spans."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_step([("train.backward", "backward")],
                             spans.RECOMPUTE)
