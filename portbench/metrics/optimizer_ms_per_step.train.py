"""optimizer_ms_per_step.train: device ms per traced step of AdamW's
update, the program's ``train.optimizer`` span (``optim/optimizers.py``
``adamw_update_``)."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_step([("train.optimizer", "optimizer")])
