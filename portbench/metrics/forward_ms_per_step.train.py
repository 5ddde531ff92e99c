"""forward_ms_per_step.train: device ms per traced step of the forward
pass, the program's ``train.forward`` span (``models/model.py``
``forward_hidden`` and ``chunked_ce``)."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_step([("train.forward", "forward")])
