"""attention_ms_per_step.train: device ms per traced step of the plain
attention's core (scores, mask, softmax, P.V; ``models/attention.py``
``gqa_attention``) in the forward pass, the recompute and the backward
pass: the program's ``attn.core`` spans of every phase."""

from portbench.harness import spans


def read(ctx):
    return spans.ms_per_step([("attn.core", None)])
