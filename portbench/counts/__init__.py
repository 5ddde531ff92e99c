"""Operation counts from shapes: the model FLOPs of a training step
(:mod:`.flops`), summed from the terms of the configuration's reference
kind (:mod:`.lm` for the ``lm`` kind).  Every term is named."""
