"""Operation counts from shapes: the model FLOPs of a training step
(:mod:`.flops`).  Every term is named."""
