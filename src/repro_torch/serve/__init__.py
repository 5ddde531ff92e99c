"""repro_torch.serve — prefill and single-token decode steps, the greedy
generate loop and the batched request driver ``SlotDriver`` with its
``mask_tree`` (``engine.py``)."""
