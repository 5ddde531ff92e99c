"""repro_torch.serve — prefill and single-token decode steps, the greedy
generate loop and the batched request driver ``SlotDriver`` with its
``mask_tree`` (``engine.py``), and the same steps on a mesh."""

from repro_torch.serve.engine import SlotDriver, mask_tree  # noqa: F401
