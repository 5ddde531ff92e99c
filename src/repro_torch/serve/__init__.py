"""repro_torch.serve — prefill and single-token decode steps and the
greedy generate loop of the port's LM (``engine.py``).  The reference's
``SlotDriver`` and ``mask_tree`` wait for the service port (ROADMAP A13).
"""
