"""repro_torch.train — the model-training tier (the port of
``repro/train``): ``steps`` builds the train steps (sync and stale
data-parallel AdamW, and the ECD-PSGD gossip step over stacked replicas)
over ``repro_torch.models`` + ``repro_torch.optim``, and ``checkpoint``
saves and restores trees of tensors in the reference's format."""
