"""repro_torch.optim — the optimizers of the model-training tier (SGD,
momentum, AdamW as init/update pairs over trees of tensors), the port of
``repro/optim``.  The paper-side algorithms in
``repro_torch.core.algorithms`` carry their own update rules."""

from repro_torch.optim.optimizers import (adamw_init, adamw_update,
                                          momentum_init, momentum_update,
                                          sgd_init, sgd_update)
