"""The paper's four parallel training algorithms on the registered
`Algorithm` protocol (port of ``repro/core/algorithms``): Hogwild!
(Alg 1), mini-batch SGD (Alg 2), DADM (Alg 3) and ECD-PSGD (Alg 4), plus
the three critical-parameter algorithms: momentum, local SGD and
async-SVRG, and the reference's deprecated per-m runners (``run_*``,
`runners.py`, adapters over the engine).  Importing this package
populates the registry."""

from repro_torch.core.algorithms.base import (ALGORITHMS, Algorithm,  # noqa
                                              SimContext, get_algorithm,
                                              register_algorithm,
                                              registered_algorithms)
from repro_torch.core.algorithms.lr import (logloss, lr_grad,  # noqa: F401
                                            test_logloss)
from repro_torch.core.algorithms.hogwild import Hogwild  # noqa: F401
from repro_torch.core.algorithms.minibatch import Minibatch  # noqa: F401
from repro_torch.core.algorithms.ecd_psgd import EcdPsgd  # noqa: F401
from repro_torch.core.algorithms.dadm import Dadm  # noqa: F401
from repro_torch.core.algorithms.momentum import Momentum  # noqa: F401
from repro_torch.core.algorithms.local_sgd import LocalSgd  # noqa: F401
from repro_torch.core.algorithms.async_svrg import AsyncSvrg  # noqa: F401
from repro_torch.core.algorithms.runners import (run_dadm,  # noqa: F401
                                                 run_ecd_psgd, run_hogwild,
                                                 run_minibatch)
