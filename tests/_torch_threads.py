"""One CPU thread for the port's tests and the processes they start.

The suite runs in pytest-xdist workers (six of them on an 8-core host
under ``-n 6``).  PyTorch's CPU operations default to one OpenMP thread
per core in every worker, and each of the four-rank gloo groups and
reference subprocesses the port's tests start does the same, so the
threads outnumber the cores many times over and spin against each
other.  Each
port test module takes :func:`one_torch_thread` (import it into the
module: it is autouse) and each subprocess :func:`capped_env`; results do
not depend on the thread count beyond float summation order, which every
tolerance of these tests already covers.
"""

import os

import pytest
import torch

# OpenMP (PyTorch's intra-op pool), MKL and OpenBLAS (numpy) in a child
THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
              "OPENBLAS_NUM_THREADS": "1"}


def capped_env(**extra):
    """``os.environ`` with one thread per pool, and ``extra``."""
    return dict(os.environ, **THREAD_ENV, **extra)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's intra-op threads at 1 for the module, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
