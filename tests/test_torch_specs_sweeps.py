"""Five paper and extension specs new to the port, each run by the
reference's runner and by the port's on the CPU at a tiny size (quick
grids, 40 iterations, n = 256, 2 seeds), artifacts held to each other at
the contract of `_torch_sweep_parity` (1e-6 relative characters, 1e-5
curves, ECD-PSGD 2e-2, equal costs and m_max)."""

import pytest

from _torch_sweep_parity import check_spec

SMALL = dict(quick=True, iters=40, n=256, seeds=2)


@pytest.mark.parametrize("name", ["variance_sparsity", "scalability_study",
                                  "diversity", "ls", "problem_generality"])
def test_spec_artifact_matches_reference(name):
    got, _ = check_spec(name, **SMALL)
    assert got["backend"] == "torch"
    assert got["spec"]["n_seeds"] == 2
