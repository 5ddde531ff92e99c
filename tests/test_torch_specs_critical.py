"""The three specs built on the `character_knob` generator (the
character surface and the two critical-parameter specs), run by the
reference's runner and by the port's on the CPU at a tiny size (quick
grids, 40 iterations, n = 256, 2 seeds), artifacts held to each other at
the contract of `_torch_sweep_parity` (1e-6 relative characters, 1e-5
curves, equal costs and m_max); the faulted jobs of fault_tolerance at
1e-5 too."""

import pytest

from _torch_sweep_parity import check_spec
from _torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(quick=True, iters=40, n=256, seeds=2)


ALGORITHMS = {"character_surface": {"minibatch"},
              "critical_params": {"momentum", "local_sgd", "async_svrg"},
              "fault_tolerance": {"hogwild", "local_sgd"}}


@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_spec_artifact_matches_reference(name):
    got, _ = check_spec(name, **SMALL)
    assert {jr["algorithm"] for jr in got["jobs"].values()} == \
        ALGORITHMS[name]
    assert all(jr["status"] == "ok" for jr in got["jobs"].values())
    assert all("measured_m_max" in jr for jr in got["jobs"].values())
