"""Shared check of the spec-level parity tests: one spec run by the
reference's runner and by the port's on the CPU, the port's artifact
held to the reference's with `repro_torch.experiments.compare`.

Tolerances: characters and C_sim within 1e-6 relative, with n, d,
diversity and diversity_ratio exact; curves (every seed) within 1e-5;
ECD-PSGD within 2e-2, the reference's own envelope for execution-order
differences (tests/test_core.py::test_ecd_psgd_divergence_envelope):
its quantizer turns an ulp of summation order into a quantum, and ls's
small_ls_dense cell differs by 1.8e-3 on its second seed at 40
iterations; statuses, costs, measured and predicted m_max equal.
"""

import warnings

import numpy as np
import pytest

from repro.experiments import registry as JR
from repro.experiments import runner as JRun
from repro_torch.experiments import compare as TC
from repro_torch.experiments import registry as TR
from repro_torch.experiments import runner as TRun

EXACT = ("n", "d", "diversity", "diversity_ratio")


def check_spec(name, **overrides):
    with warnings.catch_warnings():
        # a tiny n may leave a step size unstable for a cell: both
        # runners then mark the job diverged, which is compared too
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = JRun.run_sweep(JR.get_spec(name, **overrides), use_cache=False)
    got = TRun.run_sweep(TR.get_spec(name, **overrides), device="cpu",
                         use_cache=False)
    report = TC.compare(got, ref)
    assert set(got["datasets"]) == set(ref["datasets"])
    for ds, info in ref["datasets"].items():
        mine = got["datasets"][ds]
        assert report["datasets"][ds] <= 1e-6, ds
        for k in EXACT:
            assert mine["characters"][k] == info["characters"][k], (ds, k)
        assert ("csim" in mine) == ("csim" in info)
        if "csim" in info:
            assert mine["csim"] == pytest.approx(info["csim"], rel=1e-6)
    assert list(got["jobs"]) == list(ref["jobs"])
    for key, jr in ref["jobs"].items():
        mine, row = got["jobs"][key], report["jobs"][key]
        tol = 2e-2 if jr["algorithm"] == "ecd_psgd" else 1e-5
        assert mine["status"] == jr["status"], key
        assert row["max_abs_curve_diff"] <= tol, (key, row)
        if "losses_seeds" in jr:
            np.testing.assert_allclose(mine["losses_seeds"],
                                       jr["losses_seeds"], rtol=0, atol=tol,
                                       err_msg=key)
        assert row["measured_m_max"][0] == row["measured_m_max"][1], key
        assert row["predicted_m_max"][0] == row["predicted_m_max"][1], key
        assert mine.get("costs") == jr.get("costs"), key
        if "predicted" in jr:
            for k, v in jr["predicted"].items():
                assert mine["predicted"][k] == pytest.approx(v, rel=1e-6), k
    return got, ref
