"""The whole slice: the port's upper_bound artifact (paper Table II) on the
CPU against the reference's, at 60 iterations.  Same datasets and
characters, curves within the engine tolerances (1e-5; ECD-PSGD 1e-3,
the reference's own envelope), equal measured and predicted m_max per
job, and fingerprints that differ by backend."""

import json

import numpy as np
import pytest

from repro.experiments import registry as JR
from repro.experiments import runner as JRun
from repro.experiments import spec as JS
from repro_torch.experiments import cache as TC
from repro_torch.experiments import registry as TR
from repro_torch.experiments import run as TRun_cli
from repro_torch.experiments import runner as TRun
from repro_torch.experiments import spec as TS

from _torch_threads import one_torch_thread  # noqa: F401

ITERS = 60
_EXACT = ("n", "d", "diversity", "diversity_ratio")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    ref = JRun.run_sweep(JR.get_spec("upper_bound", iters=ITERS),
                         use_cache=False)
    cache_dir = str(tmp_path_factory.mktemp("torch_cache"))
    got = TRun.run_sweep(TR.get_spec("upper_bound", iters=ITERS),
                         device="cpu", cache_dir=cache_dir)
    return ref, got, cache_dir


def test_spec_and_datasets_match(artifacts):
    ref, got, _ = artifacts
    assert got["spec"] == ref["spec"]
    assert set(got["datasets"]) == set(ref["datasets"])
    for name, info in ref["datasets"].items():
        mine = got["datasets"][name]
        assert (mine["n"], mine["d"]) == (info["n"], info["d"])
        for k, v in info["characters"].items():
            if k in _EXACT:
                assert mine["characters"][k] == v, (name, k)
            else:
                assert mine["characters"][k] == pytest.approx(
                    v, rel=1e-6, abs=0.0), (name, k)


def test_curves_and_readouts_match(artifacts):
    ref, got, _ = artifacts
    assert set(got["jobs"]) == set(ref["jobs"])
    for key, jr in ref["jobs"].items():
        mine = got["jobs"][key]
        tol = 1e-3 if jr["algorithm"] == "ecd_psgd" else 1e-5
        np.testing.assert_allclose(mine["losses"], jr["losses"], rtol=0,
                                   atol=tol, err_msg=key)
        assert mine["status"] == jr["status"] == "ok"
        assert mine["measured_m_max"] == jr["measured_m_max"], key
        assert mine["costs"] == jr["costs"], key
        assert mine["epsilon"] == pytest.approx(jr["epsilon"], abs=tol)
        assert ("predicted" in mine) == ("predicted" in jr)
        if "predicted" in jr:
            assert mine["predicted"]["predicted_m_max"] == \
                jr["predicted"]["predicted_m_max"], key
            for k, v in jr["predicted"].items():
                assert mine["predicted"][k] == pytest.approx(v, rel=1e-6), k


def test_fingerprints_differ_by_backend():
    tspec = TR.get_spec("upper_bound", iters=ITERS)
    jspec = JR.get_spec("upper_bound", iters=ITERS)
    assert TS.computational_dict(tspec) == JS.computational_dict(jspec)
    assert TS.fingerprint(tspec) != JS.fingerprint(jspec)
    assert TS.BACKEND == "torch"
    assert TS.fingerprint(tspec) == TS.fingerprint(
        TR.get_spec("upper_bound", iters=ITERS))
    assert TS.fingerprint(tspec) != TS.fingerprint(
        TR.get_spec("upper_bound", iters=2 * ITERS))


def test_cache_is_the_ports_own(artifacts):
    """The port stores into its own directory under a backend-marked
    fingerprint: a port artifact never answers a reference lookup, nor the
    other way round."""
    from repro.experiments import cache as JC
    _, got, cache_dir = artifacts
    assert TC.DEFAULT_CACHE_DIR != JC.DEFAULT_CACHE_DIR
    tspec = TR.get_spec("upper_bound", iters=ITERS)
    jspec = JR.get_spec("upper_bound", iters=ITERS)
    path = got["cache"]["path"]
    with open(path) as f:
        stored = json.load(f)
    assert stored["backend"] == "torch"
    assert not set(stored) & set(TC.VOLATILE_KEYS)
    assert JC.load(cache_dir, "upper_bound", JS.fingerprint(jspec)) is None
    hit = TRun.run_sweep(tspec, device="cpu", cache_dir=cache_dir)
    assert hit["cache"]["hit"]
    assert hit["jobs"] == stored["jobs"]


def test_cli_on_cpu(tmp_path, capsys):
    assert TRun_cli.main(["--spec", "upper_bound", "--iters", "20",
                          "--device", "cpu", "--cache-dir",
                          str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "measured vs predicted scalability upper bound" in out
    assert "hogwild/ub" in out
