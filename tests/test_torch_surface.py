"""The port's package surface against the reference's: every name a
``repro`` package exports resolves in the ``repro_torch`` package of the
same path, and every ``repro`` module has a port of that path, less
``repro_torch.NOT_PORTED`` (each with its reason).  The deprecated per-m
runners, the engine's ``sweep_*`` / ``run_algorithm_sweep`` and
``gain_growth_from_losses`` against the reference's on the same data:
minibatch, Hogwild! and DADM within 1e-5 at the horizons of
``tests/test_protocols.py`` (60 iterations, eval every 20); ECD-PSGD in
the envelope of ``tests/test_core.py::test_ecd_psgd_divergence_envelope``
(1e-3 at 60 iterations, 2e-2 at 120; never descent at 1500, ROADMAP
§C)."""

import importlib
import pkgutil
import types
import warnings

import jax
import numpy as np
import pytest

import repro
import repro_torch
from repro.core import scalability as JSc
from repro.core.algorithms import (run_dadm as j_dadm,
                                   run_ecd_psgd as j_ecd,
                                   run_hogwild as j_hog,
                                   run_minibatch as j_mb)
from repro.data import synth as JS
from repro.experiments import engine as JEng
from repro_torch import interop
from repro_torch.core import scalability as TSc
from repro_torch.core.algorithms import (run_dadm, run_ecd_psgd,
                                         run_hogwild, run_minibatch)
from repro_torch.experiments import engine as TEng

from _torch_threads import one_torch_thread  # noqa: F401

PACKAGES = ["repro"] + sorted(
    m.name for m in pkgutil.walk_packages(repro.__path__, "repro.")
    if m.ispkg)
KEEP = ("algorithm", "m", "iters", "eval_every", "iters_per_worker")


def _exports(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and not isinstance(v, types.ModuleType)]
    return sorted(names)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_resolve(pkg):
    ref = importlib.import_module(pkg)
    port = importlib.import_module(pkg.replace("repro", "repro_torch", 1))
    missing = [n for n in _exports(ref) if not hasattr(port, n)]
    assert not missing, f"{pkg}: {missing}"


def test_every_module_has_a_port_or_a_reason():
    def rel(root, prefix):
        return {m.name[len(prefix):] for m in pkgutil.walk_packages(
            root.__path__, prefix)}
    missing = rel(repro, "repro.") - rel(repro_torch, "repro_torch.")
    assert missing == set(repro_torch.NOT_PORTED)
    assert all(len(why) > 20 for why in repro_torch.NOT_PORTED.values())


def _split(gen, **kw):
    key = jax.random.PRNGKey(0)
    tr, te = JS.get_generator(gen)(key, **kw).split(key=key)
    return (tr, te), interop.split((tr.X, tr.y), (te.X, te.y), device="cpu")


@pytest.fixture(scope="module")
def higgs():
    return _split("higgs_like", n=400, d=12)


RUNNERS = {"minibatch": (j_mb, run_minibatch, {}),
           "hogwild": (j_hog, run_hogwild, {"gamma": 0.05}),
           "dadm": (j_dadm, run_dadm, {})}


@pytest.mark.parametrize("alg", sorted(RUNNERS))
@pytest.mark.parametrize("m", [1, 4])
def test_per_m_runner_matches_reference(higgs, alg, m):
    (jtr, jte), (ttr, tte) = higgs
    jrun, trun, kw = RUNNERS[alg]
    ref = jrun(jtr, jte, m=m, iters=60, eval_every=20, **kw)
    got = trun(ttr, tte, m=m, iters=60, eval_every=20, **kw)
    assert {k: got[k] for k in KEEP} == {k: ref[k] for k in KEEP}
    np.testing.assert_allclose(got["losses"], np.asarray(ref["losses"]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("iters,tol", [(60, 1e-3), (120, 2e-2)])
def test_run_ecd_psgd_in_envelope(higgs, iters, tol):
    (jtr, jte), (ttr, tte) = higgs
    ref = j_ecd(jtr, jte, m=4, iters=iters, eval_every=20)
    got = run_ecd_psgd(ttr, tte, m=4, iters=iters, eval_every=20)
    assert {k: got[k] for k in KEEP} == {k: ref[k] for k in KEEP}
    assert np.isfinite(got["losses"]).all()
    assert np.abs(np.asarray(got["losses"])
                  - np.asarray(ref["losses"])).max() <= tol


def test_run_minibatch_batch_size_shim(higgs):
    _, (tr, te) = higgs
    with pytest.warns(DeprecationWarning):
        old = run_minibatch(tr, te, batch_size=3, iters=40, eval_every=20)
    new = run_minibatch(tr, te, m=3, iters=40, eval_every=20)
    assert old["losses"] == new["losses"] and old["m"] == 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(TypeError):
            run_minibatch(tr, te, m=2, batch_size=3, iters=40,
                          eval_every=20)


@pytest.mark.parametrize("alg,kw", [("minibatch", {}),
                                    ("dadm", {}),
                                    ("hogwild", {"gamma": 0.05}),
                                    ("momentum", {})])
def test_run_algorithm_sweep_matches_reference(higgs, alg, kw):
    (jtr, jte), (ttr, tte) = higgs
    ms = [1, 2, 4]
    ref = JEng.run_algorithm_sweep(alg, jtr, jte, ms, iters=60,
                                   eval_every=20, **kw)
    got = TEng.run_algorithm_sweep(alg, ttr, tte, ms, iters=60,
                                   eval_every=20, **kw)
    assert {k: v for k, v in got.items() if k != "losses"} == \
        {k: v for k, v in ref.items() if k != "losses"}
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=1e-5)
    assert TEng.SWEEPERS.keys() == JEng.SWEEPERS.keys()


def test_gain_growth_from_losses_matches_reference(higgs):
    (jtr, jte), (ttr, tte) = higgs
    ref = [j_mb(jtr, jte, m=m, iters=60, eval_every=20) for m in (1, 2, 4)]
    got = [run_minibatch(ttr, tte, m=m, iters=60, eval_every=20)
           for m in (1, 2, 4)]
    for at in (0, 20, 40, 60, 10 ** 6):
        np.testing.assert_allclose(TSc.gain_growth_from_losses(got, at),
                                   JSc.gain_growth_from_losses(ref, at),
                                   rtol=0, atol=2e-5)
    hand = [{"eval_every": 100, "losses": [3.0, 2.0, 1.0]},
            {"eval_every": 100, "losses": [2.5, 1.5, 0.5]}]
    for at in (0, 100, 200, 10 ** 6):
        assert TSc.gain_growth_from_losses(hand, at) == \
            JSc.gain_growth_from_losses(hand, at)
