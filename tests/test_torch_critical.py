"""The critical-parameter algorithms (momentum, local SGD, async-SVRG), the
fault axis and the six m_max predictors against the reference.

Engine curves from identical datasets and draws within 1e-5; inside the
port, bucketed = flat = per-m within 1e-6; zero-rate faults bit-exact
with ``fault=None`` (``torch.equal``); fault streams and interop draws
equal bit for bit; predictors' m_max equal and their other outputs
within 1e-6 relative."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.analysis import fit as JF
from repro.core.algorithms import base as JB
from repro.data import synth as JS
from repro.experiments import engine as JEng
from repro.resilience import faults as JFault
from repro_torch import interop
from repro_torch import random as R
from repro_torch.analysis import fit as TF
from repro_torch.core.algorithms import base as TB
from repro_torch.experiments import engine as TEng
from repro_torch.experiments import registry as TR
from repro_torch.experiments import spec as TS
from repro_torch.resilience import faults as TFault

MS = [1, 2, 3, 4, 8]
FAULT = {"straggle_rate": 0.3, "straggle_rounds": 3, "corrupt_rate": 0.15,
         "corrupt_kind": "sign_flip", "drop_rate": 0.1,
         "duplicate_rate": 0.1, "seed": 7}
QUANTIZE = {**FAULT, "corrupt_kind": "quantize", "corrupt_bits": 3,
            "corrupt_rate": 0.4}
CASES = {
    "momentum": {"gamma": 0.02},
    "momentum-nesterov": {"gamma": 0.02, "beta": 0.8, "nesterov": True},
    "local_sgd": {"gamma": 0.1, "sync_every": 4},
    "local_sgd-H1": {"gamma": 0.1, "sync_every": 1},
    "local_sgd-easgd": {"gamma": 0.1, "sync_every": 3, "averaging": 0.5},
    "local_sgd-fault": {"gamma": 0.1, "sync_every": 2, "fault": FAULT},
    "local_sgd-quantize": {"gamma": 0.1, "sync_every": 2, "fault": QUANTIZE},
    "async_svrg": {"gamma": 0.1, "anchor_every": 10},
    "hogwild-fault": {"gamma": 0.05, "fault": FAULT},
    "hogwild-quantize": {"gamma": 0.05, "fault": QUANTIZE},
}


def _alg(case):
    return case.split("-")[0]


@pytest.fixture(scope="module")
def split():
    key = jax.random.PRNGKey(0)
    ds = JS.make_character_knob(key, n=300, d=12, variance=1.0,
                                density=0.5, duplication=0.25)
    tr, te = ds.split(key=key)
    return tr, te, interop.split((tr.X, tr.y), (te.X, te.y))


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference(case, split):
    tr, te, (ttr, tte) = split
    kw = dict(iters=80, eval_every=8, **CASES[case])
    ref = JEng.run_algorithm_sweep(_alg(case), tr, te, MS, **kw)
    got = TEng.sweep(_alg(case), ttr, tte, MS, **kw)
    assert {k: v for k, v in got.items() if k != "losses"} == \
        {k: v for k, v in ref.items() if k != "losses"}
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["momentum", "local_sgd-fault",
                                  "async_svrg", "hogwild-fault"])
def test_seed_axis_matches_reference(case, split):
    tr, te, (ttr, tte) = split
    kw = dict(iters=40, eval_every=10, n_seeds=3, **CASES[case])
    ref = JEng.run_algorithm_sweep(_alg(case), tr, te, [1, 4], **kw)
    got = TEng.sweep(_alg(case), ttr, tte, [1, 4], **kw)
    np.testing.assert_allclose(got["losses_seeds"], ref["losses_seeds"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(set(CASES) - {"local_sgd-quantize"}))
def test_bucketed_flat_per_m_agree(case, split):
    _, _, (tr, te) = split
    run = lambda **mode: np.asarray(TEng.sweep(  # noqa: E731
        _alg(case), tr, te, MS, iters=60, eval_every=10, **CASES[case],
        **mode)["losses"])
    bucketed, flat, per_m = (run(bucketed=True), run(bucketed=False),
                             run(per_m=True))
    np.testing.assert_allclose(bucketed, flat, rtol=0, atol=1e-6)
    np.testing.assert_allclose(flat, per_m, rtol=0, atol=1e-6)


def test_quantize_corruption_reads_padded_rows_as_the_reference(split):
    """The quantize corruption's scale is the max over one member's whole
    (m_pad, d) gradient bank, padded rows included, in the reference as
    in the port: local SGD's bucketed and flat grids differ under it, and
    the port matches the reference in each mode."""
    tr, te, (ttr, tte) = split
    kw = dict(iters=60, eval_every=10, **CASES["local_sgd-quantize"])
    curves = {}
    for bucketed in (True, False):
        ref = JEng.run_algorithm_sweep("local_sgd", tr, te, MS,
                                       bucketed=bucketed, **kw)["losses"]
        got = TEng.sweep("local_sgd", ttr, tte, MS, bucketed=bucketed,
                         **kw)["losses"]
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        curves[bucketed] = np.asarray(got)
    assert np.abs(curves[True] - curves[False]).max() > 1e-3


@pytest.mark.parametrize("alg", ["hogwild", "local_sgd"])
def test_zero_rate_fault_is_bit_exact(alg, split):
    _, _, (tr, te) = split
    kw = dict(iters=60, eval_every=10, gamma=0.1, n_seeds=2)
    clean = TEng.sweep(alg, tr, te, MS, **kw)
    zero = TEng.sweep(alg, tr, te, MS, fault=TFault.FaultSpec(seed=3), **kw)
    assert torch.equal(torch.tensor(clean["losses_seeds"]),
                       torch.tensor(zero["losses_seeds"]))


@pytest.mark.parametrize("alg", ["hogwild", "local_sgd"])
def test_faulted_runs_reproducible_and_distinct(alg, split):
    _, _, (tr, te) = split
    kw = dict(iters=60, eval_every=10, gamma=0.1)
    a = TEng.sweep(alg, tr, te, MS, fault=FAULT, **kw)["losses"]
    b = TEng.sweep(alg, tr, te, MS, fault=dict(FAULT), **kw)["losses"]
    clean = TEng.sweep(alg, tr, te, MS, **kw)["losses"]
    other = TEng.sweep(alg, tr, te, MS, fault={**FAULT, "seed": 8},
                       **kw)["losses"]
    assert a == b
    assert a != clean and a != other


@pytest.mark.parametrize("alg,shape", [("hogwild", (50,)),
                                       ("local_sgd", (50, 8))])
def test_fault_schedule_is_shared_across_seeds(alg, shape):
    """The stream comes from the fault seed, not the sweep key, and is the
    reference's bit for bit."""
    t_alg = TB.get_algorithm(alg)(fault=FAULT)
    d1 = t_alg.make_draws(R.PRNGKey(0), 100, 50, 8, 12)
    d2 = t_alg.make_draws(R.PRNGKey(1), 100, 50, 8, 12)
    ref = JFault.make_stream(JFault.resolve(FAULT), shape)
    for k in ("drop", "dup", "straggle", "corrupt"):
        assert torch.equal(d1[k], d2[k])
        np.testing.assert_array_equal(d1[k].numpy(), np.asarray(ref[k]))
        assert d1[k].shape == shape
    assert not torch.equal(d1["i"], d2["i"])


def test_fault_spec_validation_and_dict_round_trip():
    spec = TFault.resolve(FAULT)
    assert spec.to_dict() == JFault.resolve(FAULT).to_dict()
    assert TFault.resolve(spec.to_dict()) == spec
    assert TFault.resolve(None) is None
    for bad in ({"drop_rate": 1.5}, {"corrupt_kind": "bitrot"},
                {"straggle_rounds": 0}, {"corrupt_bits": 0}, {"nope": 1}):
        with pytest.raises(ValueError):
            TFault.resolve(bad)
    with pytest.raises(TypeError):
        TFault.resolve(0.5)


@pytest.mark.parametrize("kind", ["sign_flip", "quantize"])
def test_corrupt_matches_reference(kind):
    spec = dataclasses.replace(TFault.resolve(QUANTIZE), corrupt_kind=kind)
    jspec = JFault.resolve(spec.to_dict())
    rng = np.random.default_rng(0)
    g = rng.standard_normal((3, 5, 7)).astype(np.float32)
    flag = (rng.random((3, 5)) < 0.5).astype(np.float32)
    got = TFault.corrupt(spec, torch.tensor(g), torch.tensor(flag))
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(JFault.corrupt(jspec, g[b], flag[b])))


def test_fingerprint_splits_on_fault_kwargs():
    spec = TR.get_spec("fault_tolerance", quick=True)
    job = spec.jobs[2]
    assert job.kwargs["fault"]["straggle_rate"] > 0
    changed = dataclasses.replace(job, kwargs={
        **job.kwargs, "fault": {**job.kwargs["fault"], "seed": 8}})
    other = dataclasses.replace(spec, jobs=(changed,) + spec.jobs[1:2]
                                + spec.jobs[3:])
    base = dataclasses.replace(spec, jobs=(job,) + spec.jobs[1:2]
                               + spec.jobs[3:])
    assert TS.fingerprint(other) != TS.fingerprint(base)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interop_draws_equal_port_draws(case):
    alg = _alg(case)
    ref = JB.get_algorithm(alg)(**CASES[case]).make_draws(
        jax.random.PRNGKey(3), 500, 30, 12)
    carried = interop.draws(alg, jax.tree.map(np.asarray, ref), d=12)
    own = TB.get_algorithm(alg)(**CASES[case]).make_draws(
        R.PRNGKey(3), 500, 30, 12, 12)
    if isinstance(own, dict):
        assert set(own) == set(carried)
        for k in own:
            assert torch.equal(own[k], carried[k]), k
    else:
        assert torch.equal(own, carried)


def test_new_algorithms_are_registered_as_in_reference():
    for name in ("momentum", "local_sgd", "async_svrg"):
        t, j = TB.get_algorithm(name), JB.get_algorithm(name)
        for attr in ("asynchronous", "bucketed_default", "force_flat",
                     "predictor", "gamma_scale"):
            assert getattr(t, attr) == getattr(j, attr), (name, attr)
    assert TB.PREDICTOR_KINDS == JB.PREDICTOR_KINDS


@pytest.mark.parametrize("fn,args", [
    ("sync_mmax", (2.0,)), ("sync_mmax", (0.05, 1e-2)),
    ("dadm_mmax", (0.9,)), ("hogwild_mmax", (0.3, 0.8, 0.2)),
    ("momentum_mmax", (2.0, 0.9)), ("momentum_mmax", (3.0, 0.5, 1e-2)),
    ("local_sgd_mmax", (2.0, 8)), ("local_sgd_mmax", (0.5, 1)),
    ("svrg_mmax", (0.3, 0.8, 0.2, 0.25)), ("svrg_mmax", (1.0, 1.0, 0.5, 1.0)),
])
def test_scalar_predictors_match_reference(fn, args):
    assert getattr(TF, fn)(*args) == getattr(JF, fn)(*args)


@pytest.mark.parametrize("name,kw", [
    ("predict_sync_mmax", {}), ("predict_dadm_mmax", {}),
    ("predict_hogwild_mmax", {}),
    ("predict_momentum_mmax", {"beta": 0.8}),
    ("predict_local_sgd_mmax", {"sync_every": 16}),
    ("predict_svrg_mmax", {"anchor_every": 25}),
])
def test_dataset_predictors_match_reference(name, kw, split):
    tr, _, (ttr, _) = split
    ref, got = getattr(JF, name)(tr.X, **kw), getattr(TF, name)(ttr.X, **kw)
    assert got["predicted_m_max"] == ref["predicted_m_max"]
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k] == pytest.approx(float(v), rel=1e-6), k


def test_characters_predictors_match_reference():
    ch = {"mean_feature_variance": 1.7, "omega": 30.0, "omega_frac": 0.6,
          "delta": 0.7, "rho": 0.4, "n": 2000}
    for name, kw in (("momentum", {"beta": 0.7}),
                     ("local_sgd", {"sync_every": 4}),
                     ("svrg", {"anchor_every": 100})):
        fn = f"predict_{name}_from_characters"
        assert getattr(TF, fn)(ch, **kw) == getattr(JF, fn)(ch, **kw)
