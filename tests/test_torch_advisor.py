"""The port's advisor (`repro_torch.core.advisor`), the rest of
`analysis.fit`, `analysis.stats` and `serve.SlotDriver` against the
reference's, on the same numpy inputs.

Tolerances: masked dataset characters within 1e-6 absolute with n and d
exact (diversity exact through the batched path); masked and scalar
gradient characters within 1e-5 relative or 1e-6 absolute (the cosine
similarity sits near 0, where only the absolute bound means anything;
its einsum and norm sum in another order); `from_dataset` characters
within 1e-6 relative and every integer m_max exact; the regression,
confidence, cost-law fits and bootstrap statistics within 1e-9 on shared
artifact dicts (the same numpy arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import fit as JF
from repro.analysis import stats as JS
from repro.core import advisor as JA
from repro_torch.analysis import fit as TF
from repro_torch.analysis import stats as TS
from repro_torch.core import advisor as TA
from repro_torch.serve.engine import SlotDriver, mask_tree
from repro_torch.service.batcher import ProbeBatcher

from _torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(7)
STRATEGIES = ("hogwild", "sync", "dadm", "momentum", "local_sgd", "svrg")


def _datasets():
    return [RNG.normal(size=(30, 5)) * 2.0,
            (RNG.random(size=(44, 9)) > 0.8) * RNG.normal(size=(44, 9)),
            np.repeat(RNG.normal(size=(4, 6)), 10, axis=0),
            (RNG.random(size=(64, 16)) > 0.95) * RNG.random(size=(64, 16))]


def _advisors():
    return TA.ScalabilityAdvisor(device="cpu"), JA.ScalabilityAdvisor()


def _padded(Xs, slots, R, D):
    Xp = np.zeros((slots, R, D), np.float32)
    rm = np.zeros((slots, R), np.float32)
    cm = np.zeros((slots, D), np.float32)
    for s, X in enumerate(Xs):
        r, c = X.shape
        Xp[s, :r, :c] = X
        rm[s, :r] = 1.0
        cm[s, :c] = 1.0
    return Xp, rm, cm


# ---------------------------------------------------------------------------
# masked (slot-batched) characters
# ---------------------------------------------------------------------------

def test_masked_dataset_characters_match_reference():
    """Five slots, one of them all padding: every character within 1e-6
    of the reference's, n and d exact, the empty slot all zeros."""
    Xp, rm, cm = _padded(_datasets(), 5, 64, 16)
    ref = JA.masked_dataset_characters(jnp.asarray(Xp), jnp.asarray(rm),
                                       jnp.asarray(cm))
    got = TA.masked_dataset_characters(torch.tensor(Xp), torch.tensor(rm),
                                       torch.tensor(cm))
    assert tuple(got) == TA.DATASET_KEYS == tuple(ref)
    for k in TA.DATASET_KEYS:
        a, b = np.asarray(ref[k]), got[k].numpy()
        if k in ("n", "d"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=k)
        assert b[4] == 0.0 or k == "density", k


def test_masked_grad_characters_match_reference():
    F = np.zeros((4, 5, 300), np.float32)
    sm = np.zeros((4, 5), np.float32)
    pm = np.zeros((4, 300), np.float32)
    for s, (m, p) in enumerate([(4, 300), (5, 120), (2, 7)]):
        F[s, :m, :p] = RNG.normal(size=(m, p)) * (RNG.random((m, p)) > 0.3)
        sm[s, :m] = 1.0
        pm[s, :p] = 1.0
    ref = JA.masked_grad_characters(jnp.asarray(F), jnp.asarray(sm),
                                    jnp.asarray(pm))
    got = TA.masked_grad_characters(torch.tensor(F), torch.tensor(sm),
                                    torch.tensor(pm))
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_batched_characters_match_reference_and_sequential():
    """The batcher (slots and the oversize fallback) against the
    reference's batcher and the port's own sequential `from_dataset`."""
    Xs = _datasets()
    items = list(enumerate(Xs))
    ref = JA.ScalabilityAdvisor().dataset_characters_batch(Xs)
    batched = ProbeBatcher(n_slots=2, max_rows=48, max_cols=12,
                           device="cpu")
    got = batched.measure(items)
    assert batched.stats()["fallback"] == 1         # the 64 x 16 probe
    adv = TA.ScalabilityAdvisor(device="cpu")
    for i, X in items:
        seq = adv.from_dataset(X)
        assert set(got[i]) == set(ref[i])
        for k, v in ref[i].items():
            if k in ("n", "d", "diversity", "diversity_ratio"):
                assert got[i][k] == v == seq[k], (i, k)
            else:
                assert got[i][k] == pytest.approx(v, rel=0, abs=1e-6), k
                assert got[i][k] == pytest.approx(seq[k], rel=0, abs=1e-6)


def test_from_dataset_matches_reference():
    adv, ref_adv = _advisors()
    for X in _datasets():
        ref, got = ref_adv.from_dataset(X), adv.from_dataset(X)
        assert set(got) == set(ref)
        for strat in STRATEGIES:
            assert got[strat]["predicted_m_max"] == \
                ref[strat]["predicted_m_max"], strat
        for k, v in ref.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-7), k
        assert got["recommendation"] == ref["recommendation"]


def test_grad_probes_match_reference():
    grads = [{"w": RNG.normal(size=(3, 4)), "b": RNG.normal(size=(4,)),
              "nested": [RNG.normal(size=(2,)), None]} for _ in range(5)]
    sparse = [[RNG.normal(size=(6,)) * (RNG.random(6) > 0.7)]
              for _ in range(3)]
    adv, ref_adv = _advisors()
    leaves = TA.tree_leaves(grads[0])
    for a, b in zip(leaves, jax.tree.leaves(grads[0])):
        np.testing.assert_array_equal(a, np.asarray(b))
    for probe in (grads, sparse):
        ref, got = ref_adv.from_grads(probe), adv.from_grads(probe)
        for k in ("predicted_m_max_sync", "predicted_m_max_stale",
                  "recommendation", "valid"):
            assert got[k] == ref[k], k
        for k in ("grad_variance", "grad_noise_scale", "grad_sparsity",
                  "shard_cosine_similarity"):
            assert got[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-6), k
    ref_b = ref_adv.grad_characters_batch([grads, [grads[0]], sparse], 4)
    got_b = adv.grad_characters_batch([grads, [grads[0]], sparse], 4)
    assert got_b[1] is None and ref_b[1] is None
    for r, g in ((ref_b[0], got_b[0]), (ref_b[2], got_b[2])):
        for k, v in r.items():
            assert g[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


@pytest.mark.parametrize("kind,probe", [
    ("dataset", np.full((4, 3), np.nan)), ("dataset", np.zeros((1, 3))),
    ("dataset", np.zeros((5,))), ("dataset", None),
    ("grads", []), ("grads", [[np.ones(3)]]),
    ("grads", [[np.ones(3)], [np.array([np.inf, 0.0, 1.0])]]),
    ("grads", [[np.ones(3)], [np.zeros((0,))]])])
def test_invalid_probes_match_reference(kind, probe):
    adv, ref_adv = _advisors()
    fn = "from_dataset" if kind == "dataset" else "from_grads"
    got, ref = getattr(adv, fn)(probe), getattr(ref_adv, fn)(probe)
    assert got == ref
    assert got["valid"] is False and got["predicted_m_max_conservative"] == 1


# ---------------------------------------------------------------------------
# fit: regression, confidence, cost-law fits; stats
# ---------------------------------------------------------------------------

def _artifact(seed, n_jobs=6, n_seeds=3):
    """A synthetic sweep artifact: datasets with characters, healthy and
    unhealthy jobs with seed-replicated curves and cost readouts."""
    rng = np.random.default_rng(seed)
    ms = [1, 2, 4, 8]
    result = {"name": f"art{seed}", "spec": {"epsilon": {"probe_m": 2,
                                                         "frac": 0.7}},
              "datasets": {}, "jobs": {}}
    for j in range(n_jobs):
        ds = f"d{j}"
        result["datasets"][ds] = {"characters": {
            "mean_feature_variance": float(10 ** rng.uniform(-2, 1)),
            "sparsity": float(rng.uniform(0, 0.95)),
            "diversity_ratio": float(rng.uniform(0.2, 1.0))}}
        curves = np.cumsum(-rng.random((len(ms), n_seeds, 10)) * 0.05,
                           axis=-1) + 1.0
        job = {"algorithm": "minibatch", "dataset": ds, "ms": ms,
               "iters": 100, "eval_every": 10, "n_seeds": n_seeds,
               "losses": curves[:, 0].tolist(),
               "losses_seeds": curves.tolist(),
               "measured_m_max": int(rng.choice(ms[:-1])),
               "predicted": {"predicted_m_max": int(rng.integers(1, 64))},
               "status": ["ok", "retried:1", "diverged", "ok", "failed",
                          "ok"][j % 6]}
        result["jobs"][f"minibatch/{ds}"] = job
    return result


def test_regression_and_confidence_match_reference():
    results = [_artifact(s) for s in range(4)]
    got_pts = TF.collect_character_points(results)
    ref_pts = JF.collect_character_points(results)
    assert got_pts == ref_pts and len(got_pts) == 4 * 4
    ref_model = JF.characters_regression(ref_pts)
    got_model = TF.characters_regression(got_pts)
    assert got_model.keys() == ref_model.keys()
    assert got_model["n_points"] == ref_model["n_points"]
    np.testing.assert_allclose(got_model["predicted_log2_mmax"],
                               ref_model["predicted_log2_mmax"], atol=1e-9)
    for k in ("r2", "residual_rmse"):
        assert got_model[k] == pytest.approx(ref_model[k], abs=1e-9)
    for block in ("coef", "feature_mean", "feature_std"):
        for name, v in ref_model[block].items():
            assert got_model[block][name] == pytest.approx(v, abs=1e-9)
    assert TF.characters_regression(got_pts[:4]) is None
    probes = [{"mean_feature_variance": 0.5, "sparsity": 0.3,
               "diversity_ratio": 0.8},
              {"mean_feature_variance": 1e4, "sparsity": 0.99,
               "diversity_ratio": 0.01}]
    for ch in probes:
        for model in (None, ref_model):
            ref = JF.analytic_confidence(model, ch)
            got = TF.analytic_confidence(model, ch)
            assert got.keys() == ref.keys()
            for k, v in ref.items():
                if isinstance(v, float):
                    assert got[k] == pytest.approx(v, abs=1e-9), k
                else:
                    assert got[k] == v, k
    assert TF.CONFIDENCE_PRIOR == JF.CONFIDENCE_PRIOR


def test_cost_law_fits_and_stats_match_reference():
    job = _artifact(11)["jobs"]["minibatch/d0"]
    ms, costs = [1, 2, 4, 8, 16], [100.0, 60.0, 45.0, 44.0, 52.0]
    ref, got = JF.fit_cost_curve(ms, costs), TF.fit_cost_curve(ms, costs)
    assert got["fitted_m_max"] == ref["fitted_m_max"]
    for k in ("A", "B", "C", "m_star", "r2"):
        assert got[k] == pytest.approx(ref[k], abs=1e-9), k
    for kw in ({}, {"asynchronous": True}):
        ref = JF.fit_job(job, probe_m=2, frac=0.7, n_boot=50, **kw)
        got = TF.fit_job(job, probe_m=2, frac=0.7, n_boot=50, **kw)
        for k, v in ref.items():
            if isinstance(v, float) and np.isfinite(v):
                assert got[k] == pytest.approx(v, abs=1e-9), k
            elif not isinstance(v, list):
                assert got[k] == v or (np.isnan(v) and np.isnan(got[k])), k
    assert TS.mmax_bootstrap(job, probe_m=2, frac=0.7, n_boot=50) == \
        JS.mmax_bootstrap(job, probe_m=2, frac=0.7, n_boot=50)
    got, ref = TS.curve_stats(job, n_boot=50), JS.curve_stats(job, n_boot=50)
    for k in ("mean", "std", "lo", "hi"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-9, err_msg=k)


# ---------------------------------------------------------------------------
# SlotDriver
# ---------------------------------------------------------------------------

def _counter_driver(n_slots):
    """Slot i counts up by its own increment until it reaches its target:
    any cross-slot leak shows at once."""
    init = {"x": torch.zeros(n_slots), "inc": torch.ones(n_slots),
            "target": torch.full((n_slots,), 1e9)}

    def step(state, active):
        new = dict(state, x=state["x"] + state["inc"])
        return new, new["x"] >= new["target"]

    return SlotDriver(step, init, n_slots)


def test_slot_driver_freezes_inactive_slots_and_recycles():
    drv = _counter_driver(3)
    assert drv.n_active == 0 and drv.step() == []
    assert drv.admit("a", {"x": 0.0, "inc": 2.0, "target": 6.0}) == 0
    frozen = drv.state["x"][1:].clone()
    drv.step()
    drv.step()
    assert list(drv.positions) == [2, 0, 0]
    assert list(drv.active) == [True, False, False]
    assert torch.equal(drv.state["x"][1:], frozen)
    (rid, out), = drv.step()
    assert rid == "a" and float(out["x"]) == 6.0 and drv.n_active == 0
    assert drv.admit("next", {"x": 0.0, "inc": 1.0, "target": 2.0}) == 0
    assert drv.admit("b", {"x": 0.0, "inc": 1.0, "target": 1.0}) == 1
    assert drv.admit("c", {"x": 0.0, "inc": 1.0, "target": 1.0}) == 2
    assert drv.admit("d", {"x": 0.0, "inc": 1.0, "target": 1.0}) is None
    outs = dict(drv.run_to_completion())
    assert float(outs["next"]["x"]) == 2.0 and set(outs) == {"next", "b",
                                                             "c"}


def test_slot_driver_neighbor_isolation():
    def run(with_neighbors):
        drv = _counter_driver(4)
        drv.admit("a", {"x": 1.0, "inc": 0.5, "target": 4.0})
        results, step_i = {}, 0
        while drv.n_active or step_i == 0:
            if with_neighbors and step_i == 1:
                drv.admit("b", {"x": 0.0, "inc": 3.0, "target": 3.0})
                drv.admit("c", {"x": -2.0, "inc": 1.0, "target": 0.0})
            for rid, out in drv.step():
                results[rid] = out["x"]
            step_i += 1
            assert step_i <= 50, "did not drain"
        return results

    alone, crowded = run(False), run(True)
    assert torch.equal(alone["a"], crowded["a"])
    assert float(crowded["b"]) == 3.0 and float(crowded["c"]) == 0.0


def test_slot_driver_validation_and_mask_tree():
    with pytest.raises(ValueError):
        SlotDriver(lambda s, a: (s, a), {"x": torch.zeros(3)}, n_slots=4)
    with pytest.raises(ValueError):
        SlotDriver(lambda s, a: (s, a), {"x": torch.zeros(1)}, n_slots=0)
    active = torch.tensor([True, False, True])
    new = {"a": torch.arange(3.0), "b": [torch.ones(3, 2)]}
    old = {"a": torch.full((3,), -1.0), "b": [torch.zeros(3, 2)]}
    out = mask_tree(active, new, old)
    assert out["a"].tolist() == [0.0, -1.0, 2.0]
    assert out["b"][0].tolist() == [[1, 1], [0, 0], [1, 1]]


def test_recycled_slot_holds_no_rows_of_an_earlier_probe():
    """A big probe, then a small one in the same slot: the slot's envelope
    beyond the small probe is all zeros (the K1 count reads no mask), and
    the small probe's characters equal a fresh batcher's."""
    big = RNG.normal(size=(40, 12)) + 3.0
    small = (RNG.random(size=(10, 3)) > 0.5) * RNG.normal(size=(10, 3))
    batcher = ProbeBatcher(n_slots=1, max_rows=48, max_cols=12,
                           device="cpu")
    batcher.measure([("big", big)])
    got = batcher.measure([("small", small)])["small"]
    X = batcher.driver.state["X"][0]
    assert torch.count_nonzero(X[10:]) == 0
    assert torch.count_nonzero(X[:, 3:]) == 0
    fresh = ProbeBatcher(n_slots=1, max_rows=48, max_cols=12,
                         device="cpu").measure([("small", small)])["small"]
    assert got == fresh
    assert got["omega"] == float((small != 0).sum(axis=1).max())
