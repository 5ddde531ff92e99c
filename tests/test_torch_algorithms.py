"""The four algorithms' grids through the port's batched engine against
the reference engine, from identical datasets and draws: minibatch,
Hogwild! and DADM at 1e-5; ECD-PSGD inside the reference's own envelope
(1e-3 at 60 iterations, tests/test_core.py::
test_ecd_psgd_divergence_envelope) because its floor turns an ulp into a
whole quantum.  Inside the port, bucketed = flat = per-m."""

import jax
import numpy as np
import pytest
import torch

from repro.core import problems as JP
from repro.core.algorithms import base as JB
from repro.core.algorithms import ecd_psgd as JE
from repro.data import synth as JS
from repro.experiments import engine as JEng
from repro_torch import interop
from repro_torch import random as R
from repro_torch.core import problems as TP
from repro_torch.core.algorithms import base as TB
from repro_torch.core.algorithms import ecd_psgd as TE
from repro_torch.experiments import engine as TEng

from _torch_threads import one_torch_thread  # noqa: F401

MS = [1, 2, 4, 8]
CASES = {
    "minibatch": ("higgs_like", {"n": 400, "d": 12}, {}, 120, 1e-5),
    "hogwild": ("upper_bound", {"n": 400, "d": 40}, {"gamma": 0.05}, 120,
                1e-5),
    "dadm": ("realsim_like", {"n": 300, "d": 30, "density": 0.2}, {}, 120,
             1e-5),
    "ecd_psgd": ("higgs_like", {"n": 400, "d": 12}, {}, 60, 1e-3),
}


def _ref_split(gen, kw):
    key = jax.random.PRNGKey(0)
    return JS.get_generator(gen)(key, **kw).split(key=key)


def _port_split(tr, te):
    return interop.split((tr.X, tr.y), (te.X, te.y), device="cpu")


@pytest.mark.parametrize("alg", sorted(CASES))
def test_engine_matches_reference(alg):
    gen, kw, akw, iters, tol = CASES[alg]
    tr, te = _ref_split(gen, kw)
    ref = JEng.run_algorithm_sweep(alg, tr, te, MS, iters=iters,
                                   eval_every=iters // 10, **akw)
    got = TEng.sweep(alg, *_port_split(tr, te), MS,
                                   iters=iters, eval_every=iters // 10,
                                   **akw)
    assert {k: v for k, v in got.items() if k != "losses"} == \
        {k: v for k, v in ref.items() if k != "losses"}
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0,
                               atol=tol)


@pytest.mark.parametrize("alg", ["minibatch", "dadm"])
def test_seed_axis_matches_reference(alg):
    gen, kw, akw, _, tol = CASES[alg]
    tr, te = _ref_split(gen, kw)
    ref = JEng.run_algorithm_sweep(alg, tr, te, [1, 4], iters=40,
                                   eval_every=10, n_seeds=3, **akw)
    got = TEng.sweep(alg, *_port_split(tr, te), [1, 4],
                                   iters=40, eval_every=10, n_seeds=3,
                                   **akw)
    assert got["n_seeds"] == 3
    np.testing.assert_allclose(got["losses_seeds"], ref["losses_seeds"],
                               rtol=0, atol=tol)
    np.testing.assert_array_equal(got["losses"],
                                  np.asarray(got["losses_seeds"])[:, 0])


@pytest.mark.parametrize("alg", sorted(CASES))
def test_bucketed_flat_per_m_agree(alg):
    gen, kw, akw, iters, _ = CASES[alg]
    tr, te = _port_split(*_ref_split(gen, kw))
    run = lambda **mode: np.asarray(TEng.sweep(  # noqa: E731
        alg, tr, te, MS, iters=iters, eval_every=iters // 10, **akw,
        **mode)["losses"])
    bucketed, flat, per_m = (run(bucketed=True), run(bucketed=False),
                             run(per_m=True))
    np.testing.assert_allclose(bucketed, flat, rtol=0, atol=1e-6)
    np.testing.assert_allclose(flat, per_m, rtol=0, atol=1e-6)


@pytest.mark.parametrize("alg", sorted(CASES))
def test_interop_draws_equal_port_draws(alg):
    """The carry-across of the reference's make_draws equals the port's
    own draws, so either feeds the engine identical randomness."""
    _, _, akw, _, _ = CASES[alg]
    key = jax.random.PRNGKey(3)
    ref = JB.get_algorithm(alg)(**akw).make_draws(key, 500, 30, 12)
    carried = interop.draws(alg, jax.tree.map(np.asarray, ref), d=28,
                            device="cpu")
    own = TB.get_algorithm(alg)(**akw).make_draws(
        R.PRNGKey(3, device="cpu"), 500, 30, 12, 28)
    if isinstance(own, dict):
        assert set(own) == set(carried)
        for k in own:
            assert torch.equal(own[k], carried[k]), k
    else:
        assert torch.equal(own, carried)


def test_ring_matrix_matches_reference():
    m = torch.arange(1, 9)
    got = TE.ring_matrix(m, 8)
    for i, mi in enumerate(range(1, 9)):
        np.testing.assert_array_equal(np.asarray(JE.ring_matrix(mi, 8)),
                                      got[i].numpy())


@pytest.mark.parametrize("name", ["logistic", "ridge", "hinge"])
def test_problem_hooks_match_reference(name):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((50, 6)).astype(np.float32)
    y = np.sign(rng.standard_normal(50)).astype(np.float32)
    x = (rng.standard_normal(6) * 0.3).astype(np.float32)
    alpha = rng.random(50).astype(np.float32)
    jp, tp = JP.get_problem(name)(), TP.get_problem(name)()
    Xt, yt, xt = map(torch.tensor, (X, y, x))
    z = X @ x
    close = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp.test_loss(xt, Xt, yt).item(),
                               float(jp.test_loss(x, X, y)), **close)
    np.testing.assert_allclose(tp.train_loss(xt, Xt, yt).item(),
                               float(jp.train_loss(x, X, y)), **close)
    np.testing.assert_allclose(tp.batch_grad(xt, Xt, yt).numpy(),
                               np.asarray(jp.batch_grad(x, X, y)), **close)
    np.testing.assert_allclose(tp.point_grad(xt, Xt[3], yt[3]).numpy(),
                               np.asarray(jp.point_grad(x, X[3], y[3])),
                               **close)
    sq = (X * X).sum(1)
    step = tp.sdca_stepfactor(torch.tensor(sq), 50)
    np.testing.assert_allclose(step.numpy(),
                               np.asarray(jp.sdca_stepfactor(sq, 50)),
                               **close)
    np.testing.assert_allclose(
        tp.sdca_delta(torch.tensor(z), yt, torch.tensor(alpha), step).numpy(),
        np.asarray(jp.sdca_delta(z, y, alpha, np.asarray(step))), **close)
    k = torch.tensor([8.0, 32.0])
    np.testing.assert_allclose(tp.sdca_damping(k).numpy(),
                               [float(jp.sdca_damping(8.0)),
                                float(jp.sdca_damping(32.0))])
    assert tp.dual_init() == jp.dual_init()


@pytest.mark.parametrize("problem", ["ridge", "hinge"])
def test_other_objectives_through_engine(problem):
    tr, te = _ref_split("higgs_like", {"n": 300, "d": 8})
    kw = dict(iters=40, eval_every=10, problem=problem)
    for alg, akw in (("minibatch", {"gamma": 0.003}), ("dadm", {})):
        ref = JEng.run_algorithm_sweep(alg, tr, te, [1, 4], **kw, **akw)
        got = TEng.sweep(alg, *_port_split(tr, te), [1, 4],
                                       **kw, **akw)
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                                   atol=1e-5)
