"""The port's §IV characters against the reference's (repro.core.metrics),
from the same datasets: summarize at 1e-6 relative with diversity exact,
and the fused characters against their oracles."""

import jax
import numpy as np
import pytest
import torch

from repro.core import metrics as JM
from repro.data import synth as JS
from repro_torch import interop
from repro_torch.core import metrics as TM

from _torch_threads import one_torch_thread  # noqa: F401

_EXACT = ("n", "d", "diversity", "diversity_ratio")


def _datasets():
    key = jax.random.PRNGKey(0)
    return {
        "ub": JS.make_upper_bound_dataset(key, n=512, d=400, density=0.7),
        "dense": JS.make_higgs_like(key, n=512, d=28),
        "sparse": JS.make_realsim_like(key, n=512, d=300, density=0.05),
    }


@pytest.fixture(scope="module")
def datasets():
    return {k: (np.asarray(v.X), np.asarray(v.y))
            for k, v in _datasets().items()}


@pytest.mark.parametrize("name", ["ub", "dense", "sparse"])
def test_summarize_matches_reference(datasets, name):
    X, y = datasets[name]
    ref = JM.summarize(X)
    got = TM.summarize(interop.dataset(X, y, device="cpu").X)
    assert set(ref) == set(got)
    for k, v in ref.items():
        if k in _EXACT:
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-6, abs=0.0), k


def test_characters_with_duplicates_and_tol(datasets):
    X, _ = datasets["sparse"]
    X = np.concatenate([X[:100], X[:100], X[200:300]])
    Xt = torch.tensor(X)
    assert TM.diversity(Xt) == JM.diversity(X) == 200
    for tol in (0.0, 0.5):
        assert TM.sparsity(Xt, tol) == JM.sparsity(X, tol)
        assert TM.csim(Xt, 5, tol) == JM.csim(X, 5, tol)
        assert TM.ls_sync(Xt, 4, tol) == pytest.approx(
            JM.ls_sync(X, 4, tol), rel=1e-6)


def test_fused_characters_match_oracles(datasets):
    X, _ = datasets["ub"]
    Xt = torch.tensor(X[:96])
    assert TM.csim(Xt, 8) == TM.csim_ref(Xt, 8)
    assert TM.ls_sync(Xt, 8) == pytest.approx(TM.ls_sync_ref(Xt, 8),
                                              rel=1e-6)
    assert TM.batch_internal_similarity(Xt[:8]) == pytest.approx(
        TM.batch_internal_similarity_ref(Xt[:8]), rel=1e-6)
    assert TM.batch_internal_similarity_ref(Xt[:8]) == pytest.approx(
        JM.batch_internal_similarity_ref(X[:8]), rel=1e-6)


def test_ls_auto_follows_registry(datasets):
    X, _ = datasets["dense"]
    Xt = torch.tensor(X)
    assert TM.ls_auto(Xt, "hogwild") == TM.ls_async(Xt, 8)
    assert TM.ls_auto(Xt, "minibatch") == TM.ls_sync(Xt, 8)
    assert TM.ls_auto(Xt, "dadm", window=4) == pytest.approx(
        JM.ls_auto(X, "dadm", window=4), rel=1e-6)


@pytest.mark.parametrize("name", ["ub", "dense", "sparse"])
def test_predictors_match_oracles_and_reference(datasets, name):
    """The vectorized m_max predictors (analysis/fit.py:114-159) equal the
    scalar loops of core.scalability and the reference's predictions."""
    from repro.analysis import fit as JF
    from repro_torch.analysis import fit as TF
    from repro_torch.core import scalability as TSC
    X, _ = datasets[name]
    Xt = torch.tensor(X)
    for kind in ("hogwild", "sync", "dadm"):
        fn = f"predict_{kind}_mmax"
        got = getattr(TF, fn)(Xt)
        assert got["predicted_m_max"] == \
            getattr(TSC, fn)(Xt)["predicted_m_max"]
        ref = getattr(JF, fn)(X)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k] == pytest.approx(v, rel=1e-6), (kind, k)
