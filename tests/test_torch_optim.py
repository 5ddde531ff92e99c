"""The port's SGD, momentum and AdamW against ``repro.optim`` on random
pytrees: 20 updates with fresh random gradients each, float32
parameters, every parameter and state leaf within 1e-6 relative (of the
leaf's largest magnitude: float32 rounding of the same formulas);
the state's types and count; the reference's quadratic-convergence
cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro_torch import optim as O
from repro_torch import tree as T

SHAPES = {"w": (6, 5), "b": (5,), "deep": {"k": (3, 4, 2), "s": ()},
          "layers": [(4, 4), (7,)]}
OPTS = {
    "sgd": (RO.sgd_init, RO.sgd_update, O.sgd_init, O.sgd_update,
            {"lr": 0.05, "weight_decay": 0.01}),
    "momentum": (RO.momentum_init, RO.momentum_update, O.momentum_init,
                 O.momentum_update, {"lr": 0.05, "beta": 0.9,
                                     "weight_decay": 0.01}),
    "adamw": (RO.adamw_init, RO.adamw_update, O.adamw_init, O.adamw_update,
              {"lr": 1e-2}),
}


def _tree(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v) for v in shapes]
    return rng.standard_normal(shapes).astype(np.float32)


def _close(got, want, rel=1e-6):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= rel * scale


@pytest.mark.parametrize("name", list(OPTS))
def test_updates_match_reference(name):
    r_init, r_upd, p_init, p_upd, kw = OPTS[name]
    rng = np.random.default_rng(len(name))
    params = _tree(rng, SHAPES)
    rp = jax.tree.map(jnp.asarray, params)
    pp = T.tree_map(torch.tensor, params)
    rs, ps = r_init(rp), p_init(pp)
    for _ in range(20):
        g = _tree(rng, SHAPES)
        rp, rs = r_upd(rp, jax.tree.map(jnp.asarray, g), rs, **kw)
        pp, ps = p_upd(pp, T.tree_map(torch.tensor, g), ps, **kw)
    for a, b in zip(jax.tree.leaves(rp), T.flatten(pp)[0]):
        _close(b.numpy(), a)
    for part in ("m", "v"):
        if part in rs:
            for a, b in zip(jax.tree.leaves(rs[part]),
                            T.flatten(ps[part])[0]):
                _close(b.numpy(), a)
    assert int(ps["count"]) == int(rs["count"]) == 20
    assert ps["count"].dtype == torch.int32


@pytest.mark.parametrize("name", list(OPTS))
def test_state_types_and_bf16_params(name):
    """float32 state and an int32 count whatever the parameters' type; a
    bfloat16 parameter stays bfloat16, equal to the reference's after one
    update (the same float32 value rounded once)."""
    r_init, r_upd, p_init, p_upd, kw = OPTS[name]
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    g = rng.standard_normal((4, 4)).astype(np.float32)
    pp = {"w": torch.tensor(w).to(torch.bfloat16)}
    rp = {"w": jnp.asarray(w).astype(jnp.bfloat16)}
    ps = p_init(pp)
    assert ps["count"].dtype == torch.int32 and int(ps["count"]) == 0
    for part in ("m", "v"):
        if part in ps:
            assert ps[part]["w"].dtype == torch.float32
    p2, s2 = p_upd(pp, {"w": torch.tensor(g).to(torch.bfloat16)}, ps, **kw)
    r2, _ = r_upd(rp, {"w": jnp.asarray(g).astype(jnp.bfloat16)},
                  r_init(rp), **kw)
    assert p2["w"].dtype == torch.bfloat16 and int(s2["count"]) == 1
    np.testing.assert_array_equal(p2["w"].float().numpy(),
                                  np.asarray(r2["w"], np.float32))
    assert torch.equal(pp["w"], torch.tensor(w).to(torch.bfloat16))


@pytest.mark.parametrize("init,update,kw", [
    (O.sgd_init, O.sgd_update, {"lr": 0.1}),
    (O.momentum_init, O.momentum_update, {"lr": 0.05}),
    (O.adamw_init, O.adamw_update, {"lr": 0.3, "weight_decay": 0.0}),
])
def test_optimizers_converge_quadratic(init, update, kw):
    """The reference's own case (tests/test_train.py)."""
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = init(params)
    for _ in range(200):
        g = {"w": 2.0 * (params["w"] - target)}
        params, state = update(params, g, state, **kw)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_tree_order_is_the_references():
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    want = [p for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    got = T.flatten_with_path(params)
    assert len(got) == len(want)
    for (path, leaf), a in zip(got, jax.tree.leaves(params)):
        assert leaf is a
    leaves, rebuild = T.flatten(params)
    again = rebuild(leaves)
    assert T.flatten_with_path(again) == got
