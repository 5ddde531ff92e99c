"""The port's MoE block (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) in float32: arctic-480b's reduced
config (4 experts, top 2, a dense residual MLP) with capacity drops
(capacity factor 1.25, S = 16) and dropless, the same with a shared
expert (a GQA config made by ``dataclasses.replace``), and equal router
logits, where ties decide the experts.  The aux scalars and expert
fractions within atol/rtol 1e-5; y within atol/rtol 1e-4 once divided by
its root mean square.  The reference's expert init scale, 1/sqrt(E), makes
y's RMS 200-300 here, where float32 carries about 3e-5 absolute: the
reference's own y lies 5.3e-4 from a float64 evaluation of the same
weights (the port's 8.3e-4), so no other order of summation holds 1e-4
absolute.  Also the reference's dispatch invariants and identical-token
property, the top-k tie order, and the expert-stack initialisation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import moe as RMoE
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE

TOL = dict(atol=1e-4, rtol=1e-4)
AUX_TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(variant):
    rcfg = ref_get_arch("arctic-480b").reduced()
    cfg = get_arch("arctic-480b").reduced()
    if variant == "shared":
        rcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_shared_experts=1, shared_d_ff=128)) for c in (rcfg,
                                                                     cfg))
    return rcfg, cfg


def _setup(variant, seed=0):
    rcfg, cfg = _cfgs(variant)
    rp = jax.tree.map(np.asarray, RMoE.init_moe(jax.random.PRNGKey(seed),
                                                rcfg, jnp.float32))
    if variant == "tie":        # equal router logits: every row ties
        rp["router"] = np.zeros_like(rp["router"])
    p = jax.tree.map(torch.tensor, rp)
    return rcfg, cfg, rp, p


def _close_y(got, want):
    """Within atol/rtol 1e-4 in units of ``want``'s root mean square."""
    want = np.asarray(want)
    rms = float(np.sqrt(np.mean(np.square(want, dtype=np.float64))))
    np.testing.assert_allclose(np.asarray(got) / rms, want / rms, **TOL)


def _compare(rcfg, cfg, rp, p, x, dropless):
    want, waux = RMoE.moe_forward(rp, rcfg, jnp.asarray(x),
                                  dropless=dropless)
    got, aux = MoE.moe_forward(p, cfg, torch.tensor(x), dropless=dropless)
    assert got.shape == x.shape
    _close_y(got, want)
    assert sorted(aux) == sorted(waux)
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(waux[k]),
                                   **AUX_TOL)
    return got, aux


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("variant", ["arctic", "shared", "tie"])
def test_moe_forward_matches_reference(variant, dropless):
    rcfg, cfg, rp, p = _setup(variant)
    x = np.random.default_rng(1).standard_normal((2, 16, cfg.d_model),
                                                 dtype=np.float32)
    _compare(rcfg, cfg, rp, p, x, dropless)


def test_capacity_drops_happen_and_match():
    """At capacity factor 1.25 and S = 16 each expert takes 10 slots a
    row; with every token tied onto experts 0 and 1, 6 of 16 tokens lose
    both, and their y is the dense residual alone, as in the reference."""
    rcfg, cfg, rp, p = _setup("tie")
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model),
                                                 dtype=np.float32)
    got, _ = _compare(rcfg, cfg, rp, p, x, dropless=False)
    free, _ = MoE.moe_forward(p, cfg, torch.tensor(x), dropless=True)
    dense = L.apply_mlp(p["dense_residual"], torch.tensor(x), "swiglu")
    np.testing.assert_allclose(got[:, 10:].numpy(), dense[:, 10:].numpy(),
                               atol=1e-6, rtol=1e-6)
    assert not np.allclose(free[:, 10:].numpy(), dense[:, 10:].numpy())
    _close_y(got[:, :10].numpy(), free[:, :10].numpy())


def test_top_k_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    vals, idx = MoE.top_k(torch.tensor(probs), 5)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_moe_dispatch_invariants():
    """The reference's test_moe_dispatch_invariants on the port: shapes,
    finite output, positive load-balance loss and entropy, and a dropless
    output that differs only where capacity dropped assignments."""
    _, cfg, _, p = _setup("shared")
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model), dtype=np.float32))
    y_drop, aux = MoE.moe_forward(p, cfg, x)
    y_free, _ = MoE.moe_forward(p, cfg, x, dropless=True)
    assert y_drop.shape == x.shape
    assert bool(torch.isfinite(y_drop).all())
    assert float(aux["load_balance_loss"]) > 0
    assert float(aux["dispatch_entropy"]) > 0
    np.testing.assert_allclose(float(aux["expert_fraction"].sum()), 1.0,
                               atol=1e-6)
    assert np.isfinite(float((y_free - y_drop).abs().max()))


def test_moe_identical_tokens_identical_outputs():
    """The reference's test: duplicate tokens route identically
    (dropless), so outputs match."""
    _, cfg, _, p = _setup("arctic")
    tok = torch.tensor(np.random.default_rng(5).standard_normal(
        (1, 1, cfg.d_model), dtype=np.float32))
    x = tok.repeat(2, 4, 1)
    y, _ = MoE.moe_forward(p, cfg, x, dropless=True)
    np.testing.assert_allclose(y.numpy(), y[0:1, 0:1].expand_as(y).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_init_moe_shapes_and_expert_draws():
    """Names, shapes and types as the reference's; each stacked expert
    drawn on its own, scaled by the reference's 1/sqrt(E)."""
    rcfg, cfg = ref_get_arch("arctic-480b"), get_arch("arctic-480b")
    shapes = jax.eval_shape(lambda: RMoE.init_moe(jax.random.PRNGKey(0),
                                                  rcfg, jnp.bfloat16))
    meta = MoE.init_moe(None, cfg, torch.bfloat16, "meta")
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {f"{k}/{j}" if isinstance(v, dict) else k: w
           for k, v in meta.items()
           for j, w in (v.items() if isinstance(v, dict) else [(None, v)])}
    assert sorted(got) == sorted(flat)
    for k, v in got.items():
        assert tuple(v.shape) == flat[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(flat[k].dtype), k
    small = get_arch("arctic-480b").reduced()
    gen = torch.Generator().manual_seed(7)
    p = MoE.init_moe(gen, small, torch.float32, "cpu")
    E, d, ff = p["wi_gate"].shape
    gen = torch.Generator().manual_seed(7)
    router = torch.randn((d, E), generator=gen) * (1.0 / d ** 0.5)
    first = torch.randn((d, ff), generator=gen) * (1.0 / E ** 0.5)
    np.testing.assert_array_equal(p["router"].numpy(), router.numpy())
    np.testing.assert_array_equal(p["wi_gate"][0].numpy(), first.numpy())


def test_dense_init_draws_unchanged():
    """Scaling in place leaves every unstacked draw as it was:
    ``(normal * scale).to(dtype)``, bit for bit, in float32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        got = L._dense_init(torch.Generator().manual_seed(3), (40, 24),
                            dtype, "cpu")
        w = torch.randn((40, 24), generator=torch.Generator().manual_seed(3))
        assert torch.equal(got, (w * (1.0 / 40 ** 0.5)).to(dtype))
