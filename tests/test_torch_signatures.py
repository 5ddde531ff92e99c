"""Every public signature of the port against the reference's.

For each public function or class that a ``repro`` module defines, its
counterpart of the same name in the ``repro_torch`` module of that path
takes every parameter of the reference's, by the same name and in the
same order among the reference's (the port may add parameters of its
own anywhere); a name that differs or is not defined there is in
``repro_torch.SIGNATURE_DIFFERENCES`` with its reason, and an entry that
no longer differs fails as stale.  Then the repairs that brought the
signatures together, each against the reference: ``causal_mask``'s
positional ``q_offset``, ``train_loop``'s ``lb_coef`` (2 sync steps of
reduced arctic-480b with the load-balance term off, losses within 1e-5
relative, through ``tests/_torch_train_parity.check_train_loop``),
``forward``'s ``remat``, ``loss_fn``'s ``attention_impl``,
``decode_step``'s ``vision_embeds``, ``encode``'s ``params`` and
``init_gossip_state``'s ``n_replicas``."""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import repro
import repro_torch
from _torch_train_parity import check_train_loop
from repro.models import attention as RA
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.train import steps as S

from _torch_threads import one_torch_thread  # noqa: F401

MODULES = sorted(
    name for name in ["repro"] + [m.name for m in pkgutil.walk_packages(
        repro.__path__, "repro.")]
    if name.partition(".")[2] not in repro_torch.NOT_PORTED)


def _rel(name):
    return name.partition(".")[2]


def _public(mod):
    """(name, object) of the functions and classes ``mod`` defines."""
    for name, obj in sorted(vars(mod).items()):
        if (not name.startswith("_")
                and (inspect.isfunction(obj) or inspect.isclass(obj))
                and obj.__module__ == mod.__name__):
            yield name, obj


def _params(obj):
    return list(inspect.signature(obj).parameters)


def _differences(module):
    """{"module.name": what differs} over ``module``'s public names."""
    ref = importlib.import_module(module)
    port = importlib.import_module("repro_torch" + module[len("repro"):])
    out = {}
    for name, obj in _public(ref):
        key = f"{_rel(module)}.{name}" if _rel(module) else name
        if not hasattr(port, name) or getattr(
                getattr(port, name), "__module__", None) != port.__name__:
            out[key] = "not defined in the port's module"
            continue
        want, got = _params(obj), _params(getattr(port, name))
        missing = [p for p in want if p not in got]
        order = [p for p in got if p in want]
        if missing or order != [p for p in want if p in order]:
            out[key] = f"reference {want}, port {got}"
    return out


@pytest.mark.parametrize("module", MODULES)
def test_signatures_match_or_have_a_reason(module):
    diffs = _differences(module)
    prefix = _rel(module) + "." if _rel(module) else ""
    listed = {k for k in repro_torch.SIGNATURE_DIFFERENCES
              if k.startswith(prefix)
              and k[len(prefix):].count(".") == 0}
    undocumented = {k: v for k, v in diffs.items() if k not in listed}
    assert not undocumented, undocumented
    stale = sorted(listed - set(diffs))
    assert not stale, f"entries that no longer differ: {stale}"


def test_every_difference_names_a_reference_function_with_a_reason():
    for key, why in repro_torch.SIGNATURE_DIFFERENCES.items():
        module, _, name = key.rpartition(".")
        ref = importlib.import_module("repro." + module)
        assert name in dict(_public(ref)), key
        assert isinstance(why, str) and len(why) > 40, key


@pytest.mark.parametrize("args", [(4, 8, 2), (4, 8, 2, 3), (5, 5), (3, 9),
                                  (6, 6, 0, 2), (2, 7, 5)])
def test_causal_mask_takes_the_reference_positional_order(args):
    """``causal_mask(4, 8, 2)`` is a query offset of 2 in both packages,
    not a window."""
    want = np.asarray(RA.causal_mask(*args))
    got = A.causal_mask(*args, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_train_loop_lb_coef_matches_reference():
    """``lb_coef=0.0`` drops the load-balance term from both packages'
    losses; with the port's default weight the arctic losses would
    differ from the reference's."""
    got = check_train_loop("arctic-480b", steps=2, lb_coef=0.0,
                           batch_size=2, seq_len=16, lr=2e-3)
    assert len(got) == 2


@pytest.fixture(scope="module")
def gemma():
    cfg = get_arch("gemma3-1b").reduced()
    gen = torch.Generator().manual_seed(0)
    lm = M.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    return cfg, lm, {"tokens": tokens, "labels": tokens}


def test_forward_remat_is_the_same_forward(gemma):
    cfg, lm, batch = gemma
    want, _ = M.forward(lm, cfg, batch, attention_impl="reference")
    got, _ = M.forward(lm, cfg, batch, remat=True,
                       attention_impl="reference")
    assert torch.equal(got, want)


def test_loss_fn_takes_the_reference_arithmetic_only(gemma):
    cfg, lm, batch = gemma
    want, _ = M.loss_fn(lm, cfg, batch)
    got, _ = M.loss_fn(lm, cfg, batch, attention_impl="reference")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="reference's arithmetic"):
        M.loss_fn(lm, cfg, batch, attention_impl="kernel")


def test_decode_step_accepts_vision_embeds_unused(gemma):
    cfg, lm, batch = gemma
    tok = batch["tokens"][:, :1]
    logits = []
    for vision in (None, torch.ones(2, 4, cfg.d_model)):
        state = M.init_decode_state(cfg, 2, 16, device="cpu")
        logits.append(M.decode_step(lm, cfg, tok, state,
                                    vision_embeds=vision)[0])
    assert torch.equal(logits[0], logits[1])


def test_encode_and_gossip_state_take_the_reference_names():
    cfg = get_arch("whisper-small").reduced()
    lm = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    frames = 0.1 * torch.randn(1, cfg.encoder_seq, cfg.d_model,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(M.encode(params=lm.encoder, cfg=cfg, frames=frames),
                       M.encode(lm.encoder, cfg, frames))
    gcfg = get_arch("gemma3-1b").reduced()
    state = S.init_gossip_state(gcfg, n_replicas=3, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    assert len(state["models"]) == 3
    assert all(x.shape[0] == 3 for x in T.flatten(state["params"])[0])
