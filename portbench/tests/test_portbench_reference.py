"""The benchmark's plain reference against the port's CPU path at the
reduced configurations, in float32: the loss, every gradient, one AdamW
step and one ECD-PSGD step at two replicas."""

import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pytest  # noqa: E402
import torch  # noqa: E402

from _portbench_tiny import ref_cfg  # noqa: E402
from portbench.harness import inputs  # noqa: E402
from portbench.reference import lm, steps  # noqa: E402
from portbench.reference import threefry as TF  # noqa: E402
from portbench.reference.trees import leaves, tmap  # noqa: E402

ARCHS = ("zamba2-1.2b", "phi3-mini-3.8b")
ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def setup(arch, B=2, S=32, seed=3):
    c, cfg = ref_cfg(arch)
    w = inputs.weights(cfg, seed, "cpu")
    pool = inputs.batches({"batch": B, "seq": S, "pool": 3}, cfg["vocab_size"],
                          seed, "cpu")
    return c, cfg, w, pool


def program_lm(c, w):
    from repro_torch import interop
    return interop.lm_params(c, tmap(torch.clone, w), "cpu")


def close(a, b, rel):
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) <= rel * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    from repro_torch.train import steps as S
    c, cfg, w, pool = setup(arch)
    tokens, labels = pool[0]
    state = S.init_train_state(c, "sync", params=program_lm(c, w),
                               device="cpu")
    step = S.make_train_step(c, strategy="sync", lr=1e-3)
    l_p, _, g_p = step.grads(state, {"tokens": tokens, "labels": labels})
    sink = steps.GradTree(w)
    l_r = steps.loss_and_grads(w, tokens, labels, cfg, lm.Arith(), sink)
    assert abs(float(l_p) - float(l_r)) <= 1e-6 * abs(float(l_r))
    gp, gr = dict(leaves(g_p)), dict(leaves(sink.tree))
    assert gp.keys() == gr.keys()
    for k in gr:
        assert close(gp[k], gr[k], 2e-5), k


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step(arch):
    from repro_torch.train import steps as S
    c, cfg, w, pool = setup(arch)
    state = S.init_train_state(c, "sync", params=program_lm(c, w),
                               device="cpu")
    step = S.make_train_step(c, strategy="sync", lr=1e-3)
    losses = []
    for tokens, labels in pool[:2]:
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
    ref = tmap(torch.clone, w)
    out = steps.run_sync(ref, pool[:2], cfg, {"lr": 1e-3, "adamw": ADAMW},
                         lm.Arith())
    assert max(abs(a - b) / b for a, b in zip(losses, out["loss"])) < 1e-6
    # Adam's normalised step turns float32 rounding in a gradient near
    # zero into a move of up to lr, so the weights agree element by
    # element but for a few in a thousand, and each leaf's change agrees
    # but for those few moves (a thousandth of a leaf of 256)
    start = dict(leaves(w))
    for (k, a), (_, b) in zip(leaves(state["params"]), leaves(ref)):
        d = (a - b).abs()
        assert int((d > 1e-6).sum()) <= max(2, d.numel() // 1000), k
        assert float(d.max()) <= 2 * 2e-3, k
        ca, cb = (a - start[k]).norm(), (b - start[k]).norm()
        assert abs(float(ca - cb)) <= 1e-3 * float(cb), k


@pytest.mark.parametrize("arch", ("zamba2-1.2b",))
def test_gossip_step(arch):
    from repro_torch.train import steps as S
    c, cfg, w, pool = setup(arch)
    state = S.init_gossip_state(c, 2, params=program_lm(c, w), device="cpu")
    step = S.make_gossip_step(c, replicas=2, lr=2e-3, compress_bits=8,
                              remat=True)
    losses = []
    for tokens, labels in pool[:1]:
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
    xs = tmap(lambda x: torch.stack([x, x]).clone(), w)
    ys = tmap(torch.clone, xs)
    out = steps.run_gossip(xs, ys, pool[:1], cfg,
                           {"replicas": 2, "bits": 8, "lr": 2e-3},
                           lm.Arith())
    assert max(abs(a - b) / b for a, b in zip(losses, out["loss"])) < 1e-6
    for (k, a), (_, b) in zip(leaves(state["params"]), leaves(xs)):
        assert close(a, b, 1e-5), k
    # a z within rounding of a quantisation boundary may round the other
    # way: y then differs by one step (2/t) * scale in that element
    for (k, a), (_, b) in zip(leaves(state["y"]), leaves(ys)):
        d = (a - b).abs()
        step = float(b.reshape(2, -1).abs().amax(1).max()) / 127
        assert int((d > 1e-3 * step).sum()) <= max(1, d.numel() // 10000), k
        assert float(d.max()) <= 1.01 * step, k


def test_threefry_against_the_port():
    """The reference's Threefry against the port's (the port's is held
    bit for bit to jax.random by its own tests)."""
    from repro_torch import random as R
    k = TF.fold_in(TF.fold_in(TF.key(17), 5), torch.arange(3))
    kp = R.fold_in(R.fold_in(R.PRNGKey(17, device="cpu"), 5),
                   torch.arange(3))
    assert torch.equal(k, kp)
    assert torch.equal(TF.split(k, 7), R.split(kp, 7))
    assert torch.equal(TF.uniform(TF.split(k, 7)[:, 2], 1000),
                       R.uniform(R.split(kp, 7)[:, 2], (1000,)))
