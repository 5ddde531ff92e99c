"""Device-timed spans of the port's training step (``telemetry.
instrument``), on a reduced phi3-mini-3.8b with per-layer recompute and
four cross-entropy chunks, timed by the host clock on the CPU.

Off (no tracer, no profiler) a span is the shared no-op and the step adds
no node to the autograd graph and computes what the bare functions
compute; under a profiler each step records a fixed count of spans per
phase, the phases split the step, and the results are bit-equal to the
untimed step's; under the port's tracer each exported span starts where
its ``record_function`` twin starts in the same profile; the benchmark's
five readers return the per-step totals; the stale strategy and
microbatches record their counts too, and the gossip step stays untimed."""

import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.models import model as M
from repro_torch.optim import adamw_update_
from repro_torch.telemetry import instrument, metrics, trace
from repro_torch.train import steps as S

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CFG = get_arch("phi3-mini-3.8b").reduced()
L = CFG.num_layers
B, SEQ, CHUNK = 2, 128, 32
LR = 1e-3
READERS = ("forward_ms_per_step.train", "recompute_ms_per_step.train",
           "backward_ms_per_step.train", "optimizer_ms_per_step.train",
           "attention_ms_per_step.train")


@pytest.fixture(autouse=True)
def four_ce_chunks(monkeypatch):
    monkeypatch.setattr(M, "CE_CHUNK_BYTES", B * CHUNK * CFG.vocab_size * 4)


@pytest.fixture
def registry(monkeypatch):
    """A fresh process registry for the test."""
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    return reg


def _state(strategy="sync"):
    return S.init_train_state(CFG, strategy,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")


def _batches(n):
    g = torch.Generator().manual_seed(1)
    out = []
    for _ in range(n):
        tok = torch.randint(0, CFG.vocab_size, (B, SEQ), generator=g)
        out.append({"tokens": tok, "labels": torch.roll(tok, -1, 1)})
    return out


def _run(step, state, batches):
    ms = []
    for b in batches:
        state, m = step(state, b)
        ms.append(m)
    return state, ms


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _assert_bit_equal(a, b):
    (sa, ma), (sb, mb) = a, b
    for x, y in zip(T.flatten([sa["params"], sa["opt"]])[0],
                    T.flatten([sb["params"], sb["opt"]])[0]):
        assert torch.equal(x, y)
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) for k in x)


def _graph_names(fn):
    seen, todo, names = set(), [fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def _chunks(rows):
    return SEQ // M._ce_chunk_size(rows, SEQ, CFG.vocab_size)


def _per_step(mb=1, accum="explicit"):
    """{(span, phase): calls} of one step."""
    passes = 1 if accum == "in-loss" else mb
    ce = mb * _chunks(B // mb)
    return {("train.step", "step"): 1, ("train.forward", "forward"): passes,
            ("train.backward", "backward"): passes,
            ("train.optimizer", "optimizer"): 1,
            ("model.block", "forward"): L * mb,
            ("model.block", "recompute"): L * mb,
            ("attn.core", "forward"): L * mb,
            ("attn.core", "recompute"): L * mb,
            ("attn.core", "backward"): L * mb,
            ("model.ce", "forward"): ce, ("model.ce", "recompute"): ce}


def test_off_spans_are_the_shared_noop_and_the_step_is_todays(
        registry, monkeypatch):
    assert instrument.span("model.block") is trace._NOOP
    assert instrument.step("train.step", "cpu") is trace._NOOP
    assert not instrument.live()
    (batch,) = _batches(1)
    state = _state()
    l, _ = M.loss_fn(state["model"], CFG, batch, remat=True)
    assert not any("_Core" in n for n in _graph_names(l.grad_fn))
    with profile(activities=[ProfilerActivity.CPU]):
        with instrument.step("train.step", "cpu"):
            live, _ = M.loss_fn(state["model"], CFG, batch, remat=True)
    names = _graph_names(live.grad_fn)
    assert {"_CoreEndBackward", "_CoreStartBackward"} <= names
    assert torch.equal(l, live)

    # the step against the bare functions it calls
    registry = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "REGISTRY", registry)
    got = S.make_train_step(CFG, lr=LR, remat=True)(_state(), batch)
    ref = _state()
    lm = ref["model"]
    loss, aux = M.loss_fn(lm, CFG, batch, remat=True)
    names, params = zip(*lm.named_parameters())
    grads = interop.lm_tree(lm, dict(zip(names, torch.autograd.grad(
        loss, params))))
    opt = adamw_update_(ref["params"], grads, ref["opt"], lr=LR)
    want = (dict(ref, opt=opt),
            [{"loss": loss.detach(), "ce_loss": aux["ce_loss"].detach(),
              "grad_norm": S._global_norm(grads)}])
    _assert_bit_equal((got[0], [got[1]]), want)
    assert registry.series(instrument.SECONDS) == []
    assert registry.series(instrument.STEPS) == []
    assert not instrument._PENDING


@pytest.fixture(scope="module")
def two_profiled_steps():
    """Two untimed steps, then the same two steps from the same state
    under a CPU profiler, into a registry of their own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "CE_CHUNK_BYTES", B * CHUNK * CFG.vocab_size * 4)
        step = S.make_train_step(CFG, lr=LR, remat=True)
        batches = _batches(2)
        off = _run(step, _state(), batches)
        reg = metrics.MetricsRegistry()
        mp.setattr(metrics, "REGISTRY", reg)
        on, _ = _profiled(lambda: _run(step, _state(), batches))
        totals = instrument.span_totals()
    return off, on, reg, totals


def test_profiled_steps_count_split_and_match(two_profiled_steps):
    off, on, _, t = two_profiled_steps
    _assert_bit_equal(off, on)
    assert t["steps"] == 2
    assert t["calls"] == {k: 2 * n for k, n in _per_step().items()}
    s = t["seconds"]
    recompute = s[("model.block", "recompute")] + s[("model.ce", "recompute")]
    phases = [s[("train.forward", "forward")], recompute,
              s[("train.backward", "backward")] - recompute,
              s[("train.optimizer", "optimizer")]]
    assert all(p > 0 for p in phases)
    # the rest of the step is its gradient norm and bookkeeping: 2.5 % of
    # this small step on the host, 0.4 % of phi3-mini's on the card
    split = sum(phases)
    assert 0.95 * s[("train.step", "step")] <= split \
        <= s[("train.step", "step")]


def test_the_five_readers_return_the_per_step_totals(two_profiled_steps,
                                                     monkeypatch):
    from portbench.harness import cells
    _, _, reg, t = two_profiled_steps
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    s = {k: 1e3 * v / 2 for k, v in t["seconds"].items()}
    recompute = s[("model.block", "recompute")] + s[("model.ce", "recompute")]
    want = [s[("train.forward", "forward")], recompute,
            s[("train.backward", "backward")] - recompute,
            s[("train.optimizer", "optimizer")],
            sum(v for (name, _), v in s.items() if name == "attn.core")]
    got = [cells.reader(name)(None) for name in READERS]
    assert got == pytest.approx(want, rel=1e-12)
    monkeypatch.setattr(metrics, "REGISTRY", metrics.MetricsRegistry())
    assert [cells.reader(name)(None) for name in READERS] == [None] * 5


def test_tracer_spans_sit_on_the_profilers_clock(registry):
    step = S.make_train_step(CFG, lr=LR, remat=True)
    tracer = trace.start()
    try:
        _, prof = _profiled(lambda: _run(step, _state(), _batches(1)))
    finally:
        trace.stop()
    payload = tracer.payload()
    assert payload["otherData"]["clock"] == trace.CLOCK
    evs = payload["traceEvents"]
    base_us = payload["otherData"]["base_epoch_ns"] / 1e3
    twins = {}
    for e in prof.profiler.kineto_results.events():
        twins.setdefault(e.name(), []).append(e.start_ns() / 1e3)
    assert len(evs) == sum(_per_step().values())
    for e in evs:
        assert e["args"]["device_ms"] == pytest.approx(e["dur"] / 1e3,
                                                       rel=0.5, abs=1.0)
        assert len(twins[e["name"]]) == sum(
            x["name"] == e["name"] for x in evs)
        assert min(abs(e["ts"] + base_us - t)
                   for t in twins[e["name"]]) < 1e3
    # the step's phases follow each other inside it
    top = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in evs
           if e["name"].startswith("train.")}
    order = ["train.forward", "train.backward", "train.optimizer"]
    lo, hi = top["train.step"]
    assert lo <= top[order[0]][0] and top[order[-1]][1] <= hi
    for a, b in zip(order, order[1:]):
        assert top[a][1] <= top[b][0]


@pytest.mark.parametrize("strategy,mb,accum", [
    ("stale", 1, "explicit"), ("sync", 2, "explicit"),
    ("stale", 2, "in-loss")])
def test_strategies_and_microbatches_record_their_counts(
        strategy, mb, accum, registry):
    step = S.make_train_step(CFG, strategy=strategy, lr=LR, remat=True,
                             microbatches=mb, accum_mode=accum)
    _profiled(lambda: _run(step, _state(strategy), _batches(1)))
    t = instrument.span_totals()
    assert t["steps"] == 1
    assert t["calls"] == _per_step(mb, accum)


def test_gossip_step_stays_untimed_under_a_profiler(registry):
    reps = 2

    def run():
        state = S.init_gossip_state(
            CFG, reps, generator=torch.Generator().manual_seed(0),
            device="cpu")
        step = S.make_gossip_step(CFG, replicas=reps, lr=LR)
        return _run(step, state, _batches(2))
    off = run()
    on, _ = _profiled(run)
    for x, y in zip(T.flatten([off[0]["params"], off[0]["y"]])[0],
                    T.flatten([on[0]["params"], on[0]["y"]])[0]):
        assert torch.equal(x, y)
    assert all(torch.equal(a["loss"], b["loss"])
               for a, b in zip(off[1], on[1]))
    assert instrument.span_totals()["calls"] == {}
    assert registry.series(instrument.STEPS) == []
