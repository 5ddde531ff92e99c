"""The causal attention core whose row chunks read only the keys their
rows can see (``models/attention.py`` ``_causal_attention``), in float32
with small heads, against two things: today's mask form
(``gqa_attention`` under the full ``causal_mask``) and the reference's
``repro.models.attention.gqa_attention``.  Outputs and the gradients of
q, k and v agree within 1e-6 relative (the norm of the difference over
the norm), at four row chunks, a sliding window that splits a chunk
(1500), grouped heads (4 over 2), MLA's unequal widths (q and k 24, v
16), one chunk, and a length that is not a multiple of a chunk
(``Q_CHUNK`` + 512, one call as in the reference).  Unchunked, the
causal form is the mask form bit for bit.

Each chunk scores the keys between the first and the last that its rows
see in the mask: 10 of 16 of the scores at four chunks and no window;
unchunked, one call scores all of them.  A training step at 2
``Q_CHUNK`` still times one ``attn.core`` span per layer in each of
forward, recompute and backward, and reads Q and 2 Q keys in its two
chunks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.models import attention as RA
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as A
from repro_torch.telemetry import instrument
from repro_torch.train import steps as S

from _torch_threads import one_torch_thread  # noqa: F401

Q = A.Q_CHUNK
#: (B, S, H, KV, q and k width, v width, window)
CASES = {
    "four_chunks": (1, 4 * Q, 2, 2, 8, 8, 0),
    "window_1500": (1, 4 * Q, 2, 2, 8, 8, 1500),
    "gqa": (1, 2 * Q, 4, 2, 8, 8, 0),
    "mla_widths": (1, 2 * Q, 2, 2, 24, 16, 0),
    "one_chunk": (2, Q, 2, 2, 8, 8, 0),
    "unchunked": (1, Q + 512, 2, 2, 8, 8, 0),
}
TOL = 1e-6


def _chunked(case):
    S_ = CASES[case][1]
    return S_ > Q and S_ % Q == 0


def _inputs(case):
    B, S_, H, KV, D, Dv, _ = CASES[case]
    rng = np.random.default_rng(sum(CASES[case]))
    shapes = [(B, S_, H, D), (B, S_, KV, D), (B, S_, KV, Dv), (B, S_, H, Dv)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch(fn, q, k, v, g):
    """fn's output and the gradients of q, k and v under cotangent g."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(q, k, v)
    out.backward(torch.tensor(g))
    return [out.detach(), q.grad, k.grad, v.grad]


def _causal(case):
    window = CASES[case][-1]
    return lambda q, k, v: A._causal_attention(q, k, v, window)


def _mask_form(case):
    S_, window = CASES[case][1], CASES[case][-1]
    mask = A.causal_mask(S_, S_, window=window, device="cpu")[None, None]
    return lambda q, k, v: A.gqa_attention(q, k, v, mask)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("case", CASES)
def test_causal_core_matches_the_mask_form(case):
    arrays = _inputs(case)
    got = _torch(_causal(case), *arrays)
    want = _torch(_mask_form(case), *arrays)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        if _chunked(case):
            assert _rel(a, b) <= TOL, (name, _rel(a, b))
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("case", CASES)
def test_causal_core_matches_the_reference(case):
    q, k, v, g = _inputs(case)
    S_, window = CASES[case][1], CASES[case][-1]
    mask = RA.causal_mask(S_, S_, window=window)[None, None]

    def loss(q, k, v):
        return jnp.sum(RA.gqa_attention(q, k, v, mask) * g)
    out = jax.jit(lambda q, k, v: RA.gqa_attention(q, k, v, mask))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    want = [torch.tensor(np.asarray(x)) for x in (out, *grads)]
    got = _torch(_causal(case), q, k, v, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= TOL, (name, _rel(a, b))


def _visible_ranges(case):
    """Each chunk's keys ``(lo, hi)`` read from the mask: from the first
    key any of its rows sees to the last; one chunk of every key when the
    core does not chunk."""
    S_, window = CASES[case][1], CASES[case][-1]
    if not _chunked(case):
        return [(0, S_)]
    mask = A.causal_mask(S_, S_, window=window, device="cpu").numpy()
    ranges = []
    for r0 in range(0, S_, Q):
        cols = np.flatnonzero(mask[r0:r0 + Q].any(axis=0))
        ranges.append((int(cols[0]), int(cols[-1]) + 1))
    return ranges


def _keys_read(monkeypatch):
    """Patches the core's row blocks to log the keys each one scores."""
    read, rows = [], A._attn_rows

    def logged(q, k, v, mask, D):
        read.append(k.shape[1])
        return rows(q, k, v, mask, D)
    monkeypatch.setattr(A, "_attn_rows", logged)
    return read


@pytest.mark.parametrize("case", CASES)
def test_each_chunk_reads_the_keys_its_rows_see(case, monkeypatch):
    ranges = _visible_ranges(case)
    if _chunked(case):
        assert ranges == [A._visible_keys(r0, r0 + Q, CASES[case][-1])
                          for r0 in range(0, CASES[case][1], Q)]
    read = _keys_read(monkeypatch)
    q, k, v, _ = (torch.tensor(a) for a in _inputs(case))
    A._causal_attention(q, k, v, CASES[case][-1])
    assert read == [hi - lo for lo, hi in ranges]
    S_ = CASES[case][1]
    share = sum(read) * (S_ // len(read)) / S_ ** 2
    if case == "four_chunks":
        assert share == 10 / 16
    if not _chunked(case):
        assert share == 1


def test_a_step_at_two_chunks_keeps_one_core_span_per_layer_and_phase(
        monkeypatch):
    cfg = get_arch("phi3-mini-3.8b").reduced()
    state = S.init_train_state(cfg, "sync",
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (1, 2 * Q),
                        generator=torch.Generator().manual_seed(1))
    step = S.make_train_step(cfg, lr=1e-3, remat=True)
    read = _keys_read(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, {"tokens": tok, "labels": torch.roll(tok, -1, 1)})
    calls = instrument.span_totals()["calls"]
    for phase in ("forward", "recompute", "backward"):
        assert calls[("attn.core", phase)] == cfg.num_layers
    # forward and recompute: chunk 0 reads Q keys, chunk 1 2 Q, of 2 Q each
    assert read == [Q, 2 * Q] * (2 * cfg.num_layers)
