"""Serving: the prefill step, the single-token decode step, the greedy
generate loop, and the batched request driver :class:`SlotDriver` (port
of ``repro/serve/engine.py``).

The prefill step runs every causal self-attention through K6 and every
RMSNorm through K5 (``attention_impl="kernel"``); decoding runs its
RMSNorms through K5.  Caches are updated in place (see
``models/attention.py``).  An encoder-decoder's serve state carries the
encoder output ``enc_out`` that every decode step cross-attends to.

:class:`SlotDriver` is continuous-batching-lite: fixed slots, per-slot
position and active flags, and one call of the step function over the
whole slot batch per step.  `repro_torch.service.batcher` runs the
advisor's probe batching on it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as M


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over dicts, lists and tuples of tensors
    (``rest`` are trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def mask_tree(active, new, old):
    """Per-slot select over a slot-batched tree: where ``active[i]``, take
    ``new``'s slot ``i``, else keep ``old``'s — the masking primitive
    behind the driver's isolation guarantee.  ``active`` is a
    ``(n_slots,)`` bool tensor; every leaf's leading axis is the slot
    axis."""
    def sel(n, o):
        a = active.reshape((active.shape[0],) + (1,) * (n.dim() - 1))
        return torch.where(a, n, o)
    return tree_map(sel, new, old)


def _default_writer(state, slot: int, payload):
    """Write a payload tree (one slot's worth, no slot axis) into slot
    ``slot`` of the slot-batched state, in place.  Leaves missing from
    the payload keep their current slot contents."""
    if isinstance(state, dict) and isinstance(payload, dict):
        for k, v in state.items():
            if k in payload:
                _default_writer(v, slot, payload[k])
        return state
    if isinstance(state, (list, tuple)):
        for v, p in zip(state, payload):
            _default_writer(v, slot, p)
        return state
    state[slot] = (payload if isinstance(payload, (int, float))
                   else torch.as_tensor(payload))
    return state


class SlotDriver:
    """Continuous-batching-lite request driver: ``n_slots`` fixed slots,
    per-slot active flags and positions, masked step application.

    ``step_fn(state, active) -> (new_state, done)`` computes one step for
    every slot at once (``state`` is a tree whose leaves all carry the
    slot axis first, on one device; ``active``/``done`` are
    ``(n_slots,)`` bool tensors).  The driver re-selects the OLD state
    wherever a slot is inactive (``torch.where``) and zeroes ``done``
    there, so an inactive slot's state is bit-frozen between requests and
    a request's output is a function of its own slot alone — neighbors
    joining, stepping or finishing cannot perturb it.  One call of
    ``step_fn`` per :meth:`step`, whatever the occupancy."""

    def __init__(self, step_fn: Callable, init_state, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} must be >= 1")
        leaves = _leaves(init_state)
        lead = {int(x.shape[0]) for x in leaves}
        if lead and lead != {n_slots}:
            raise ValueError(f"every state leaf needs leading slot axis "
                             f"{n_slots}, got {sorted(lead)}")
        self.n_slots = int(n_slots)
        self._device = leaves[0].device if leaves else torch.device("cpu")
        self._state = init_state
        self._active = np.zeros(self.n_slots, dtype=bool)
        self._positions = np.zeros(self.n_slots, dtype=np.int64)
        self._requests: List[Optional[Any]] = [None] * self.n_slots

        def wrapped(state, active):
            new_state, done = step_fn(state, active)
            return (mask_tree(active, new_state, state),
                    torch.logical_and(done, active))

        self._step = wrapped

    # -- bookkeeping views --------------------------------------------------
    @property
    def active(self) -> np.ndarray:
        return self._active.copy()

    @property
    def positions(self) -> np.ndarray:
        return self._positions.copy()

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def state(self):
        return self._state

    # -- admission ----------------------------------------------------------
    def admit(self, request_id, payload,
              writer: Optional[Callable] = None) -> Optional[int]:
        """Place a request into a free slot; returns the slot index, or
        None when every slot is busy (the caller queues or sheds — the
        driver never blocks).  ``writer(state, slot, payload)`` customizes
        how the payload lands in the state (default: per-leaf in-place
        write of the slot)."""
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            return None
        slot = int(free[0])
        self._state = (writer or _default_writer)(self._state, slot, payload)
        self._active[slot] = True
        self._positions[slot] = 0
        self._requests[slot] = request_id
        return slot

    # -- stepping -----------------------------------------------------------
    def step(self) -> List[Tuple[Any, Dict]]:
        """Advance every active slot one step (one call of the step
        function).  Returns ``[(request_id, slot_state_slice), ...]`` —
        host copies — for requests that finished this step; their slots
        are freed for recycling."""
        if not self._active.any():
            return []
        active = torch.as_tensor(self._active, device=self._device)
        self._state, done = self._step(self._state, active)
        done_slots = np.flatnonzero(done.cpu().numpy())
        self._positions[self._active] += 1
        if done_slots.size == 0:
            return []
        # one device-to-host copy per leaf for all finished slots
        idx = torch.as_tensor(done_slots, device=self._device)
        host = tree_map(lambda x: x[idx].to("cpu", copy=True), self._state)
        finished = []
        for j, slot in enumerate(done_slots):
            slot = int(slot)
            finished.append((self._requests[slot],
                             tree_map(lambda x, j=j: x[j], host)))
            self._active[slot] = False
            self._requests[slot] = None
        return finished

    def run_to_completion(self, max_steps: int = 10_000) -> List:
        """Step until every slot drains (admissions between steps are the
        caller's loop)."""
        outs: List = []
        for _ in range(max_steps):
            if not self._active.any():
                return outs
            outs.extend(self.step())
        raise RuntimeError(f"slots still active after {max_steps} steps")


def make_prefill_step(cfg: ArchConfig, attention_impl="kernel"):
    """prefill(params, batch) -> next-token logits (B, V) float32.  Only
    the last position is projected onto the vocabulary: the same numbers
    as the reference's ``forward(...)[:, -1, :]`` without the (B, S, V)
    logits."""
    def prefill(params, batch):
        h, _ = M.forward_hidden(params, cfg, batch,
                                attention_impl=attention_impl)
        return M.project_logits(params, cfg, h[:, -1:])[:, 0]
    return prefill


def make_serve_step(cfg: ArchConfig):
    """serve_step: ONE new token against the KV caches of ``state`` (and
    its ``enc_out``, which passes through unchanged)."""
    def serve(params, state, tokens):
        enc_out = state.get("enc_out")
        logits, new_state = M.decode_step(params, cfg, tokens,
                                          state["decode"], enc_out=enc_out)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        out = {"decode": new_state}
        if enc_out is not None:
            out["enc_out"] = enc_out
        return next_tok, out
    return serve


def init_serve_state(cfg: ArchConfig, batch, max_len, dtype=None,
                     device=DEFAULT_DEVICE, with_encoder=False):
    """{"decode": the decode state} and, for an encoder-decoder or when
    ``with_encoder``, a zero ``enc_out`` (batch, encoder_seq, d_model)."""
    dev = resolve_device(device)
    state = {"decode": M.init_decode_state(cfg, batch, max_len, dtype, dev)}
    if with_encoder or cfg.encoder_layers:
        state["enc_out"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model),
            dtype=dtype or getattr(torch, cfg.dtype), device=dev)
    return state


def greedy_generate(params, cfg: ArchConfig, prompt_tokens, steps,
                    max_len=None, device=DEFAULT_DEVICE, enc_out=None):
    """Feeds each prompt token through ``decode_step``, then decodes
    ``steps`` tokens greedily; returns them, (B, steps) int64.  Runs on
    ``device`` (the GPU by default), where ``params`` must lie; every
    step cross-attends to ``enc_out`` when it is given."""
    dev = resolve_device(device)
    weight = params.embed["table"]
    if weight.device.type != dev.type:
        raise ValueError(f"greedy_generate: params lie on {weight.device}, "
                         f"not on {dev}")
    prompt_tokens = torch.as_tensor(prompt_tokens, device=weight.device)
    B, S = prompt_tokens.shape
    max_len = max_len or (S + steps + 8)
    state = M.init_decode_state(cfg, B, max_len, weight.dtype,
                                weight.device)
    for t in range(S):
        logits, state = M.decode_step(params, cfg,
                                      prompt_tokens[:, t:t + 1], state,
                                      enc_out=enc_out)
    out = []
    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    for _ in range(steps):
        out.append(tok)
        logits, state = M.decode_step(params, cfg, tok, state,
                                      enc_out=enc_out)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
    return torch.cat(out, dim=1)
