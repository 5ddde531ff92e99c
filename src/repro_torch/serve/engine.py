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

On a mesh (the reference's sharded prefill and decode) the parameters
come from :func:`shard_params` (``rules.param_specs``), the serve state
from :func:`shard_serve_state` (``rules.decode_state_specs``, ``enc_out``
included), and the steps take the reference's hooks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.device import (DEFAULT_DEVICE, resolve_device,
                                resolve_device_or_meta)
from repro_torch.distributed import local as DL
from repro_torch.distributed import rules as RU
from repro_torch.distributed.mesh import check_model_mesh
from repro_torch.models import model as M
from repro_torch.train.steps import _plain, mesh_context, replicas_of


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


def _mesh_of(params):
    w = params.embed["table"]
    return w.device_mesh if DL.is_dtensor(w) else None


def shard_params(params, mesh):
    """A ``CausalLM`` whose parameters are DTensor views of the
    reference's pytree laid out by ``rules.param_specs`` on ``mesh``
    (every rank passing the same global weights)."""
    check_model_mesh(mesh)
    tree = interop.lm_tree(params)
    placed = RU.place_tree(tree, RU.param_specs(tree, mesh), mesh)
    return interop.lm_params(params.cfg, placed,
                             T.flatten(tree)[0][0].device)


def place_batch(batch, mesh, *, shardable_batch=True):
    """A batch (global tensors, the same on every rank) laid out by
    ``rules.batch_specs``; DTensors pass through."""
    return RU.place_tree(batch, RU.batch_specs(
        batch, mesh, shardable_batch=shardable_batch), mesh)


def make_prefill_step(cfg: ArchConfig, attention_impl="kernel",
                      constrain=None):
    """prefill(params, batch) -> next-token logits (B, V) float32.  Only
    the last position is projected onto the vocabulary: the same numbers
    as the reference's ``forward(...)[:, -1, :]`` without the (B, S, V)
    logits.  With parameters from :func:`shard_params` the batch is laid
    out by ``batch_specs``, ``constrain`` (``rules.act_constraint``) pins
    the residual stream as in the reference, the step must run
    ``attention_impl="reference"``, and the logits come back whole."""
    def prefill(params, batch):
        mesh = _mesh_of(params)
        if mesh is not None:
            batch = place_batch(batch, mesh)
        with mesh_context(mesh):
            h, _ = M.forward_hidden(params, cfg, batch,
                                    attention_impl=attention_impl,
                                    constrain=constrain)
            logits = M.project_logits(params, cfg, h[:, -1:])[:, 0]
            return _plain(logits)
    return prefill


def decode_state_placements(state, mesh, *, shardable_batch=True):
    """A decode state (``init_decode_state``'s, per-layer caches) laid out
    by ``rules.decode_state_specs``: each cache tensor gets the spec of
    its stacked counterpart without the layer axis."""
    def place(cache):
        import dataclasses
        new = {}
        for f in dataclasses.fields(cache):
            x = getattr(cache, f.name)
            if isinstance(x, torch.Tensor):
                stacked = {f.name: torch.empty((1,) + tuple(x.shape),
                                               device="meta")}
                spec = RU.decode_state_specs(
                    stacked, mesh, shardable_batch=shardable_batch)[f.name]
                new[f.name] = RU.place(x, RU.P(*spec[1:]), mesh)
        return dataclasses.replace(cache, **new)
    return dict(state, caches=[place(c) for c in state["caches"]])


def shard_serve_state(state, mesh, *, shardable_batch=True):
    """A serve state laid out on ``mesh``: the decode caches by
    :func:`decode_state_placements`, ``enc_out`` with its batch over the
    data axes (when shardable), as the reference's dry run places it."""
    out = {"decode": decode_state_placements(
        state["decode"], mesh, shardable_batch=shardable_batch)}
    if "enc_out" in state:
        spec = RU.serve_state_specs(
            {"decode": {}, "enc_out": state["enc_out"]}, mesh,
            shardable_batch=shardable_batch)["enc_out"]
        out["enc_out"] = RU.place(state["enc_out"], RU.fit_spec(
            spec, state["enc_out"].shape, mesh), mesh)
    return out


def make_serve_step(cfg: ArchConfig, constrain=None):
    """serve_step: ONE new token against the KV caches of ``state`` (and
    its ``enc_out``, which passes through unchanged).  With parameters
    from :func:`shard_params` the state must come from
    :func:`shard_serve_state`; ``constrain`` (``rules.
    decode_act_constraint``) pins h between layers, as in the reference;
    the tokens are laid out by ``batch_specs`` and the next tokens come
    back whole."""
    def serve(params, state, tokens):
        mesh = _mesh_of(params)
        enc_out = state.get("enc_out")
        if mesh is not None:
            shardable = tokens.shape[0] % replicas_of(mesh) == 0
            tokens = place_batch({"tokens": tokens}, mesh,
                                 shardable_batch=shardable)["tokens"]
        with mesh_context(mesh):
            logits, new_state = M.decode_step(
                params, cfg, tokens, state["decode"], enc_out=enc_out,
                constrain=constrain)
            # the (B, V) logits gathered before the argmax (small)
            next_tok = torch.argmax(_plain(logits[:, -1, :]), dim=-1)
        out = {"decode": new_state}
        if enc_out is not None:
            out["enc_out"] = enc_out
        return next_tok, out
    return serve


def init_serve_state(cfg: ArchConfig, batch, max_len, dtype=None,
                     device=DEFAULT_DEVICE, with_encoder=False):
    """{"decode": the decode state} and, for an encoder-decoder or when
    ``with_encoder``, a zero ``enc_out`` (batch, encoder_seq, d_model).
    ``device="meta"`` builds the shapes only."""
    dev = resolve_device_or_meta(device)
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
