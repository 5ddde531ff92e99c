"""Serving: the prefill step, the single-token decode step and the greedy
generate loop (the port of ``repro/serve/engine.py``'s model path).

The prefill step runs every attention through K6 and every RMSNorm
through K5 (``attention_impl="kernel"``); decoding runs its RMSNorms
through K5.  Caches are updated in place (see ``models/attention.py``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as M


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
    """serve_step: ONE new token against the KV caches of ``state``."""
    def serve(params, state, tokens):
        logits, new_state = M.decode_step(params, cfg, tokens,
                                          state["decode"])
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
        return next_tok, {"decode": new_state}
    return serve


def init_serve_state(cfg: ArchConfig, batch, max_len, dtype=None,
                     device=DEFAULT_DEVICE):
    return {"decode": M.init_decode_state(cfg, batch, max_len, dtype,
                                          device)}


def greedy_generate(params, cfg: ArchConfig, prompt_tokens, steps,
                    max_len=None, device=DEFAULT_DEVICE):
    """Feeds each prompt token through ``decode_step``, then decodes
    ``steps`` tokens greedily; returns them, (B, steps) int64.  Runs on
    ``device`` (the GPU by default), where ``params`` must lie."""
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
                                      prompt_tokens[:, t:t + 1], state)
    out = []
    tok = torch.argmax(logits[:, -1:, :], dim=-1)
    for _ in range(steps):
        out.append(tok)
        logits, state = M.decode_step(params, cfg, tok, state)
        tok = torch.argmax(logits[:, -1:, :], dim=-1)
    return torch.cat(out, dim=1)
