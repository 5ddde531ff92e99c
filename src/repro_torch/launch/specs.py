"""Meta-device stand-ins for every model input and state (the port of
``repro/launch/specs.py``): the dry run's contract.  Every function
returns tensors on the ``meta`` device with the reference's shapes and
types, in the reference's tree layout (a dataclass's fields as dict
keys), so that ``distributed.rules`` lays them out leaf for leaf as the
reference's rules lay out its ``jax.eval_shape`` trees.  Nothing is
allocated."""

from __future__ import annotations

import torch

from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import model as M

META = torch.device("meta")


def _sd(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: InputShape):
    """Inputs for train/prefill.  Modality front ends are the stated stub:
    audio provides frame embeddings, VLM provides patch embeddings."""
    B, S = shape.global_batch, shape.seq_len
    dtype = getattr(torch, cfg.dtype)
    batch = {"tokens": _sd((B, S), torch.int32)}
    if shape.mode == "train":
        batch["labels"] = _sd((B, S), torch.int32)
    if cfg.vision_tokens:
        batch["vision_embeds"] = _sd((B, cfg.vision_tokens, cfg.d_model),
                                     dtype)
        batch["positions"] = _sd((3, B, S), torch.int32)    # M-RoPE t/h/w
    if cfg.encoder_layers:
        batch["frames"] = _sd((B, cfg.encoder_seq, cfg.d_model), dtype)
    return batch


def param_shapes(cfg: ArchConfig):
    """The reference's parameter pytree (segments stacked)."""
    return interop.lm_tree(M.init_params(cfg, device=META))


def train_state_shapes(cfg: ArchConfig, strategy="sync"):
    params = param_shapes(cfg)

    def like(dtype=None):
        return T.tree_map(lambda x: _sd(x.shape, dtype or x.dtype), params)

    state = {"params": params,
             "opt": {"m": like(torch.float32), "v": like(torch.float32),
                     "count": _sd((), torch.int32)},
             "step": _sd((), torch.int32)}
    if strategy == "stale":
        state["prev_grads"] = like()
    return state


def _cache_tree(cache, n):
    """One layer's cache (the port's dataclass) -> the reference's
    stacked leaves for ``n`` layers, as a dict of its fields."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(cache):
        x = getattr(cache, f.name)
        if isinstance(x, torch.Tensor):
            dtype = torch.int32 if f.name == "pos" else x.dtype
            out[f.name] = _sd((n,) + tuple(x.shape), dtype)
        elif f.name == "index":
            out[f.name] = _sd((n,), torch.int32)
    return out


def decode_state_shapes(cfg: ArchConfig, shape: InputShape):
    """{"caches": one stacked dict per segment, "position": int32 ()}."""
    dtype = getattr(torch, cfg.dtype)
    state = M.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                dtype, META)
    caches, first = [], 0
    for _, n in M.segments(cfg):
        caches.append(_cache_tree(state["caches"][first], n))
        first += n
    return {"caches": caches, "position": _sd((), torch.int32)}


def serve_state_shapes(cfg: ArchConfig, shape: InputShape):
    state = {"decode": decode_state_shapes(cfg, shape)}
    if cfg.encoder_layers:
        state["enc_out"] = _sd((shape.global_batch, cfg.encoder_seq,
                                cfg.d_model), getattr(torch, cfg.dtype))
    return state


def decode_token_specs(cfg: ArchConfig, shape: InputShape):
    return _sd((shape.global_batch, 1), torch.int32)
