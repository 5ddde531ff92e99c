"""The causal LM of the dense attention families (the port of
``repro/models/model.py``, blocks of kind ``attn`` without MoE or
cross-attention).

The reference stacks each run of identical layers and scans over it; the
port keeps one module per layer: :class:`CausalLM` holds ``embed``, a
``ModuleList`` ``blocks`` in layer-plan order and ``final_norm`` (plus
``lm_head`` when embeddings are not tied).  The reference's public
functions are thin functions over it:

  init_params(cfg, generator, device)           -> CausalLM
  forward(params, cfg, batch, ...)              -> (logits, aux) (prefill)
  init_decode_state(cfg, batch, max_len, ...)   -> per-layer caches
  decode_step(params, cfg, tokens, state)       -> (logits, new state)

``attention_impl="kernel"`` (the default, the reference's ``"pallas"``)
sends every attention through K6 and every RMSNorm through K5: kernels on
a CUDA tensor, their plain versions on a CPU tensor.
``attention_impl="reference"`` runs the reference model's own arithmetic
with no kernel: :func:`attention.gqa_attention` and the plain RMSNorm.
Decoding always normalises through K5; its one-token attention is plain
torch, as in the reference.  MoE, MLA, SSM, shared-attention, encoder,
vision and M-RoPE models raise NotImplementedError (ROADMAP A14), and so
does training (``grad_cast``, ``chunked_ce``, ``loss_fn``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (_dense_init, apply_mlp, apply_norm,
                                       init_embedding, init_mlp, init_norm)


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str        # attn | mla | mamba2 | mlstm | slstm | shared_attn
    moe: bool = False
    window: int = 0           # sliding window for attn (0 = full)
    cross: bool = False       # whisper decoder: add cross-attention


def layer_plan(cfg: ArchConfig) -> List[LayerSpec]:
    specs = []
    for i in range(cfg.num_layers):
        kind = cfg.block_kind(i)
        if kind == "attn" and cfg.attention == "mla":
            kind = "mla"
        window = 0
        if (kind == "attn" and cfg.sliding_window
                and not cfg.is_global_attn_layer(i)):
            window = cfg.sliding_window
        specs.append(LayerSpec(
            kind=kind,
            moe=cfg.is_moe_layer(i) if kind in ("attn", "mla") else False,
            window=window,
            cross=cfg.cross_attention and kind == "attn",
        ))
    return specs


def segments(cfg: ArchConfig) -> List[Tuple[LayerSpec, int]]:
    """Run-length encoding of the layer plan."""
    out: List[Tuple[LayerSpec, int]] = []
    for s in layer_plan(cfg):
        if out and out[-1][0] == s:
            out[-1] = (s, out[-1][1] + 1)
        else:
            out.append((s, 1))
    return out


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    missing = []
    for spec in layer_plan(cfg):
        if spec.kind != "attn":
            missing.append(f"{spec.kind} blocks")
        if spec.moe:
            missing.append("MoE")
        if spec.cross:
            missing.append("cross-attention")
    if cfg.encoder_layers:
        missing.append("the audio encoder")
    if cfg.vision_tokens:
        missing.append("vision inputs")
    if cfg.rope_kind != "standard":
        missing.append("M-RoPE")
    if cfg.rope_theta == 0.0:
        missing.append("learned positions")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(sorted(set(missing)))} not ported yet "
            f"(ROADMAP A14)")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _pdict(tensors) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class AttnBlock(nn.Module):
    """Pre-norm block: attention, then the MLP, each added to the stream."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, gen, dtype, device):
        super().__init__()
        self.spec = spec
        self.norm1 = _pdict(init_norm(cfg.norm, cfg.d_model, dtype, device))
        self.attn = _pdict(attn.init_gqa(gen, cfg, dtype, device))
        self.norm2 = _pdict(init_norm(cfg.norm, cfg.d_model, dtype, device))
        self.mlp = _pdict(init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                                   dtype, device))


class CausalLM(nn.Module):
    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        check_supported(cfg)
        dtype = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = _pdict(init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                           dtype, device))
        self.final_norm = _pdict(init_norm(cfg.norm, cfg.d_model, dtype,
                                           device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                            device), requires_grad=False)
        self.blocks = nn.ModuleList(
            AttnBlock(cfg, spec, gen, dtype, device)
            for spec in layer_plan(cfg))


def init_params(cfg: ArchConfig, generator=None,
                device=DEFAULT_DEVICE) -> CausalLM:
    """Random weights drawn from ``generator`` (default: a generator on
    ``device`` seeded with 0).  ``device="meta"`` builds the shapes only
    (for parameter counts)."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
    return CausalLM(cfg, generator, dev)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _apply_block(p: AttnBlock, cfg: ArchConfig, h, *, positions,
                 attention_impl="kernel"):
    """Full-sequence (prefill) block application."""
    use_kernel = attention_impl == "kernel"
    x = apply_norm(cfg.norm, p.norm1, h, use_kernel)
    h = h + attn.gqa_forward(p.attn, cfg, x, positions,
                             window=p.spec.window,
                             attention_impl=attention_impl)
    x2 = apply_norm(cfg.norm, p.norm2, h, use_kernel)
    return h + apply_mlp(p.mlp, x2, cfg.mlp_kind)


def _embed_inputs(params: CausalLM, cfg: ArchConfig, batch):
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = F.embedding(tokens, params.embed["table"])
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return h, positions


def forward_hidden(params: CausalLM, cfg: ArchConfig, batch, *,
                   attention_impl="kernel"):
    """Prefill trunk.  Returns (final-norm hidden states, aux)."""
    h, positions = _embed_inputs(params, cfg, batch)
    for block in params.blocks:
        h = _apply_block(block, cfg, h, positions=positions,
                         attention_impl=attention_impl)
    h = apply_norm(cfg.norm, params.final_norm, h,
                   attention_impl == "kernel")
    aux = {"load_balance_loss": torch.zeros((), dtype=torch.float32,
                                            device=h.device)}
    return h, aux


def project_logits(params: CausalLM, cfg: ArchConfig, h):
    if cfg.tie_embeddings:
        logits = h @ params.embed["table"].t()
    else:
        logits = h @ params.lm_head
    return logits.to(torch.float32)


def forward(params: CausalLM, cfg: ArchConfig, batch, *,
            attention_impl="kernel"):
    """Prefill forward returning full logits.  Returns (logits, aux)."""
    h, aux = forward_hidden(params, cfg, batch,
                            attention_impl=attention_impl)
    return project_logits(params, cfg, h), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch, max_len, dtype=None,
                      device=DEFAULT_DEVICE):
    """One KV cache per layer (a ring of ``window`` slots on a sliding
    window layer) and the next absolute position."""
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    caches = [attn.init_kv_cache(cfg, batch, max_len, dtype,
                                 window=spec.window, device=dev)
              for spec in layer_plan(cfg)]
    return {"caches": caches, "position": 0}


def decode_step(params: CausalLM, cfg: ArchConfig, tokens, state):
    """tokens: (B, 1) -> (logits (B, 1, V) float32, new state).  The caches
    of ``state`` are updated in place; the new state holds them."""
    h = F.embedding(tokens, params.embed["table"])
    position = state["position"]
    for block, cache in zip(params.blocks, state["caches"]):
        x = apply_norm(cfg.norm, block.norm1, h)
        y, _ = attn.gqa_decode(block.attn, cfg, x, cache, position)
        h = h + y
        x2 = apply_norm(cfg.norm, block.norm2, h)
        h = h + apply_mlp(block.mlp, x2, cfg.mlp_kind)
    h = apply_norm(cfg.norm, params.final_norm, h)
    return project_logits(params, cfg, h), {"caches": state["caches"],
                                            "position": position + 1}
