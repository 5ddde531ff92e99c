"""The causal LM of every family of the registry (the port of
``repro/models/model.py``): dense attention, MoE attention (arctic, and
deepseek-v2's MLA with shared experts and a dense first layer), SSM
(xLSTM's mLSTM and sLSTM), hybrid (zamba2: Mamba2 with a shared
attention block), the vision-language backbone (qwen2-vl: precomputed
patch embeddings and M-RoPE) and the audio encoder-decoder (whisper:
learned positions, an encoder over precomputed frame embeddings, and
cross-attention in every decoder layer).

The reference stacks each run of identical layers and scans over it; the
port keeps one module per layer: :class:`CausalLM` holds ``embed``, a
``ModuleList`` ``blocks`` in layer-plan order, ``final_norm``, ``lm_head``
when embeddings are not tied, ``shared_attn`` when a layer of the plan is
a shared-attention layer, ``pos_embed`` for learned positions and
``encoder`` (a :class:`WhisperEncoder`) for an encoder-decoder.  A
:class:`Block` holds the reference's per-layer subtree: ``norm1`` plus
``attn``, ``norm2`` and ``mlp`` or ``moe`` (attention or MLA; and
``cross`` with ``norm_cross`` in a decoder layer with cross-attention),
``block`` (mamba2, mlstm, slstm) or ``down`` (shared attention).  The
reference's public functions are thin functions over it:

  init_params(cfg, generator, device)           -> CausalLM
  forward(params, cfg, batch, ...)              -> (logits, aux) (prefill)
  loss_fn(params, cfg, batch, ...)              -> (loss, aux) (training)
  encode(params.encoder, cfg, frames)           -> encoder output
  init_decode_state(cfg, batch, max_len, ...)   -> per-layer caches
  decode_step(params, cfg, tokens, state, enc_out=None)
                                                -> (logits, new state)

A batch holds ``tokens`` and, as the reference's, may hold
``vision_embeds`` (they replace the first token embeddings),
``positions`` ((3, B, S) temporal, height and width ids under M-RoPE;
(p, p, p) when absent) and ``frames`` (the encoder's input, in the
model's type).

``attention_impl="kernel"`` (the default, the reference's ``"pallas"``)
sends every GQA attention through K6 and every RMSNorm, the SSM blocks'
gated norm included, through K5: kernels on a CUDA tensor, their plain
versions on a CPU tensor.  ``attention_impl="reference"`` runs the
reference model's own arithmetic with no kernel: :func:`attention.
gqa_attention` and the plain RMSNorm.  MLA attention, the
encoder's bidirectional self-attention and cross-attention are
:func:`attention.gqa_attention` under both values, as in the reference.
Decoding always normalises through K5; its one-token attention is plain
torch, as in the reference.
Training (:func:`loss_fn`) always takes the reference's arithmetic, as the
reference's train steps do: the kernels have no backward.

On a mesh the parameters are DTensors laid out by
``distributed.rules.param_specs`` and the inputs DTensors laid out by
``batch_specs``; the ``constrain*`` hooks (``distributed.rules``' factories)
redistribute activations and parameters exactly where the reference pins
them, and everything runs the reference's arithmetic: a mesh with
``attention_impl="kernel"`` raises, and decoding normalises without K5.
The ops DTensor does not propagate run shard by shard through
:mod:`repro_torch.distributed.local`: the token lookup, full-sequence
attention (heads or q's rows over 'model'), the SSM blocks and their
decode steps (weights gathered, batch-sharded), MoE dispatch (experts on
'model') and every cache write.  Parameters are
built with ``requires_grad=False``; a trainer turns it on.
"""

from __future__ import annotations

import dataclasses
import types
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device_or_meta
from repro_torch.distributed import local as DL
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (_dense_init, apply_mlp, apply_norm,
                                       init_embedding, init_learned_positions,
                                       init_mlp, init_norm)
from repro_torch.models.moe import init_moe, moe_forward


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


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _pdict(tree) -> nn.ParameterDict:
    """A (nested) dict of tensors -> ``nn.ParameterDict``s of the same
    keys; parameters do not require gradients."""
    return nn.ParameterDict({
        k: _pdict(v) if isinstance(v, dict)
        else nn.Parameter(v, requires_grad=False) for k, v in tree.items()})


SSM_INIT = {"mamba2": ssm_mod.init_mamba2, "mlstm": ssm_mod.init_mlstm,
            "slstm": ssm_mod.init_slstm}
SSM_FORWARD = {"mamba2": ssm_mod.mamba2_forward,
               "mlstm": ssm_mod.mlstm_forward,
               "slstm": ssm_mod.slstm_forward}
SSM_STEP = {"mamba2": ssm_mod.mamba2_step, "mlstm": ssm_mod.mlstm_step,
            "slstm": ssm_mod.slstm_step}


class Block(nn.Module):
    """One layer of the plan, the reference's per-layer subtree:
    ``norm1``, then by kind ``attn``, ``norm2`` and ``mlp`` or ``moe``
    (attention or MLA; ``cross`` and ``norm_cross`` as well when the
    layer cross-attends), ``block`` (an SSM block) or ``down`` (a
    shared-attention layer, whose attention weights are the model's
    ``shared_attn``).
    ``parts`` names them."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, gen, dtype, device):
        super().__init__()
        self.spec = spec
        self.norm1 = _pdict(init_norm(cfg.norm, cfg.d_model, dtype, device))
        if spec.kind in ("attn", "mla"):
            init_attn = attn.init_mla if spec.kind == "mla" else attn.init_gqa
            self.attn = _pdict(init_attn(gen, cfg, dtype, device))
            self.norm2 = _pdict(init_norm(cfg.norm, cfg.d_model, dtype,
                                          device))
            if spec.moe:
                self.moe = _pdict(init_moe(gen, cfg, dtype, device))
            else:
                self.mlp = _pdict(init_mlp(gen, cfg.d_model, cfg.d_ff,
                                           cfg.mlp_kind, dtype, device))
            self.parts = ("norm1", "attn", "norm2",
                          "moe" if spec.moe else "mlp")
            if spec.cross:
                self.cross = _pdict(attn.init_cross_attn(gen, cfg, dtype,
                                                         device))
                self.norm_cross = _pdict(init_norm(cfg.norm, cfg.d_model,
                                                   dtype, device))
                self.parts += ("cross", "norm_cross")
        elif spec.kind in SSM_INIT:
            self.block = _pdict(SSM_INIT[spec.kind](gen, cfg, dtype, device))
            self.parts = ("norm1", "block")
        elif spec.kind == "shared_attn":
            self.down = nn.Parameter(
                _dense_init(gen, (cfg.d_model, cfg.d_model), dtype, device),
                requires_grad=False)
            self.parts = ("norm1", "down")
        else:
            raise ValueError(spec.kind)


def init_shared_attn(gen, cfg: ArchConfig, dtype, device):
    """zamba2's shared block: concat(h, h0) -> proj -> attn -> mlp."""
    return {
        "w_concat": _dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype,
                                device),
        "attn": attn.init_gqa(gen, cfg, dtype, device),
        "norm2": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype,
                        device),
    }


class WhisperEncoder(nn.Module):
    """whisper's encoder: learned positions ``pos`` over ``encoder_seq``
    frames, ``layers`` (a ``ModuleList`` of attention blocks: ``norm1``,
    ``attn``, ``norm2``, ``mlp``) and ``final_norm``."""

    def __init__(self, cfg: ArchConfig, gen, dtype, device):
        super().__init__()
        self.pos = _pdict(init_learned_positions(gen, cfg.encoder_seq,
                                                 cfg.d_model, dtype, device))
        self.layers = nn.ModuleList(
            Block(cfg, LayerSpec(kind="attn"), gen, dtype, device)
            for _ in range(cfg.encoder_layers))
        self.final_norm = _pdict(init_norm(cfg.norm, cfg.d_model, dtype,
                                           device))


class CausalLM(nn.Module):
    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
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
        if cfg.rope_theta == 0.0:           # learned absolute positions
            self.pos_embed = _pdict(init_learned_positions(
                gen, cfg.max_seq_len, cfg.d_model, dtype, device))
        if cfg.encoder_layers:
            self.encoder = WhisperEncoder(cfg, gen, dtype, device)
        plan = layer_plan(cfg)
        if any(spec.kind == "shared_attn" for spec in plan):
            self.shared_attn = _pdict(init_shared_attn(gen, cfg, dtype,
                                                       device))
        self.blocks = nn.ModuleList(
            Block(cfg, spec, gen, dtype, device) for spec in plan)


def init_params(cfg: ArchConfig, generator=None,
                device=DEFAULT_DEVICE) -> CausalLM:
    """Random weights drawn from ``generator`` (default: a generator on
    ``device`` seeded with 0).  ``device="meta"`` builds the shapes only
    (for parameter counts)."""
    dev = resolve_device_or_meta(device)
    if dev.type != "meta" and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return CausalLM(cfg, generator, dev)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _no_hint(x, kind="attn"):
    return x


def _ssm_forward(kind, w, cfg, x, use_kernel):
    """An SSM block's forward; on a mesh its chunk loops run shard by
    shard (weights gathered, batch over the data axes)."""
    fwd = SSM_FORWARD[kind]
    if DL.is_dtensor(x):
        return DL.replicated(
            lambda w_, x_: fwd(w_, cfg, x_, use_kernel=False), w, x,
            mesh=x.device_mesh)
    return fwd(w, cfg, x, use_kernel=use_kernel)


def _apply_block(p: Block, cfg: ArchConfig, h, *, positions, h0=None,
                 shared=None, enc_out=None, attention_impl="kernel",
                 constrain_inner=None):
    """Full-sequence (train / prefill) block application.  Returns
    (h, aux); ``h0`` is the embedding output and ``shared`` the model's
    ``shared_attn``, both read by a shared-attention layer; ``enc_out``
    is the encoder's output, read by a cross-attending layer.
    ``constrain_inner(x, kind)`` pins the block's inputs (kinds ``attn``
    and ``mlp``) and outputs (``residual``), as the reference's does."""
    use_kernel = attention_impl == "kernel"
    ci = constrain_inner or _no_hint

    def res(y):
        return ci(y, kind="residual")

    kind = p.spec.kind
    aux = {}
    x = ci(apply_norm(cfg.norm, p.norm1, h, use_kernel), kind="attn")
    if kind in ("attn", "mla"):
        if kind == "mla":
            h = h + res(attn.mla_forward(p.attn, cfg, x, positions))
        else:
            h = h + res(attn.gqa_forward(p.attn, cfg, x, positions,
                                         window=p.spec.window,
                                         attention_impl=attention_impl))
            if p.spec.cross and enc_out is not None:
                xc = apply_norm(cfg.norm, p.norm_cross, h, use_kernel)
                h = h + res(attn.cross_attn_forward(p.cross, cfg, xc,
                                                    enc_out))
        x2 = ci(apply_norm(cfg.norm, p.norm2, h, use_kernel), kind="mlp")
        if p.spec.moe:
            y2, aux = moe_forward(p.moe, cfg, x2)
        else:
            y2 = apply_mlp(p.mlp, x2, cfg.mlp_kind)
        h = h + res(y2)
    elif kind in SSM_FORWARD:
        h = h + res(_ssm_forward(kind, p.block, cfg, x, use_kernel))
    elif kind == "shared_attn":
        z = DL.matmul(torch.cat([x, h0], dim=-1), shared["w_concat"])
        z = z + attn.gqa_forward(shared["attn"], cfg, z, positions,
                                 attention_impl=attention_impl)
        z2 = apply_norm(cfg.norm, shared["norm2"], z, use_kernel)
        z = z + apply_mlp(shared["mlp"], z2, cfg.mlp_kind)
        h = h + res(DL.matmul(z, p.down))
    return h, aux


def _embed_inputs(params: CausalLM, cfg: ArchConfig, batch):
    """Returns (h, positions).  ``vision_embeds`` (B, V, d) replace the
    first V token embeddings; learned positions are added with ids
    clipped to the table, as the reference clips them."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = DL.embedding(tokens, params.embed["table"])
    if cfg.vision_tokens and "vision_embeds" in batch:
        vision = batch["vision_embeds"]
        h = torch.cat([vision.to(h.dtype), h[:, vision.shape[1]:]], dim=1)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if cfg.rope_kind == "mrope":
            positions = positions[None].expand(3, B, S)    # text-only M-RoPE
    if cfg.rope_theta == 0.0:
        table = params.pos_embed["pos"]
        ids = torch.arange(S, device=tokens.device).clamp(
            max=table.shape[0] - 1)
        h = h + F.embedding(ids, table)[None]
    return h, positions


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype)


def grad_cast(tree):
    """Identity whose cotangent is cast to the primal's type, over a
    tensor or a (nested) dict or ``ParameterDict`` of tensors: the
    reference applies it to each layer's parameters so that
    mixed-precision internals never hand a float32 weight gradient to the
    reduction."""
    if isinstance(tree, torch.Tensor):
        return _GradCast.apply(tree)
    return {k: grad_cast(v) for k, v in tree.items()}


def _cast_block(block: Block, constrain_layer=None):
    """The block's parts as a namespace, each through :func:`grad_cast`
    and then ``constrain_layer`` (over ``{part: subtree}``) when given."""
    parts = {part: grad_cast(getattr(block, part)) for part in block.parts}
    if constrain_layer is not None:
        parts = constrain_layer(parts)
    return types.SimpleNamespace(spec=block.spec, **parts)


def _check_impl(x, attention_impl):
    if DL.is_dtensor(x) and attention_impl == "kernel":
        raise ValueError("a mesh runs the reference's arithmetic: pass "
                         "attention_impl='reference'")


def _encoder_layer(p: Block, cfg: ArchConfig, h):
    """One encoder layer: bidirectional plain attention (no mask, no
    kernel, as in the reference), then the MLP."""
    x = apply_norm(cfg.norm, p.norm1, h)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = DL.split_heads(DL.matmul(x, p.attn["wq"]), B, S, cfg.num_heads, hd)
    k = DL.split_heads(DL.matmul(x, p.attn["wk"]), B, S, cfg.num_kv_heads,
                       hd)
    v = DL.split_heads(DL.matmul(x, p.attn["wv"]), B, S, cfg.num_kv_heads,
                       hd)
    y = attn.gqa_attention(q, k, v, mask=None)
    h = h + DL.matmul(DL.merge_heads(y, B, S, -1), p.attn["wo"])
    x2 = apply_norm(cfg.norm, p.norm2, h)
    return h + apply_mlp(p.mlp, x2, cfg.mlp_kind)


def encode(params: WhisperEncoder, cfg: ArchConfig, frames, remat=False):
    """``params`` is the model's encoder (``CausalLM.encoder``); frames:
    (B, encoder_seq, d), the stubbed conv front end's output in the
    model's type -> the encoder's final-norm output.  ``remat=True``
    recomputes each layer in the backward pass."""
    h = frames + params.pos["pos"][None, :frames.shape[1]]
    for layer in params.layers:
        if remat:
            h = checkpoint(_encoder_layer, layer, cfg, h, use_reentrant=False)
        else:
            h = _encoder_layer(layer, cfg, h)
    return apply_norm(cfg.norm, params.final_norm, h)


def _segment_ends(cfg: ArchConfig):
    """Indices of the last block of each segment of the layer plan."""
    ends, i = set(), -1
    for _, n in segments(cfg):
        i += n
        ends.add(i)
    return ends


def forward_hidden(params: CausalLM, cfg: ArchConfig, batch, *,
                   remat=False, attention_impl="kernel", constrain=None,
                   constrain_layer=None, constrain_inner=None):
    """Train / prefill trunk.  Returns (final-norm hidden states, aux):
    ``aux["load_balance_loss"]`` sums the MoE layers' (0 without MoE).
    An encoder-decoder encodes ``batch["frames"]`` when the batch has
    them, and its decoder layers cross-attend to the result.

    When a backward pass can follow (gradients enabled, a parameter that
    requires them) each layer's parameters pass through :func:`grad_cast`;
    ``remat=True`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``), so only layer inputs are kept.

    The mesh hooks, as in the reference: ``constrain(h)`` pins the
    residual stream after the embedding and after each segment,
    ``constrain_layer`` each layer's parameters, ``constrain_inner``
    each block's inputs and outputs."""
    constrain = constrain or (lambda x: x)
    h, positions = _embed_inputs(params, cfg, batch)
    _check_impl(h, attention_impl)
    h = constrain(h)
    h0 = h
    enc_out = None
    if cfg.encoder_layers and "frames" in batch:
        enc_out = encode(params.encoder, cfg, batch["frames"], remat=remat)
    shared = getattr(params, "shared_attn", None)
    training = torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    ends = _segment_ends(cfg)
    for i, block in enumerate(params.blocks):
        p = (_cast_block(block, constrain_layer)
             if training or constrain_layer is not None else block)
        kw = dict(positions=positions, h0=h0, shared=shared,
                  enc_out=enc_out, attention_impl=attention_impl,
                  constrain_inner=constrain_inner)
        if remat:
            h, aux = checkpoint(_apply_block, p, cfg, h, use_reentrant=False,
                                **kw)
        else:
            h, aux = _apply_block(p, cfg, h, **kw)
        if "load_balance_loss" in aux:
            lb = lb + aux["load_balance_loss"]
        if i in ends:
            h = constrain(h)
    h = apply_norm(cfg.norm, params.final_norm, h,
                   attention_impl == "kernel")
    return h, {"load_balance_loss": lb}


def project_logits(params: CausalLM, cfg: ArchConfig, h):
    if cfg.tie_embeddings:
        logits = DL.matmul(h, params.embed["table"].t())
    else:
        logits = DL.matmul(h, params.lm_head)
    return logits.to(torch.float32)


def forward(params: CausalLM, cfg: ArchConfig, batch, *, remat=False,
            attention_impl="kernel", constrain=None):
    """Prefill forward returning full logits.  Returns (logits, aux);
    ``remat`` as in :func:`forward_hidden`; ``constrain`` pins the
    residual stream and the logits."""
    constrain = constrain or (lambda x: x)
    h, aux = forward_hidden(params, cfg, batch, remat=remat,
                            attention_impl=attention_impl,
                            constrain=constrain)
    return constrain(project_logits(params, cfg, h)), aux


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

# float32 logits one chunk of chunked_ce may hold on one device
CE_CHUNK_BYTES = 128 * 2 ** 20


def _ce_chunk_size(B, S, vocab, devices=1):
    """The largest divisor of S whose (B, chunk, vocab) float32 logits fit
    in ``CE_CHUNK_BYTES`` on each of ``devices`` devices (at least 1)."""
    target = max(1, min(S, CE_CHUNK_BYTES * devices
                        // max(B * vocab * 4, 1)))
    return next(c for c in range(target, 0, -1) if S % c == 0)


def _chunk_loss(h_c, lab_c, w, tied, constrain=None):
    logits = DL.matmul(h_c, w.t() if tied else w).to(torch.float32)
    if constrain is not None:
        logits = constrain(logits)
    if DL.is_dtensor(logits):
        # vocab-parallel log-softmax: a max and a sum over the vocabulary
        # reduce across its shards instead of gathering the logits
        m = torch.amax(logits, dim=-1, keepdim=True).detach()
        logp = logits - (m + torch.log(torch.sum(torch.exp(logits - m),
                                                 dim=-1, keepdim=True)))
    else:
        logp = torch.log_softmax(logits, dim=-1)
    # the label pick as a mask-sum over the vocabulary, as the reference
    # picks it (it keeps a vocabulary-sharded pick local to each shard)
    onehot = (torch.arange(logits.shape[-1], device=logits.device)
              == torch.clamp_min(lab_c, 0)[..., None])
    if DL.is_dtensor(logp):         # sliced to the vocabulary shards
        onehot = onehot.redistribute(logp.device_mesh, logp.placements)
    ll = torch.sum(torch.where(onehot, logp, torch.zeros_like(logp)), dim=-1)
    mask = (lab_c >= 0).to(torch.float32)
    return torch.sum(ll * mask), torch.sum(mask)


def chunked_ce(params: CausalLM, cfg: ArchConfig, h, labels, *, chunk=0,
               constrain=None, constrain_head=None):
    """Mean next-token cross-entropy without materialising (B, S, V)
    logits: the sequence goes in chunks, and each chunk's logits are
    recomputed in the backward pass (``torch.utils.checkpoint``), so the
    live logits are (B, chunk, V).  ``chunk=0`` picks the largest divisor
    of S within ``CE_CHUNK_BYTES``; a chunk that does not divide S means
    one chunk.  Labels below 0 are masked out.  On a mesh the budget is
    per device, as the reference's; ``constrain`` pins each chunk's
    logits and ``constrain_head`` the head weight, once, before the
    chunks."""
    B, S, _ = h.shape
    if DL.is_dtensor(h):
        # the sequence gathered over 'model' once, so the head's product
        # stays vocabulary-parallel (the reference's logits pin)
        h = h.redistribute(h.device_mesh, DL.batch_placements(
            h.device_mesh, h.shape, 0))
    if chunk <= 0:
        devices = h.device_mesh.size() if DL.is_dtensor(h) else 1
        chunk = _ce_chunk_size(B, S, cfg.vocab_size, devices)
    if S % chunk:
        chunk = S
    tied = cfg.tie_embeddings
    w = params.embed["table"] if tied else params.lm_head
    if constrain_head is not None:
        w = constrain_head(w)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        s, n = checkpoint(_chunk_loss, h[:, i:i + chunk],
                          labels[:, i:i + chunk], w, tied, constrain,
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return -tot / torch.clamp_min(cnt, 1.0)


def loss_fn(params: CausalLM, cfg: ArchConfig, batch, *, remat=False,
            attention_impl="reference", lb_coef=0.01, constrain=None,
            ce_chunk=0, constrain_layer=None, constrain_logits=None,
            constrain_inner=None, constrain_head=None):
    """Next-token cross-entropy (+ MoE load-balance aux, zero for the
    dense families): ``(total, {"ce_loss", "load_balance_loss"})``.
    Always the reference's arithmetic: ``attention_impl`` takes
    ``"reference"`` only, since the kernels have no backward pass (the
    reference cannot differentiate through its Pallas kernels either);
    ``constrain*`` are the mesh hooks of :func:`forward_hidden` and
    :func:`chunked_ce`."""
    if attention_impl != "reference":
        raise ValueError(f"attention_impl {attention_impl!r}: training "
                         f"takes the reference's arithmetic")
    h, aux = forward_hidden(params, cfg, batch, remat=remat,
                            attention_impl="reference", constrain=constrain,
                            constrain_layer=constrain_layer,
                            constrain_inner=constrain_inner)
    loss = chunked_ce(params, cfg, h, batch["labels"], chunk=ce_chunk,
                      constrain=constrain_logits,
                      constrain_head=constrain_head)
    total = loss + lb_coef * aux["load_balance_loss"]
    return total, {"ce_loss": loss, **aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _init_block_cache(cfg: ArchConfig, spec: LayerSpec, batch, max_len,
                      dtype, device):
    if spec.kind == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, dtype,
                                  window=spec.window, device=device)
    if spec.kind == "shared_attn":
        return attn.init_kv_cache(cfg, batch, max_len, dtype, device=device)
    if spec.kind == "mla":
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device)
    if spec.kind == "mamba2":
        return ssm_mod.init_mamba2_state(cfg, batch, dtype, device)
    if spec.kind == "mlstm":
        return ssm_mod.init_mlstm_state(cfg, batch, dtype, device)
    if spec.kind == "slstm":
        return ssm_mod.init_slstm_state(cfg, batch, dtype, device)
    raise ValueError(spec.kind)


def init_decode_state(cfg: ArchConfig, batch, max_len, dtype=None,
                      device=DEFAULT_DEVICE):
    """One cache per layer: a KV cache for an attention layer (a ring of
    ``window`` slots on a sliding-window layer; a shared-attention layer
    has its own, although its weights are shared), the compressed latent
    and rope key for an MLA layer, a constant-size state
    for an SSM layer; and the next absolute position.  ``device="meta"``
    builds the shapes only."""
    dev = resolve_device_or_meta(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    caches = [_init_block_cache(cfg, spec, batch, max_len, dtype, dev)
              for spec in layer_plan(cfg)]
    return {"caches": caches, "position": 0}


def _decode_block(p: Block, cfg: ArchConfig, h, cache, *, position, h0,
                  shared, enc_out=None):
    """One-token decode through a block.  Returns (h, new cache).  On a
    mesh (DTensor ``h``) norms take their plain version, not K5."""
    kind = p.spec.kind
    k5 = not DL.is_dtensor(h)
    x = apply_norm(cfg.norm, p.norm1, h, k5)
    if kind in ("attn", "mla"):
        decode = attn.mla_decode if kind == "mla" else attn.gqa_decode
        y, cache = decode(p.attn, cfg, x, cache, position)
        h = h + y
        if p.spec.cross and enc_out is not None:
            xc = apply_norm(cfg.norm, p.norm_cross, h, k5)
            h = h + attn.cross_attn_forward(p.cross, cfg, xc, enc_out)
        x2 = apply_norm(cfg.norm, p.norm2, h, k5)
        if p.spec.moe:
            y2, _ = moe_forward(p.moe, cfg, x2, dropless=True)
        else:
            y2 = apply_mlp(p.mlp, x2, cfg.mlp_kind)
        h = h + y2
    elif kind in SSM_STEP:
        if DL.is_dtensor(x):
            y, cache = DL.replicated_step(
                lambda w_, x_, st_: SSM_STEP[kind](w_, cfg, x_, st_,
                                                   use_kernel=False),
                p.block, x, cache)
        else:
            y, cache = SSM_STEP[kind](p.block, cfg, x, cache)
        h = h + y
    elif kind == "shared_attn":
        z = torch.cat([x, h0], dim=-1) @ shared["w_concat"]
        y, cache = attn.gqa_decode(shared["attn"], cfg, z, cache, position)
        z = z + y
        z2 = apply_norm(cfg.norm, shared["norm2"], z, k5)
        z = z + apply_mlp(shared["mlp"], z2, cfg.mlp_kind)
        h = h + z @ p.down
    return h, cache


def decode_step(params: CausalLM, cfg: ArchConfig, tokens, state, *,
                enc_out=None, vision_embeds=None, constrain=None):
    """tokens: (B, 1) -> (logits (B, 1, V) float32, new state).  KV caches
    are updated in place; SSM layers get new states in the new state's
    list.  ``enc_out`` is the encoder's output that the cross-attending
    layers read; ``vision_embeds`` is accepted and unused, as in the
    reference (decoding feeds text tokens only).  A learned position past
    the table reads its last row, as the reference's clamped slice does.
    ``constrain`` pins h after the embedding, after every layer and after
    every segment (the reference's decode hook,
    ``decode_act_constraint``)."""
    constrain = constrain or (lambda x: x)
    h = DL.embedding(tokens, params.embed["table"])
    h = constrain(h)
    position = state["position"]
    if cfg.rope_theta == 0.0:
        table = params.pos_embed["pos"]
        row = min(position, table.shape[0] - 1)
        h = h + table[row:row + 1][None]
    h0 = h
    shared = getattr(params, "shared_attn", None)
    caches = []
    ends = _segment_ends(cfg)
    for i, (block, cache) in enumerate(zip(params.blocks, state["caches"])):
        h, cache = _decode_block(block, cfg, h, cache, position=position,
                                 h0=h0, shared=shared, enc_out=enc_out)
        h = constrain(h)
        if i in ends:
            h = constrain(h)
        caches.append(cache)
    h = apply_norm(cfg.norm, params.final_norm, h, not DL.is_dtensor(h))
    return project_logits(params, cfg, h), {"caches": caches,
                                            "position": position + 1}
