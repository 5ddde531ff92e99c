"""Grouped-query attention with an optional sliding window, Multi-head
Latent Attention (DeepSeek-V2), cross-attention (whisper's decoder over
its encoder's output), and their decode-time caches (the port of
``repro/models/attention.py``).

Shapes: hidden (B, S, d_model); caches (B, T, kv_heads, head_dim).  MLA
caches the *compressed* latent (B, T, kv_lora) and the shared rope key
(B, T, rope_dim), and decodes in the absorbed-matmul form.  Its prefill
decompresses keys and values and runs :func:`gqa_attention` under both
``attention_impl`` values, as the reference does: MLA never reaches K6.

``attention_impl`` of :func:`gqa_forward`:
  ``"kernel"``     (default) kernel K6 (:mod:`repro_torch.kernels.
                   flash_attention`), the counterpart of the reference's
                   ``"pallas"``: its kernel on a CUDA tensor, its plain
                   version on a CPU tensor.
  ``"reference"``  :func:`gqa_attention`, the reference model's own
                   arithmetic in torch (softmax weights cast to v's type
                   before P.V, row-chunked above ``Q_CHUNK``).

Cross-attention is plain, unmasked :func:`gqa_attention` under both
values, as in the reference, and decoding recomputes its keys and values
over the whole encoder output at every step.

Unlike the reference, :func:`gqa_decode` and :func:`mla_decode` write the
new entries into their cache in place and return the same cache; on a
mesh the rank that holds the slot writes it (``distributed.local.
write_slot``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device_or_meta
from repro_torch.distributed import local as DL
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models.layers import _dense_init, apply_mrope, apply_rope
from repro_torch.telemetry import instrument

NEG_INF = -1e30
ATTENTION_IMPLS = ("kernel", "reference")


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg: ArchConfig, dtype, device):
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "wq": _dense_init(gen, (d, h * hd), dtype, device),
        "wk": _dense_init(gen, (d, kv * hd), dtype, device),
        "wv": _dense_init(gen, (d, kv * hd), dtype, device),
        "wo": _dense_init(gen, (h * hd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=device)
    return p


def init_mla(gen, cfg: ArchConfig, dtype, device):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    shapes = {
        "wq_a": (d, m.q_lora_rank),
        "wq_b": (m.q_lora_rank, h * qk_head),
        "wkv_a": (d, m.kv_lora_rank),
        "wk_rope": (d, m.qk_rope_head_dim),
        "wk_b": (m.kv_lora_rank, h * m.qk_nope_head_dim),
        "wv_b": (m.kv_lora_rank, h * m.v_head_dim),
        "wo": (h * m.v_head_dim, d),
    }
    return {name: _dense_init(gen, shape, dtype, device)
            for name, shape in shapes.items()}


def init_cross_attn(gen, cfg: ArchConfig, dtype, device):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return {
        "wq": _dense_init(gen, (d, h * hd), dtype, device),
        "wk": _dense_init(gen, (d, h * hd), dtype, device),
        "wv": _dense_init(gen, (d, h * hd), dtype, device),
        "wo": _dense_init(gen, (h * hd, d), dtype, device),
    }


# ---------------------------------------------------------------------------
# Masks + core attention math
# ---------------------------------------------------------------------------

def causal_mask(q_len, kv_len, q_offset=0, window=0, device=DEFAULT_DEVICE):
    """(q_len, kv_len) bool mask.  window=0 -> plain causal."""
    device = resolve_device_or_meta(device)
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    return m


Q_CHUNK = 1024          # q-row tiling threshold for long sequences


def _attn_rows(q, k, v, mask, D):
    """One q-row-block of attention.  q: (B,c,H,D); k,v: (B,T,H,Dv);
    mask broadcastable to (B,1,c,T)."""
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)


class _CoreEnd(torch.autograd.Function):
    """Identity on the attention core's output whose backward opens the
    core's ``attn.core`` span of phase ``backward``."""

    @staticmethod
    def forward(ctx, out, spans):
        ctx.spans = spans
        return out.view_as(out)

    @staticmethod
    def backward(ctx, ct):
        s = instrument.span("attn.core", "backward")
        s.__enter__()
        ctx.spans.append(s)
        return ct, None


class _CoreStart(torch.autograd.Function):
    """Identity on the core's q, k and v whose backward closes the span
    :class:`_CoreEnd` opened: every gradient of the core is in by then."""

    @staticmethod
    def forward(ctx, q, k, v, spans):
        ctx.spans = spans
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        if ctx.spans:
            ctx.spans.pop().__exit__(None, None, None)
        return gq, gk, gv, None


def gqa_attention(q, k, v, mask=None):
    """q: (B,S,H,D); k,v: (B,T,KV,D); mask broadcastable to (B,1,S,T).

    Decode (S == 1) keeps the grouped form (no KV repeat).  Long sequences
    (S > Q_CHUNK, a multiple of it) are tiled over q rows so live score
    buffers stay (B, H, Q_CHUNK, T), as in the reference.  On a mesh a
    full sequence runs shard by shard (``distributed.local.attention``:
    heads, or q's rows, over 'model'); a decode step's scores and
    weighted sum propagate over its sequence-sharded cache.

    In a live training step (``telemetry.instrument``) the core is an
    ``attn.core`` span, and its backward pass one more, bracketed by
    identities on its inputs and output.
    """
    if q.shape[1] == 1 and DL.sequence_sharded(k):
        return _decode_sequence_sharded(q, k, v, mask)
    if DL.is_dtensor(q):
        return DL.attention(gqa_attention, q, k, v, mask)
    if not instrument.live():
        return _core(q, k, v, mask)
    with instrument.span("attn.core"):
        spans = []
        q, k, v = _CoreStart.apply(q, k, v, spans)
        return _CoreEnd.apply(_core(q, k, v, mask), spans)


def _core(q, k, v, mask):
    B, S, H, D = q.shape
    KV = k.shape[2]
    if S == 1 and KV != H:
        G = H // KV
        qg = DL.split_dim(q.reshape(B, H, D), 1, KV, (B, KV, G, D))
        scores = torch.einsum("bkgd,btkd->bkgt", qg, k).to(torch.float32)
        scores = scores / math.sqrt(D)
        if mask is not None:           # (B,1,1,T) -> (B,1,1,T) broadcast
            m = mask[:, :, 0, None, :] if mask.dim() == 4 else mask
            scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgt,btkd->bkgd", w.to(v.dtype), v)
        return out.reshape(B, 1, H, v.shape[-1])

    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=2)
        v = torch.repeat_interleave(v, H // KV, dim=2)
    if mask is not None and mask.dim() == 3:
        mask = mask[:, :, None]

    if S <= Q_CHUNK or S % Q_CHUNK:
        out = _attn_rows(q, k, v, mask, D)
        return out.reshape(B, S, H, v.shape[-1])

    chunks = []
    for i in range(S // Q_CHUNK):
        rows = slice(i * Q_CHUNK, (i + 1) * Q_CHUNK)
        mc = (mask[:, :, rows] if mask is not None and mask.shape[2] == S
              else mask)
        chunks.append(_attn_rows(q[:, rows], k, v, mc, D))
    return torch.cat(chunks, dim=1)


def _decode_sequence_sharded(q, k, v, mask):
    """:func:`gqa_attention`'s decode form against a cache sharded on its
    sequence (``distributed.local.sequence_attention``)."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = DL.split_dim(q.reshape(B, H, D), 1, KV, (B, KV, G, D))
    m = None
    if mask is not None:       # (B,1,1,T) -> (B,1,1,T) broadcast
        m = mask[:, :, 0, None, :] if mask.dim() == 4 else mask
    out = DL.sequence_attention(
        (qg,), (k,), (v,), m,
        lambda q_, k_: torch.einsum("bkgd,btkd->bkgt", q_[0], k_).to(
            torch.float32),
        lambda w, v_: torch.einsum("bkgt,btkd->bkgd", w, v_),
        math.sqrt(D))
    return out.reshape(B, 1, H, v.shape[-1])


def _rope_any(cfg, x, positions):
    if cfg.rope_theta == 0.0:
        return x            # learned absolute positions (whisper)
    if cfg.rope_kind == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# GQA forward (prefill) and decode
# ---------------------------------------------------------------------------

def _project_qkv(p, cfg, x):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = DL.matmul(x, p["wq"])
    k = DL.matmul(x, p["wk"])
    v = DL.matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (DL.split_heads(q, B, S, h, hd), DL.split_heads(k, B, S, kv, hd),
            DL.split_heads(v, B, S, kv, hd))


def gqa_forward(p, cfg: ArchConfig, x, positions, *, window=0,
                attention_impl="kernel"):
    """Full-sequence causal attention (prefill)."""
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl={attention_impl!r} must be one of "
                         f"{ATTENTION_IMPLS}")
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    q = _rope_any(cfg, q, positions)
    k = _rope_any(cfg, k, positions)
    if attention_impl == "kernel":
        out = kfa.flash_attention(q, k, v, causal=True, window=window)
    else:
        mask = causal_mask(S, S, window=window, device=x.device)[None, None]
        out = gqa_attention(q, k, v, mask)
    return DL.matmul(DL.merge_heads(out, B, S, -1), p["wo"])


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor         # (B, T, KV, D) — T = max_len or window
    v: torch.Tensor
    pos: torch.Tensor       # (B, T) absolute position per slot, -1 empty
    index: int = 0          # next write slot (a ring for a window)
    window: int = 0         # 0 -> full cache


def init_kv_cache(cfg: ArchConfig, batch, max_len, dtype, window=0,
                  device=DEFAULT_DEVICE):
    device = resolve_device_or_meta(device)
    T = window if window else max_len
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros((batch, T, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, T, kv, hd), dtype=dtype, device=device),
        pos=torch.full((batch, T), -1, dtype=torch.int64, device=device),
        window=window,
    )


def gqa_decode(p, cfg: ArchConfig, x, cache: KVCache, position: int):
    """One-token decode.  x: (B, 1, d); position: the absolute position (an
    int).  Writes slot ``index % T`` (window) or ``index`` of ``cache`` in
    place and returns ``(y, cache)``."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x)
    pos_b = torch.full((B, 1), position, dtype=torch.int64, device=x.device)
    if cfg.rope_kind == "mrope":
        pos_b = pos_b[None].expand(3, B, 1)         # text: (p, p, p)
    q = _rope_any(cfg, q, pos_b)
    k_new = _rope_any(cfg, k_new, pos_b)
    slot = cache.index % cache.k.shape[1] if cache.window else cache.index
    DL.write_slot(cache.k, slot, k_new[:, 0])
    DL.write_slot(cache.v, slot, v_new[:, 0])
    DL.write_slot(cache.pos, slot, position)
    valid = cache.pos >= 0                            # (B, T)
    if cache.window:
        valid = valid & (cache.pos > position - cache.window)
    mask = valid[:, None, None, :]                    # (B,1,1,T)
    out = gqa_attention(q, cache.k, cache.v, mask)    # (B,1,H,D)
    y = DL.merge_heads(out, B, 1, -1) @ p["wo"]
    cache.index += 1
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MLACache:
    c_kv: torch.Tensor      # (B, T, kv_lora)
    k_rope: torch.Tensor    # (B, T, rope_dim)
    index: int = 0          # next write slot


def init_mla_cache(cfg: ArchConfig, batch, max_len, dtype,
                   device=DEFAULT_DEVICE):
    device = resolve_device_or_meta(device)
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, m.qk_rope_head_dim),
                           dtype=dtype, device=device))


def _mla_q(p, cfg, x, positions):
    m, B, S, h = cfg.mla, x.shape[0], x.shape[1], cfg.num_heads
    q = DL.split_heads(DL.matmul(DL.matmul(x, p["wq_a"]), p["wq_b"]),
                       B, S, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_forward(p, cfg: ArchConfig, x, positions):
    """Prefill MLA: keys and values decompressed from the latent, then
    :func:`gqa_attention` (KV == H, q/k head dim nope + rope)."""
    m, B, S, h = cfg.mla, x.shape[0], x.shape[1], cfg.num_heads
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv = DL.matmul(x, p["wkv_a"])
    k_rope = apply_rope(DL.matmul(x, p["wk_rope"])[:, :, None, :], positions,
                        cfg.rope_theta)                 # shared by the heads
    k_nope = DL.split_heads(DL.matmul(c_kv, p["wk_b"]), B, S, h,
                            m.qk_nope_head_dim)
    v = DL.split_heads(DL.matmul(c_kv, p["wv_b"]), B, S, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, m.qk_rope_head_dim)],
                  dim=-1)
    mask = causal_mask(S, S, device=x.device)[None, None]
    out = gqa_attention(q, k, v, mask)
    return DL.matmul(DL.merge_heads(out, B, S, -1), p["wo"])


def mla_decode(p, cfg: ArchConfig, x, cache: MLACache, position: int):
    """Absorbed-matmul decode: one token scored against the *compressed*
    cache.  Writes slot ``index`` of ``cache`` in place and returns
    ``(y, cache)``.  The two score products are added in x's type and
    only then cast to float32, as in the reference."""
    m, B, h = cfg.mla, x.shape[0], cfg.num_heads
    pos_b = torch.full((B, 1), position, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, pos_b)           # (B,1,h,.)
    i = cache.index
    DL.write_slot(cache.c_kv, i, (x @ p["wkv_a"])[:, 0])
    DL.write_slot(cache.k_rope, i, apply_rope(
        (x @ p["wk_rope"])[:, :, None, :], pos_b, cfg.rope_theta)[:, 0, 0])
    # absorb W_uk into q: (B,1,h,nope) x (r, h*nope) -> (B,1,h,r)
    wk_b = DL.split_heads(p["wk_b"], m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
    if DL.sequence_sharded(cache.c_kv):
        return _mla_decode_sharded(p, cfg, x, cache, q_lat, q_rope, B, h)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, cache.c_kv)
              + torch.einsum("bshn,btn->bhst", q_rope, cache.k_rope)
              ).to(torch.float32)
    scores = scores / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    valid = torch.arange(cache.c_kv.shape[1], device=x.device) <= i
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    lat = torch.einsum("bhst,btr->bshr", w, cache.c_kv)  # (B,1,h,r)
    wv_b = p["wv_b"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", lat, wv_b)
    y = DL.merge_heads(out, B, 1, -1) @ p["wo"]
    cache.index += 1
    return y, cache


def _mla_decode_sharded(p, cfg, x, cache, q_lat, q_rope, B, h):
    """:func:`mla_decode`'s scores and weighted sum against a compressed
    cache sharded on its sequence (``distributed.local.
    sequence_attention``); the two score products are added in x's type
    before the float32 cast, as in the unsharded form."""
    m, i = cfg.mla, cache.index
    T = cache.c_kv.shape[1]
    valid = (torch.arange(T, device=x.device) <= i)[None, None, None, :]
    lat = DL.sequence_attention(
        (q_lat, q_rope), (cache.c_kv, cache.k_rope), (cache.c_kv,), valid,
        lambda q_, c_, r_: (torch.einsum("bshr,btr->bhst", q_[0], c_)
                            + torch.einsum("bshn,btn->bhst", q_[1], r_)
                            ).to(torch.float32),
        lambda w, c_: torch.einsum("bhst,btr->bshr", w, c_),
        math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    wv_b = DL.split_heads(p["wv_b"], m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", lat, wv_b)
    y = DL.merge_heads(out, B, 1, -1) @ p["wo"]
    cache.index += 1
    return y, cache


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder -> encoder output)
# ---------------------------------------------------------------------------

def cross_attn_forward(p, cfg: ArchConfig, x, enc_out):
    """x: (B, S, d) queries over enc_out: (B, Te, d) keys and values, no
    mask."""
    B, S, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    Te = enc_out.shape[1]
    q = DL.split_heads(DL.matmul(x, p["wq"]), B, S, h, hd)
    k = DL.split_heads(DL.matmul(enc_out, p["wk"]), B, Te, h, hd)
    v = DL.split_heads(DL.matmul(enc_out, p["wv"]), B, Te, h, hd)
    out = gqa_attention(q, k, v, mask=None)
    return DL.matmul(DL.merge_heads(out, B, S, -1), p["wo"])
