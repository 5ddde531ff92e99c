"""Grouped-query attention with an optional sliding window, and its
decode-time KV cache (the port of ``repro/models/attention.py``, its GQA
part; MLA and cross-attention wait, ROADMAP A14).

Shapes: hidden (B, S, d_model); caches (B, T, kv_heads, head_dim).

``attention_impl`` of :func:`gqa_forward`:
  ``"kernel"``     (default) kernel K6 (:mod:`repro_torch.kernels.
                   flash_attention`), the counterpart of the reference's
                   ``"pallas"``: its kernel on a CUDA tensor, its plain
                   version on a CPU tensor.
  ``"reference"``  :func:`gqa_attention`, the reference model's own
                   arithmetic in torch (softmax weights cast to v's type
                   before P.V, row-chunked above ``Q_CHUNK``).

Unlike the reference, :func:`gqa_decode` writes the new key, value and
position into its cache in place and returns the same cache.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models.layers import _dense_init, apply_rope

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


# ---------------------------------------------------------------------------
# Masks + core attention math
# ---------------------------------------------------------------------------

def causal_mask(q_len, kv_len, window=0, device=None):
    """(q_len, kv_len) bool mask.  window=0 -> plain causal."""
    qi = torch.arange(q_len, device=device)[:, None]
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
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)


def gqa_attention(q, k, v, mask=None):
    """q: (B,S,H,D); k,v: (B,T,KV,D); mask broadcastable to (B,1,S,T).

    Decode (S == 1) keeps the grouped form (no KV repeat).  Long sequences
    (S > Q_CHUNK, a multiple of it) are tiled over q rows so live score
    buffers stay (B, H, Q_CHUNK, T), as in the reference.
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    if S == 1 and KV != H:
        G = H // KV
        qg = q.reshape(B, KV, G, D)
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


def _rope_any(cfg, x, positions):
    if cfg.rope_theta == 0.0 or cfg.rope_kind != "standard":
        raise NotImplementedError(
            f"{cfg.name}: learned positions and M-RoPE are not ported yet "
            f"(ROADMAP A14)")
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# GQA forward (prefill) and decode
# ---------------------------------------------------------------------------

def _project_qkv(p, cfg, x):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, h, hd), k.reshape(B, S, kv, hd),
            v.reshape(B, S, kv, hd))


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
    return out.reshape(B, S, -1) @ p["wo"]


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor         # (B, T, KV, D) — T = max_len or window
    v: torch.Tensor
    pos: torch.Tensor       # (B, T) absolute position per slot, -1 empty
    index: int = 0          # next write slot (a ring for a window)
    window: int = 0         # 0 -> full cache


def init_kv_cache(cfg: ArchConfig, batch, max_len, dtype, window=0,
                  device="cpu"):
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
    q = _rope_any(cfg, q, pos_b)
    k_new = _rope_any(cfg, k_new, pos_b)
    slot = cache.index % cache.k.shape[1] if cache.window else cache.index
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    cache.pos[:, slot] = position
    valid = cache.pos >= 0                            # (B, T)
    if cache.window:
        valid = valid & (cache.pos > position - cache.window)
    mask = valid[:, None, None, :]                    # (B,1,1,T)
    out = gqa_attention(q, cache.k, cache.v, mask)    # (B,1,H,D)
    y = out.reshape(B, 1, -1) @ p["wo"]
    cache.index += 1
    return y, cache
