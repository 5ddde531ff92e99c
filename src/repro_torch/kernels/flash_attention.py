"""Flash-attention kernel K6 (CUDA source: ``csrc/flash_attention.cu``).

:func:`flash_attention_bhsd` replaces the Pallas kernel
``repro/kernels/flash_attention.py`` ``_flash_kernel`` /
``flash_attention_bhsd``; :func:`flash_attention` is the model-layout
wrapper, the counterpart of ``repro/kernels/ops.py`` ``flash_attention``.

q (B, H, S, D) attends to k, v (B, KV, T, D); query head h reads key/value
head ``h * KV // H`` (grouped-query attention, no repeat materialised).
Scores are ``q.k / sqrt(D)`` in float32, masked from global indices
(causal: ``col <= row``; ``window > 0``: ``col > row - window``); the
running softmax is float32 and the output is cast to q's type.  The plain
version :func:`attention_plain` is the counterpart of the reference's
``ref.attention_ref``.

The type picks one of two hand-written kernels, and neither stands in for
the other: bfloat16 (the model's path) runs both products on Hopper's
tensor cores (``wgmma``, fed by TMA copies), with P rounded to bfloat16
before P.V as FlashAttention does, and takes D a multiple of 16 up to
256; float32 runs on CUDA cores with P.V in float32 (the tensor cores'
float32 is TF32) and takes D a multiple of 4 up to 256.  Both mask the
ragged S and T edges themselves, so nothing is padded, and read any
(batch, head, row) strides as long as the head dimension is contiguous,
so the model's (B, S, H, D) tensors go in as transposed views without a
copy; in bfloat16 each row must start on 16 bytes (strides a multiple of
8), as TMA requires.  On the card the function is bound by operations.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# the head dimension each kernel takes: a multiple of this, up to 256
HEAD_DIM_MULTIPLE = {torch.float32: 4, torch.bfloat16: 16}


def attention_plain(q, k, v, causal=True, window=0):
    """Plain version of K6: q (B, H, S, D), k, v (B, KV, T, D) ->
    (B, H, S, D) in q's type; unchunked, float32 throughout."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if KV != H:
        k = torch.repeat_interleave(k, H // KV, dim=1)
        v = torch.repeat_interleave(v, H // KV, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(D)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w,
                        v.to(torch.float32)).to(q.dtype)


def _check(q, k, v, causal):
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention_bhsd: q, k and v must share one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_bhsd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, D = q.shape
    _, KV, T, Dk = k.shape
    if k.shape[0] != B or Dk != D or KV < 1 or H % KV or T < 1:
        raise ValueError(f"flash_attention_bhsd: q {tuple(q.shape)} does "
                         f"not fit k/v {tuple(k.shape)}")
    if causal and S > T:
        raise ValueError(f"flash_attention_bhsd: causal rows beyond T={T} "
                         f"see no key (S={S})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_bhsd: q, k, v must all be float32 "
                        f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_head_dim(D, q.dtype)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_bhsd: the head dimension of q, k "
                         "and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("flash_attention_bhsd: bfloat16 rows of q, k and v "
                         "must start on 16 bytes (strides a multiple of 8)")


def check_head_dim(D, dtype):
    """Raise ValueError unless the kernel for ``dtype`` takes head dim D."""
    m = HEAD_DIM_MULTIPLE[dtype]
    if D > MAX_HEAD_DIM or D % m:
        raise ValueError(f"flash_attention_bhsd: {dtype} head dim {D} must "
                         f"be a multiple of {m} and at most {MAX_HEAD_DIM}")


def flash_attention_bhsd(q, k, v, causal=True, window=0):
    """K6: q (B, H, S, D), k, v (B, KV, T, D) -> (B, H, S, D) in q's type.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of its type (bfloat16: D a multiple of 16 up to 256, rows on 16 bytes;
    float32: D a multiple of 4 up to 256; head dimension contiguous, any
    other strides).  The output is laid out (B, S, H, D) in
    memory and returned as its (B, H, S, D) view."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, window)
    _check(q, k, v, causal)
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = tuple(s for t in (q, k, v, out) for s in t.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.extension().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        S, T, D, strides, int(bool(causal)), int(window),
        1.0 / math.sqrt(D), DTYPES[q.dtype], stream)
    build.check(err, "flash_attention")
    build.count_launch(flash_attention_bhsd)
    return out


flash_attention_bhsd.launches = 0


def flash_attention(q, k, v, causal=True, window=0):
    """Model-layout wrapper of K6: q (B, S, H, D), k, v (B, T, KV, D) ->
    (B, S, H, D); transposes are views, nothing is copied or padded."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal, window)
    return out.transpose(1, 2)
