"""Shared building blocks: norms, MLPs, rotary embeddings, embeddings
(the port of ``repro/models/layers.py``, its dense parts).

Parameters are dictionaries of tensors (``nn.ParameterDict`` inside the
model); every ``init_*`` takes an explicit ``torch.Generator`` and device,
every ``apply_*`` is a function of its inputs.  Every RMSNorm goes through
kernel K5 (:mod:`repro_torch.kernels.rmsnorm`): its kernel on a CUDA
tensor, its plain version on a CPU tensor; ``use_kernel=False`` asks for
the plain version on any device.  Rotary embeddings come in the standard
form and Qwen2-VL's multimodal M-RoPE; whisper's learned absolute
positions are a table of their own (:func:`init_learned_positions`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as krms


def _dense_init(gen, shape, dtype, device, scale=None, stacked=False):
    """``normal(shape) * scale`` drawn in float32 from ``gen`` and cast to
    ``dtype``; ``scale`` defaults to ``1 / sqrt(shape[0])`` (the fan-in;
    for stacked experts the reference's own choice, ``1 / sqrt(E)``).
    The draw is scaled in place, so a leaf holds one float32 copy at most;
    ``stacked=True`` draws one slice of the leading axis at a time into
    the ``dtype`` tensor, so a stack of experts never exists in float32.
    On the meta device only the shape is made."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])

    def draw(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(scale)

    if not stacked:
        return draw(shape).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_rmsnorm(p, x, eps=krms.EPS, use_kernel=True):
    if use_kernel:
        return krms.rmsnorm(x, p["scale"], eps)
    return krms.rmsnorm_plain(x, p["scale"], eps)


def init_layernorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_layernorm(p, x, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def init_norm(kind, d, dtype, device):
    return (init_rmsnorm(d, dtype, device) if kind == "rmsnorm"
            else init_layernorm(d, dtype, device))


def apply_norm(kind, p, x, use_kernel=True):
    if kind == "rmsnorm":
        return apply_rmsnorm(p, x, use_kernel=use_kernel)
    return apply_layernorm(p, x)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model, d_ff, kind, dtype, device):
    if kind == "swiglu":
        return {
            "wi_gate": _dense_init(gen, (d_model, d_ff), dtype, device),
            "wi_up": _dense_init(gen, (d_model, d_ff), dtype, device),
            "wo": _dense_init(gen, (d_ff, d_model), dtype, device),
        }
    return {  # gelu
        "wi": _dense_init(gen, (d_model, d_ff), dtype, device),
        "bi": torch.zeros((d_ff,), dtype=dtype, device=device),
        "wo": _dense_init(gen, (d_ff, d_model), dtype, device),
        "bo": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def apply_mlp(p, x, kind):
    """SwiGLU or GELU MLP; the activation is taken in float32 and cast
    back, as in the reference."""
    if kind == "swiglu":
        g = x @ p["wi_gate"]
        u = x @ p["wi_up"]
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        return h @ p["wo"]
    h = x @ p["wi"] + p["bi"]
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return h @ p["wo"] + p["bo"]


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    """Half-dim inverse frequencies, float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponent)


def apply_rope(x, positions, theta):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.
    Computed in float32 and cast back to x's type."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv
    sin = torch.sin(ang)[..., None, :]                # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta, sections):
    """Qwen2-VL's multimodal RoPE.  x: (batch, seq, heads, head_dim);
    positions3: (3, batch, seq) temporal, height and width ids;
    ``sections`` splits the head_dim/2 frequency slots among the three
    streams, in that order.  Computed in float32 and cast back to x's
    type."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])
    if sec.shape[0] != x.shape[-1] // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not split "
                         f"head_dim/2 = {x.shape[-1] // 2} slots")
    # each frequency slot reads its own stream: (batch, seq, hd/2)
    pos = positions3.permute(1, 2, 0).to(torch.float32)[:, :, sec]
    ang = pos * inv
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_embedding(gen, vocab, d_model, dtype, device):
    return {"table": _dense_init(gen, (vocab, d_model), dtype, device,
                                 scale=0.02)}


def init_learned_positions(gen, max_len, d_model, dtype, device):
    return {"pos": _dense_init(gen, (max_len, d_model), dtype, device,
                               scale=0.02)}
