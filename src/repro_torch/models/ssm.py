"""SSM blocks: Mamba2 (chunked SSD), xLSTM's mLSTM (chunkwise matrix
memory) and sLSTM (stabilized scalar-memory recurrence); the port of
``repro/models/ssm.py``.

Within a chunk the work is dense products (chunk x chunk); only the
chunk-boundary states are kept, and the recurrence between chunks is a
Python loop over them (the reference's short ``lax.scan``).  sLSTM is a
loop over tokens, as the reference's scan over T.

All blocks expose:
  init_*(gen, cfg, dtype, device)  -> parameter dict
  *_forward(p, cfg, x)             -> (B, T, d)          (train / prefill)
  *_step(p, cfg, x, state)         -> ((B, 1, d), state) (one-token decode)
  init_*_state(cfg, batch, dtype, device) -> constant-size decode state

Every block ends in :func:`_gated_rmsnorm`, whose normalisation is kernel
K5's function (``kernels/rmsnorm.py``, the same ``EPS``): with
``use_kernel=True`` (the default) it goes through K5 (its kernel on a
CUDA tensor, its plain version on a CPU tensor), with ``use_kernel=False``
through K5's plain version on any device.  Everything else is PyTorch
operations: the reference has no Pallas kernel here.  Decode states are
dataclasses of tensors; a step returns a new state and leaves the old one
as it was.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _dense_init, apply_rmsnorm

HEAD_DIM = 64


def _gated_rmsnorm(x, z, scale, use_kernel=True):
    """``x * silu(z)`` (the gate taken in float32 and cast to x's type),
    then RMSNorm with gain ``scale`` through K5."""
    x = x * F.silu(z.to(torch.float32)).to(x.dtype)
    return apply_rmsnorm({"scale": scale}, x, use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ArchConfig):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    heads = s.num_heads or inner // HEAD_DIM
    return s, inner, heads, inner // heads, s.state_dim


def init_mamba2(gen, cfg: ArchConfig, dtype, device):
    s, inner, H, hd, N = _mamba_dims(cfg)
    d = cfg.d_model
    conv_ch = inner + 2 * N          # x, B, C all pass through the conv
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj -> [z(inner), xBC(conv_ch), dt(H)]
        "in_proj": _dense_init(gen, (d, 2 * inner + 2 * N + H), dtype,
                               device),
        "conv_w": _dense_init(gen, (s.conv_width, conv_ch), dtype, device,
                              scale=0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros((H,), **f32),         # A = -exp(a_log)
        "dt_bias": torch.zeros((H,), **f32),
        "d_skip": torch.ones((H,), **f32),
        "out_proj": _dense_init(gen, (inner, d), dtype, device),
        "norm_scale": torch.ones((inner,), dtype=dtype, device=device),
    }


def _causal_conv(x, w, b):
    """x: (B, T, C); w: (W, C) depthwise."""
    W, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + T, :] * w[i] for i in range(W))
    return out + b


def _causal(chunk, device):
    """(chunk, chunk) bool, True on and below the diagonal."""
    return torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=device))


def _causal_exp(rel):
    """``where(causal, exp(rel), 0)`` over the last two axes (t, s) of a
    new tensor ``rel``, in place: the masked entries become -inf before
    the exponential, so no entry above the diagonal overflows and the
    backward pass sees exp's own output."""
    chunk = rel.shape[-1]
    return rel.masked_fill_(~_causal(chunk, rel.device), -math.inf).exp_()


def _ssd_chunked(xh, dt, B_, C_, a_log, chunk):
    """Chunked SSD core.

    xh: (B,T,H,hd)  dt: (B,T,H)  B_,C_: (B,T,N)  ->  y: (B,T,H,hd),
    final state (B,H,hd,N).  The (B,nc,H,L,L) decay matrix is made in
    the layout its product reads.
    """
    Bsz, T, H, hd = xh.shape
    N = B_.shape[-1]
    nc = T // chunk
    A = -torch.exp(a_log)                                 # (H,) negative
    dt = F.softplus(dt.to(torch.float32))                 # (B,T,H)
    glog = (dt * A).reshape(Bsz, nc, chunk, H)            # log-decay per step
    xin = (xh.to(torch.float32)
           * dt[..., None]).reshape(Bsz, nc, chunk, H, hd)
    Bc = B_.to(torch.float32).reshape(Bsz, nc, chunk, N)
    Cc = C_.to(torch.float32).reshape(Bsz, nc, chunk, N)

    cs = torch.cumsum(glog, dim=2)                        # (B,nc,L,H)
    total = cs[:, :, -1]                                  # (B,nc,H)

    # within-chunk (attention-like, causal): W[t,s] = (C_t.B_s) e^(cs_t-cs_s)
    csh = cs.transpose(2, 3)                              # (B,nc,H,L)
    W = _causal_exp(csh[..., :, None] - csh[..., None, :])  # (B,nc,H,L,L)
    W = W * torch.einsum("bctn,bcsn->bcts", Cc, Bc)[:, :, None]
    y_intra = torch.einsum("bchts,bcshd->bcthd", W, xin)
    del W

    # chunk summary state: decay inputs to chunk end
    decay_to_end = torch.exp(total[:, :, None, :] - cs)   # (B,nc,L,H)
    S_chunk = torch.einsum("bclhd,bcln->bchdn",
                           decay_to_end[..., None] * xin, Bc)

    # inter-chunk recurrence over the chunk-boundary states
    S = torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=xh.device)
    decay = torch.exp(total)
    befores = []
    for c in range(nc):
        befores.append(S)
        S = decay[:, c, :, None, None] * S + S_chunk[:, c]
    S_befores = torch.stack(befores, dim=1)               # (B,nc,H,hd,N)

    y_inter = torch.einsum("bcln,bchdn->bclhd", Cc, S_befores) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, T, H, hd)
    return y, S


def mamba2_forward(p, cfg: ArchConfig, x, return_state=False,
                   use_kernel=True):
    s, inner, H, hd, N = _mamba_dims(cfg)
    B, T, _ = x.shape
    proj = x @ p["in_proj"]
    z, xBC, dt = torch.split(proj, [inner, inner + 2 * N, H], dim=-1)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"])
                 .to(torch.float32)).to(x.dtype)
    xh, B_, C_ = torch.split(xBC, [inner, N, N], dim=-1)
    xh = xh.reshape(B, T, H, hd)
    chunk = min(s.chunk_size, T)
    pad = (-T) % chunk
    xp = xh
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt, B_, C_ = (F.pad(a, (0, 0, 0, pad)) for a in (dt, B_, C_))
    y, S_last = _ssd_chunked(xp, dt, B_, C_, p["a_log"], chunk)
    y = y[:, :T]
    y = y + p["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(B, T, inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"], use_kernel)
    out = y @ p["out_proj"]
    if return_state:
        return out, S_last
    return out


@dataclasses.dataclass
class Mamba2State:
    conv: torch.Tensor       # (B, W-1, conv_ch) trailing inputs
    ssm: torch.Tensor        # (B, H, hd, N) f32


def init_mamba2_state(cfg: ArchConfig, batch, dtype, device="cpu"):
    s, inner, H, hd, N = _mamba_dims(cfg)
    conv_ch = inner + 2 * N
    return Mamba2State(
        conv=torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, H, hd, N), dtype=torch.float32,
                        device=device),
    )


def mamba2_step(p, cfg: ArchConfig, x, state: Mamba2State, use_kernel=True):
    """x: (B,1,d) -> (y, new_state)."""
    s, inner, H, hd, N = _mamba_dims(cfg)
    B = x.shape[0]
    proj = x @ p["in_proj"]
    z, xBC, dt = torch.split(proj, [inner, inner + 2 * N, H], dim=-1)
    hist = torch.cat([state.conv, xBC], dim=1)            # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv_out.to(torch.float32)).to(x.dtype)
    xh, Bv, Cv = torch.split(xBC, [inner, N, N], dim=-1)
    xh = xh.reshape(B, H, hd).to(torch.float32)
    dtv = F.softplus(dt[:, 0].to(torch.float32))          # (B,H)
    A = -torch.exp(p["a_log"])
    decay = torch.exp(dtv * A)                            # (B,H)
    Bv = Bv.to(torch.float32)                             # (B,N)
    Cv = Cv.to(torch.float32)
    S = (decay[..., None, None] * state.ssm
         + (dtv[..., None] * xh)[..., None] * Bv[:, None, None, :])
    y = (S @ Cv[:, None, :, None])[..., 0]                # (B,H,hd)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(B, 1, inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"], use_kernel)
    out = y @ p["out_proj"]
    return out, Mamba2State(conv=hist[:, 1:], ssm=S)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory) — chunkwise linear-attention-with-gates form
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ArchConfig):
    H = cfg.ssm.num_heads or cfg.num_heads
    inner = cfg.ssm.expand * cfg.d_model
    return inner, H, inner // H


def init_mlstm(gen, cfg: ArchConfig, dtype, device):
    inner, H, hd = _mlstm_dims(cfg)
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wq": _dense_init(gen, (d, inner), dtype, device),
        "wk": _dense_init(gen, (d, inner), dtype, device),
        "wv": _dense_init(gen, (d, inner), dtype, device),
        "w_if": _dense_init(gen, (d, 2 * H), dtype, device, scale=0.01),
        "b_i": torch.full((H,), -3.0, **f32),  # small input gates at init
        "b_f": torch.full((H,), 3.0, **f32),   # open forget gates at init
        "wz": _dense_init(gen, (d, inner), dtype, device),
        "out_proj": _dense_init(gen, (inner, d), dtype, device),
        "norm_scale": torch.ones((inner,), dtype=dtype, device=device),
    }


def _mlstm_gates(p, x):
    gf = (x @ p["w_if"]).to(torch.float32)
    H = p["b_i"].shape[0]
    i_raw = gf[..., :H] + p["b_i"]
    f_raw = gf[..., H:] + p["b_f"]
    log_f = F.logsigmoid(f_raw)                           # <= 0
    log_i = torch.clamp(i_raw, -20.0, 10.0)               # soft-capped exp gate
    return log_i, log_f


def mlstm_forward(p, cfg: ArchConfig, x, return_state=False,
                  use_kernel=True):
    inner, H, hd = _mlstm_dims(cfg)
    B, T, _ = x.shape
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, H, hd)
    v = (x @ p["wv"]).reshape(B, T, H, hd)
    z = x @ p["wz"]
    log_i, log_f = _mlstm_gates(p, x)                     # (B,T,H)

    chunk = min(cfg.ssm.chunk_size, T)
    pad = (-T) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad))
        log_f = F.pad(log_f, (0, 0, 0, pad))
    Tp = T + pad
    nc = Tp // chunk
    qc = q.reshape(B, nc, chunk, H, hd).to(torch.float32) / math.sqrt(hd)
    kc = k.reshape(B, nc, chunk, H, hd).to(torch.float32)
    vc = v.reshape(B, nc, chunk, H, hd).to(torch.float32)
    li = log_i.reshape(B, nc, chunk, H)
    lf = log_f.reshape(B, nc, chunk, H)

    cs = torch.cumsum(lf, dim=2)                          # (B,nc,L,H)
    total = cs[:, :, -1]

    # within-chunk: W[t,s] = (q_t.k_s) exp(cs_t - cs_s + li_s), causal;
    # made once, it gives both y_intra and the normaliser's intra part
    csh, lih = cs.transpose(2, 3), li.transpose(2, 3)     # (B,nc,H,L)
    W = _causal_exp(csh[..., :, None] - csh[..., None, :] + lih[..., None, :])
    W = W * torch.einsum("bcthd,bcshd->bchts", qc, kc)   # (B,nc,H,L,L)
    y_intra = torch.einsum("bchts,bcshd->bcthd", W, vc)
    n_intra = W.sum(dim=-1).transpose(2, 3)               # (B,nc,L,H)
    del W

    # chunk summary: C_chunk = sum_s exp(total - cs_s + li_s) k_s v_s^T
    w_end = torch.exp(total[:, :, None, :] - cs + li)     # (B,nc,L,H)
    kw = w_end[..., None] * kc
    C_chunk = torch.einsum("bclhd,bclhe->bchde", kw, vc)
    n_chunk = kw.sum(dim=2)                               # (B,nc,H,hd)

    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    decay = torch.exp(total)
    C_bef, n_bef = [], []
    for c in range(nc):
        C_bef.append(C)
        n_bef.append(n)
        C = decay[:, c, :, None, None] * C + C_chunk[:, c]
        n = decay[:, c, :, None] * n + n_chunk[:, c]
    C_bef = torch.stack(C_bef, dim=1)                     # (B,nc,H,hd,hd)
    n_bef = torch.stack(n_bef, dim=1)                     # (B,nc,H,hd)

    qe = qc * torch.exp(cs)[..., None]
    y_inter = torch.einsum("bclhd,bchde->bclhe", qe, C_bef)
    n_inter = torch.sum(qe * n_bef[:, :, None], dim=-1)   # (B,nc,L,H)
    denom = torch.clamp_min(torch.abs(n_inter + n_intra), 1.0)[..., None]
    y = (y_intra + y_inter) / denom
    y = y.reshape(B, Tp, inner)[:, :T].to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"], use_kernel)
    out = y @ p["out_proj"]
    if return_state:
        return out, (C, n)
    return out


@dataclasses.dataclass
class MLSTMState:
    C: torch.Tensor          # (B,H,hd,hd) f32
    n: torch.Tensor          # (B,H,hd) f32


def init_mlstm_state(cfg: ArchConfig, batch, dtype, device="cpu"):
    inner, H, hd = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((batch, H, hd, hd), **f32),
                      n=torch.zeros((batch, H, hd), **f32))


def mlstm_step(p, cfg: ArchConfig, x, state: MLSTMState, use_kernel=True):
    inner, H, hd = _mlstm_dims(cfg)
    B = x.shape[0]
    q = (x @ p["wq"]).reshape(B, H, hd).to(torch.float32)
    k = (x @ p["wk"]).reshape(B, H, hd).to(torch.float32)
    v = (x @ p["wv"]).reshape(B, H, hd).to(torch.float32)
    z = x @ p["wz"]
    log_i, log_f = _mlstm_gates(p, x)                     # (B,1,H)
    fi, ii = torch.exp(log_f[:, 0]), torch.exp(log_i[:, 0])   # (B,H)
    q = q / math.sqrt(hd)
    C = (fi[..., None, None] * state.C
         + ii[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = fi[..., None] * state.n + ii[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]                # (B,H,hd)
    den = torch.clamp_min(torch.abs(torch.sum(q * n, dim=-1)), 1.0)
    y = (num / den[..., None]).reshape(B, 1, inner).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"], use_kernel)
    out = y @ p["out_proj"]
    return out, MLSTMState(C=C, n=n)


# ---------------------------------------------------------------------------
# sLSTM — stabilized scalar-memory recurrence with head-wise recurrent mixing
# ---------------------------------------------------------------------------

def _slstm_dims(cfg: ArchConfig):
    H = cfg.ssm.num_heads or cfg.num_heads
    return cfg.d_model, H, cfg.d_model // H


def init_slstm(gen, cfg: ArchConfig, dtype, device):
    d, H, hd = _slstm_dims(cfg)
    return {
        "w_in": _dense_init(gen, (d, 4 * d), dtype, device),   # i,f,z,o
        "r": _dense_init(gen, (H, hd, 4 * hd), dtype, device,
                         scale=1.0 / hd ** 0.5),
        "b": torch.cat([torch.full((d,), -3.0), torch.full((d,), 3.0),
                        torch.zeros((2 * d,))]).to(device=device,
                                                   dtype=torch.float32),
        "out_proj": _dense_init(gen, (d, d), dtype, device),
        "norm_scale": torch.ones((d,), dtype=dtype, device=device),
    }


def _slstm_inputs(p, x):
    """The input projection of every token, gate-major and float32:
    (B, T, d) -> (T, B, H, 4, hd)."""
    H, _, four_hd = p["r"].shape
    B, T, d = x.shape
    wx = (x @ p["w_in"]).to(torch.float32).reshape(B, T, 4, H, four_hd // 4)
    return wx.permute(1, 0, 3, 2, 4)


def _slstm_cell(r, b, wx_t, carry):
    """One sLSTM step.  r: (H, hd, 4hd) float32; b: (H, 4, hd) float32;
    wx_t: (B, H, 4, hd), the token's input projection; carry: (c, n, m, h),
    (B, H, hd) float32 each."""
    c, n, m, h = carry
    B, H, hd = c.shape
    rh = torch.bmm(h.transpose(0, 1), r).transpose(0, 1)  # (B,H,4hd)
    pre = wx_t + rh.reshape(B, H, 4, hd) + b
    i_r, f_r, z_r, o_r = pre.unbind(2)
    zt = torch.tanh(z_r)
    ot = torch.sigmoid(o_r)
    fm = F.logsigmoid(f_r) + m
    m_new = torch.maximum(fm, i_r)
    ef = torch.exp(fm - m_new)
    ei = torch.exp(i_r - m_new)
    c_new = ef * c + ei * zt
    n_new = ef * n + ei
    h_new = ot * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, m_new, h_new)


def _slstm_consts(p):
    H, hd, _ = p["r"].shape
    return (p["r"].to(torch.float32),
            p["b"].reshape(4, H, hd).transpose(0, 1))


def _slstm_out(p, hs, x_dtype, use_kernel):
    y = hs.to(x_dtype)
    y = _gated_rmsnorm(y, torch.ones_like(y), p["norm_scale"], use_kernel)
    return y @ p["out_proj"]


def slstm_forward(p, cfg: ArchConfig, x, return_state=False,
                  use_kernel=True):
    d, H, hd = _slstm_dims(cfg)
    B, T, _ = x.shape
    wx = _slstm_inputs(p, x)
    r, b = _slstm_consts(p)
    z = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    carry = (z, z, torch.full_like(z, -1e9), z)
    hs = []
    for t in range(T):
        carry = _slstm_cell(r, b, wx[t], carry)
        hs.append(carry[3])
    out = _slstm_out(p, torch.stack(hs, dim=1).reshape(B, T, d), x.dtype,
                     use_kernel)
    if return_state:
        return out, carry
    return out


@dataclasses.dataclass
class SLSTMState:
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def init_slstm_state(cfg: ArchConfig, batch, dtype, device="cpu"):
    d, H, hd = _slstm_dims(cfg)
    z = torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z.clone(), m=torch.full_like(z, -1e9),
                      h=z.clone())


def slstm_step(p, cfg: ArchConfig, x, state: SLSTMState, use_kernel=True):
    d, H, hd = _slstm_dims(cfg)
    B = x.shape[0]
    r, b = _slstm_consts(p)
    carry = _slstm_cell(r, b, _slstm_inputs(p, x)[0],
                        (state.c, state.n, state.m, state.h))
    out = _slstm_out(p, carry[3].reshape(B, 1, d), x.dtype, use_kernel)
    return out, SLSTMState(*carry)
