"""The ``lm`` reference kind (see :mod:`portbench.harness.kinds`; its
FLOPs: :mod:`portbench.counts.lm`).

Plain float32 reference of the decoder language models the benchmark
trains: a dense decoder (RMSNorm, causal multi-head attention with RoPE,
SwiGLU) and Zamba2's hybrid stack (Mamba2 blocks and one shared attention
block applied at several depths, arXiv:2411.15242).  It reads its sizes
from the benchmark's configuration file (a dict) and its weights from a
tree laid out as the repository's JAX package lays out its parameters:

  embed/table (V, d)            final_norm/scale (d,)     lm_head (d, V)
  shared_attn/{w_concat (2d, d), attn/{wq, wk, wv, wo}, norm2/scale,
               mlp/{wi_gate, wi_up, wo}}       (when a layer shares it)
  segments[i]: one dict per run of layers of one kind, every leaf with
               the run's layers stacked on a leading axis:
    attn         norm1/scale, attn/{wq, wk, wv, wo}, norm2/scale,
                 mlp/{wi_gate, wi_up, wo}
    mamba2       norm1/scale, block/{in_proj, conv_w, conv_b, a_log,
                 dt_bias, d_skip, out_proj, norm_scale}
    shared_attn  norm1/scale, down (d, d)

Weights may be stored in any type: every use reads them as float32.
Matrix products and the activations between layers' operations run
through :class:`Arith`, whose ``fp8=True`` form rounds them to float8
e4m3 (one scale per tensor) wherever the program keeps bfloat16: both
operands and the result of every product, norm outputs, the residual
stream, the SSM's output and the MLP's hidden layer.  That is the
lower-precision control of the benchmark's comparison.

The equations, per layer (h the residual stream, h0 the embedding):

  attn         h += Attn(N1 h);  h += MLP(N2 h)
  mamba2       h += Mamba2(N1 h)
  shared_attn  z = [N1 h, h0] Wc;  z += Attn(z);  z += MLP(N z);
               h += z down

  Attn(x)   q, k, v = x Wq, x Wk, x Wv; RoPE on q, k (half split);
            softmax(q k^T / sqrt(hd), causal) v; then Wo
  MLP(x)    (silu(x Wg) * x Wu) Wo
  Mamba2(x) [z, xBC, dt] = x Win; xBC = silu(causal depthwise conv);
            [xs, B, C] = xBC; dt = softplus(dt); a = -exp(a_log);
            y_t = sum_{s<=t} exp(sum_{s<r<=t} a dt_r) (C_t . B_s) dt_s x_s
                  + D x_t;
            out = RMSNorm(y * silu(z)) Wout

The sequence sum of Mamba2 is taken over blocks of 256 rows (the
program's chunks are 128) with the running sums of ``a dt`` in
float64.  The loss is the mean
next-token cross-entropy over every label that is not negative.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F8 = torch.float8_e4m3fn
F8_MAX = 448.0
#: rows of one block of the Mamba2 sequence sum
SSD_ROWS = 256


def layer_kinds(cfg):
    pattern = cfg.get("layer_pattern") or ["attn"]
    return [pattern[i % len(pattern)] for i in range(cfg["num_layers"])]


def segments(cfg):
    """[(kind, layers)] runs of one kind, in order."""
    out = []
    for kind in layer_kinds(cfg):
        if out and out[-1][0] == kind:
            out[-1][1] += 1
        else:
            out.append([kind, 1])
    return [tuple(s) for s in out]


def mamba_dims(cfg):
    s = cfg["ssm"]
    inner = s["expand"] * cfg["d_model"]
    hd = s["head_dim"]
    return inner, inner // hd, hd, s["state_dim"], s["conv_width"]


def head_dim(cfg):
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def program_sizes(cfg):
    """{attribute path of the port's ``ArchConfig``: the configuration
    file's value}, checked at every run."""
    out = {"num_layers": cfg["num_layers"], "d_model": cfg["d_model"],
           "num_heads": cfg["num_heads"],
           "num_kv_heads": cfg["num_kv_heads"],
           "resolved_head_dim": cfg["head_dim"], "d_ff": cfg["d_ff"],
           "vocab_size": cfg["vocab_size"], "rope_theta": cfg["rope_theta"],
           "dtype": cfg["dtype"], "tie_embeddings": cfg["tie_embeddings"]}
    if "ssm" in cfg:
        out.update({f"ssm.{k}": cfg["ssm"][k] for k in
                    ("state_dim", "expand", "conv_width", "chunk_size")})
    return out


def param_specs(cfg):
    """The weight tree's leaves as ``(shape, dtype, init)``: ``init`` is a
    float (normal draws times it), ``"ones"`` or ``"zeros"``."""
    d, V, ff = cfg["d_model"], cfg["vocab_size"], cfg["d_ff"]
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg)
    dt = cfg["dtype"]

    def mat(*shape):
        return (shape, dt, 1.0 / math.sqrt(shape[-2]))

    def attn(*n):
        return {"wq": mat(*n, d, H * hd), "wk": mat(*n, d, KV * hd),
                "wv": mat(*n, d, KV * hd), "wo": mat(*n, H * hd, d)}

    def mlp(*n):
        return {"wi_gate": mat(*n, d, ff), "wi_up": mat(*n, d, ff),
                "wo": mat(*n, ff, d)}

    def norm(*n):
        return {"scale": ((*n, d), dt, "ones")}

    tree = {"embed": {"table": ((V, d), dt, 0.02)}, "final_norm": norm()}
    if not cfg.get("tie_embeddings"):
        tree["lm_head"] = mat(d, V)
    kinds = set(layer_kinds(cfg))
    if "shared_attn" in kinds:
        tree["shared_attn"] = {"w_concat": mat(2 * d, d), "attn": attn(),
                               "norm2": norm(), "mlp": mlp()}
    segs = []
    for kind, n in segments(cfg):
        if kind == "attn":
            segs.append({"norm1": norm(n), "attn": attn(n),
                         "norm2": norm(n), "mlp": mlp(n)})
        elif kind == "mamba2":
            inner, Hm, _, N, W = mamba_dims(cfg)
            ch = inner + 2 * N
            segs.append({"norm1": norm(n), "block": {
                "in_proj": mat(n, d, 2 * inner + 2 * N + Hm),
                "conv_w": ((n, W, ch), dt, 0.5),
                "conv_b": ((n, ch), dt, "zeros"),
                "a_log": ((n, Hm), "float32", "zeros"),
                "dt_bias": ((n, Hm), "float32", "zeros"),
                "d_skip": ((n, Hm), "float32", "ones"),
                "out_proj": mat(n, inner, d),
                "norm_scale": ((n, inner), dt, "ones")}})
        elif kind == "shared_attn":
            segs.append({"norm1": norm(n), "down": mat(n, d, d)})
        else:
            raise ValueError(f"layer kind {kind!r} has no reference")
    tree["segments"] = segs
    return tree


class Arith:
    """The reference's precision: float32, or with every product's
    operands and result and every stored activation rounded to float8
    e4m3 at one scale per tensor (``fp8=True``; the rounding passes the
    gradient straight through)."""

    def __init__(self, fp8=False):
        self.fp8 = fp8

    def q(self, t):
        if not self.fp8:
            return t
        s = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
        r = (t.detach() / s).to(F8).to(torch.float32) * s
        return t + (r - t).detach()

    def mm(self, x, w):
        return self.q(self.q(x) @ self.q(w))


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, T, heads, hd): rotary embedding at positions 0..T-1, the
    head's two halves rotated together."""
    T, hd = x.shape[1], x.shape[-1]
    inv = theta ** -(torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(torch.float32)[None, :, None]
    sin = torch.sin(ang).to(torch.float32)[None, :, None]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], -1)


def attention(p, x, cfg, ar):
    B, T, _ = x.shape
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg)
    q = rope(ar.mm(x, p["wq"]).view(B, T, H, hd), cfg["rope_theta"])
    k = rope(ar.mm(x, p["wk"]).view(B, T, KV, hd), cfg["rope_theta"])
    v = ar.mm(x, p["wv"]).view(B, T, KV, hd)
    if KV != H:
        k = k.repeat_interleave(H // KV, 2)
        v = v.repeat_interleave(H // KV, 2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, T, hd)
    s = ar.q(q) @ ar.q(k).transpose(-1, -2) / math.sqrt(hd)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(s.masked_fill(~mask, -math.inf), -1)
    o = (ar.q(w) @ ar.q(v)).transpose(1, 2).reshape(B, T, H * hd)
    return ar.mm(o, p["wo"])


def mlp(p, x, ar):
    return ar.mm(ar.q(F.silu(ar.mm(x, p["wi_gate"]))
                      * ar.mm(x, p["wi_up"])), p["wo"])


def ssd(xs, dt, a, Bm, Cm):
    """y_t = sum_{s<=t} exp(sum_{s<r<=t} a dt_r) (C_t . B_s) dt_s x_s.
    xs (B, T, H, hd), dt (B, T, H), a (H,), Bm, Cm (B, T, N).

    Blocks of ``SSD_ROWS`` rows: within a block the sum is taken directly
    (the causal (rows x rows) decay matrix); the earlier blocks enter
    through the state at the block's start, S = sum_{s<lo} exp(sum_{s<r<lo}
    a dt_r) dt_s x_s B_s^T, carried from block to block.  The running
    sums of ``a dt`` are float64, taken from the block's start before
    they are rounded to float32."""
    Bsz, T, H, hd = xs.shape
    cum = torch.cumsum((dt * a).double(), 1)                  # (B, T, H)
    xdt = xs * dt[..., None]
    S = xs.new_zeros(Bsz, H, hd, Bm.shape[-1])
    out = []
    for lo in range(0, T, SSD_ROWS):
        hi = min(lo + SSD_ROWS, T)
        prev = cum[:, lo - 1:lo] if lo else torch.zeros_like(cum[:, :1])
        c = (cum[:, lo:hi] - prev).float()                    # (B, Q, H)
        rel = c[:, :, None] - c[:, None]                      # (B, Q, Q, H)
        keep = torch.ones(hi - lo, hi - lo, dtype=torch.bool,
                          device=xs.device).tril()
        decay = torch.exp(rel.masked_fill(~keep[None, :, :, None],
                                          -math.inf))
        g = Cm[:, lo:hi] @ Bm[:, lo:hi].transpose(-1, -2)    # (B, Q, Q)
        y = torch.einsum("bqsh,bshd->bqhd", decay * g[..., None],
                         xdt[:, lo:hi])
        y = y + torch.einsum("bqn,bhdn->bqhd", Cm[:, lo:hi], S) \
            * torch.exp(c)[..., None]
        out.append(y)
        to_end = torch.exp(c[:, -1:] - c)                     # (B, Q, H)
        S = torch.exp(c[:, -1])[..., None, None] * S + torch.einsum(
            "bqhd,bqn->bhdn", xdt[:, lo:hi] * to_end[..., None],
            Bm[:, lo:hi])
    return torch.cat(out, 1)


def mamba2(p, x, cfg, ar):
    B, T, _ = x.shape
    inner, H, hd, N, W = mamba_dims(cfg)
    z, xbc, dt = torch.split(ar.mm(x, p["in_proj"]),
                             [inner, inner + 2 * N, H], -1)
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (W - 1, 0)),
                    p["conv_w"].t()[:, None, :], p["conv_b"],
                    groups=xbc.shape[-1])
    xbc = ar.q(F.silu(conv.transpose(1, 2)))
    xs, Bm, Cm = torch.split(xbc, [inner, N, N], -1)
    xs = xs.reshape(B, T, H, hd)
    dt = F.softplus(dt)
    y = ssd(xs, dt, -torch.exp(p["a_log"]), Bm, Cm)
    y = ar.q(y + p["d_skip"][:, None] * xs)
    y = ar.q(y.reshape(B, T, inner) * F.silu(z))
    return ar.mm(ar.q(rmsnorm(y, p["norm_scale"], cfg["rms_norm_eps"])),
                 p["out_proj"])


def layer(kind, p, shared, h, h0, cfg, ar):
    """One layer: ``p`` its own weights (float32), ``shared`` the shared
    block's, ``h0`` the embedding (read by a shared-attention layer)."""
    eps = cfg["rms_norm_eps"]
    x = ar.q(rmsnorm(h, p["norm1"]["scale"], eps))
    if kind == "attn":
        h = ar.q(h + attention(p["attn"], x, cfg, ar))
        return ar.q(h + mlp(p["mlp"], ar.q(rmsnorm(h, p["norm2"]["scale"],
                                                   eps)), ar))
    if kind == "mamba2":
        return ar.q(h + mamba2(p["block"], x, cfg, ar))
    z = ar.mm(torch.cat([x, h0], -1), shared["w_concat"])
    z = ar.q(z + attention(shared["attn"], z, cfg, ar))
    z = ar.q(z + mlp(shared["mlp"], ar.q(rmsnorm(
        z, shared["norm2"]["scale"], eps)), ar))
    return ar.q(h + ar.mm(z, p["down"]))


def head_loss_sum(h, final_scale, w_head, labels, cfg, ar, tied):
    """Sum over the row's labels (>= 0) of the cross-entropy."""
    x = ar.q(rmsnorm(h, final_scale, cfg["rms_norm_eps"]))
    logits = ar.mm(x, w_head.t() if tied else w_head)
    lp = torch.log_softmax(logits, -1)
    keep = labels >= 0
    pick = lp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return (pick * keep).sum().neg()


def run_sync(params, batches, cfg, traffic, ar):
    """AdamW steps of the reference from ``params``, one on each of
    ``batches``: :func:`.steps.run_sync`, which walks these layers."""
    from . import steps     # here: steps imports this module
    return steps.run_sync(params, batches, cfg, traffic, ar)
