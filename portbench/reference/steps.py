"""The reference's training steps and the readings a run is judged by.

:func:`loss_and_grads` is one forward and backward pass of :mod:`.lm`
over a batch, layer by layer: the forward pass keeps each layer's input,
and the backward pass recomputes one layer at a time, over as many rows
of the batch at once as keep its float32 attention scores (or logits)
within ``PASS_BYTES`` (``MAMBA_ROWS`` for a Mamba2 layer), so a layer's
float32 weights, gradients and scores are the only large transients.
As each leaf's gradient (or one stacked layer's slice of it) is complete
it goes to a *sink*:
:class:`GradTree` keeps it, :class:`AdamW` applies it at once, so a sync
step never holds a whole float32 gradient.

Readings of the first steps (a cell's ``checked_steps``) from one set
of weights and as many batches:

  sync    the loss of each step, each leaf's gradient norm at step 1 (as
          the optimizer gets it), each leaf's change after the last step
  gossip  the loss of each step (the replicas' mean), each leaf's gradient
          norm at step 1, each leaf's change of ``params`` and of ``y``
          after the last step
"""

from __future__ import annotations

import math

import torch

from . import gossip as G
from . import lm
from .trees import get, leaves, tmap

#: elements summed at once by :func:`norm` and :func:`change_norms`
SLICE = 1 << 26


def _f32(tree, grad):
    return tmap(lambda x: x.detach().float().requires_grad_(grad), tree)


def _layer_of(seg, j):
    return tmap(lambda x: x[j], seg)


def plan(cfg):
    """[(kind, segment, index in segment)] per layer."""
    out = []
    for si, (kind, n) in enumerate(lm.segments(cfg)):
        out += [(kind, si, j) for j in range(n)]
    return out


#: bytes of float32 attention scores (or logits) one pass may hold; a
#: Mamba2 layer takes ``MAMBA_ROWS`` rows at once
PASS_BYTES = 4.5e9
MAMBA_ROWS = 2


def _row_groups(kind, B, T, cfg):
    """Slices of the batch's rows that one pass of a layer takes."""
    if kind == "mamba2":
        n = MAMBA_ROWS
    elif kind == "head":
        n = int(PASS_BYTES // (3 * T * cfg["vocab_size"] * 4))
    else:
        n = int(PASS_BYTES // (cfg["num_heads"] * T * T * 4))
    n = max(1, min(B, n))
    return [slice(r, min(r + n, B)) for r in range(0, B, n)]


def loss_and_grads(params, tokens, labels, cfg, ar, sink):
    """Mean cross-entropy of the batch (float64) and every gradient into
    ``sink(path, index, grad)`` (``index``: the layer within a stacked
    leaf, or None for a whole leaf)."""
    B, T = tokens.shape
    count = (labels >= 0).sum().clamp_min(1).float()
    tied = bool(cfg.get("tie_embeddings"))
    h0 = params["embed"]["table"][tokens].float()
    layers = plan(cfg)
    shared = params.get("shared_attn")
    shared_w = _f32(shared, True) if shared is not None else None
    hs = [h0]
    with torch.no_grad():
        h = h0
        for kind, si, j in layers:
            p = _f32(_layer_of(params["segments"][si], j), False)
            h = torch.cat([lm.layer(kind, p, shared_w, h[r], h0[r], cfg,
                                    ar)
                           for r in _row_groups(kind, B, T, cfg)])
            hs.append(h)
    fs = params["final_norm"]["scale"].detach().float().requires_grad_()
    wh = (params["embed"]["table"] if tied else params["lm_head"])
    wh = wh.detach().float().requires_grad_()
    dh = torch.empty_like(h0)
    loss = torch.zeros((), dtype=torch.float64, device=h0.device)
    g_fs, g_wh = torch.zeros_like(fs), torch.zeros_like(wh)
    for r in _row_groups("head", B, T, cfg):
        hr = hs[-1][r].detach().requires_grad_()
        s = lm.head_loss_sum(hr, fs, wh, labels[r], cfg, ar, tied) / count
        a, b, c = torch.autograd.grad(s, [hr, fs, wh])
        dh[r] = a
        g_fs += b
        g_wh += c
        loss += s.detach().double()
    hs[-1] = None
    sink("final_norm/scale", None, g_fs)
    if not tied:
        sink("lm_head", None, g_wh)
    sh_leaves = leaves(shared_w) if shared is not None else []
    g_sh = [torch.zeros_like(x) for _, x in sh_leaves]
    dh0 = torch.zeros_like(h0) if shared is not None else None
    for idx in reversed(range(len(layers))):
        kind, si, j = layers[idx]
        p = _f32(_layer_of(params["segments"][si], j), True)
        own = leaves(p)
        acc = [torch.zeros_like(x) for _, x in own]
        for r in _row_groups(kind, B, T, cfg):
            hin = hs[idx][r].detach().requires_grad_()
            ins = [hin] + [x for _, x in own]
            h0r = None
            if kind == "shared_attn":
                h0r = h0[r].detach().requires_grad_()
                ins += [h0r] + [x for _, x in sh_leaves]
            out = lm.layer(kind, p, shared_w, hin, h0r, cfg, ar)
            gs = torch.autograd.grad(out, ins, dh[r], allow_unused=True)
            dh[r] = gs[0]
            for a, g in zip(acc, gs[1:1 + len(own)]):
                if g is not None:
                    a += g
            if kind == "shared_attn":
                dh0[r] += gs[1 + len(own)]
                for a, g in zip(g_sh, gs[2 + len(own):]):
                    if g is not None:
                        a += g
        hs[idx + 1] = None
        for (path, _), g in zip(own, acc):
            sink(f"segments/{si}/{path}", j, g)
    for (path, _), g in zip(sh_leaves, g_sh):
        sink(f"shared_attn/{path}", None, g)
    gt = torch.zeros(params["embed"]["table"].shape, dtype=torch.float32,
                     device=h0.device)
    d = h0.shape[-1]
    gt.index_add_(0, tokens.reshape(-1),
                  (dh if dh0 is None else dh + dh0).reshape(-1, d))
    if tied:
        gt += g_wh
    sink("embed/table", None, gt)
    return loss


class GradTree:
    """Sink that keeps every gradient, float32, in a tree shaped as the
    weights; ``sumsq`` holds each leaf's squared norm."""

    def __init__(self, params):
        self.tree = tmap(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device), params)
        self.sumsq = {}

    def __call__(self, path, j, g):
        dst = get(self.tree, path)
        (dst if j is None else dst[j]).copy_(g)
        self.sumsq[path] = self.sumsq.get(path, 0.0) + float(
            g.double().square().sum())


class AdamW:
    """AdamW with decoupled weight decay on every leaf of two or more
    dimensions (a stacked leaf counts its layer axis), float32 moments,
    the new weights rounded to their stored type; as a sink it updates
    each gradient's slice of the weights as it arrives."""

    def __init__(self, params, lr, b1, b2, eps, weight_decay):
        self.params, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.m = tmap(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device), params)
        self.v = tmap(torch.zeros_like, self.m)
        self.count = 0
        self.sumsq = {}

    def begin(self):
        self.count += 1
        self.sumsq = {}
        dev = leaves(self.params)[0][1].device
        c = torch.tensor(float(self.count), dtype=torch.float32, device=dev)
        self.bc1 = 1.0 - self.b1 ** c
        self.bc2 = 1.0 - self.b2 ** c

    def __call__(self, path, j, g):
        self.sumsq[path] = self.sumsq.get(path, 0.0) + float(
            g.double().square().sum())
        full = get(self.params, path)
        decay = full.dim() >= 2
        p, m, v = (x if j is None else x[j]
                   for x in (full, get(self.m, path), get(self.v, path)))
        with torch.no_grad():
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            step = (m / self.bc1) / (torch.sqrt(v / self.bc2) + self.eps)
            pf = p.float()
            if decay:
                step = step + self.wd * pf
            p.copy_((pf - self.lr * step).to(p.dtype))


def _norms(sumsq):
    return {k: v ** 0.5 for k, v in sumsq.items()}


def norm(t):
    """||t|| summed in float64, in slices."""
    f = t.reshape(-1)
    return math.fsum(float(f[i:i + SLICE].double().square().sum())
                     for i in range(0, f.numel(), SLICE)) ** 0.5


def change_norms(now, start):
    """Each leaf's ||now - start||; a leaf of ``now`` with one more axis
    (stacked replicas) is compared replica by replica with ``start``."""
    out = {}
    for (path, a), (p2, b) in zip(leaves(now), leaves(start)):
        if path != p2:
            raise ValueError(f"trees differ: {path} against {p2}")
        rows = a if a.dim() > b.dim() else a[None]
        fb = b.reshape(-1)
        tot = []
        for r in range(rows.shape[0]):
            fa = rows[r].reshape(-1)
            tot += [float((fa[i:i + SLICE].double()
                           - fb[i:i + SLICE].double()).square().sum())
                    for i in range(0, fa.numel(), SLICE)]
        out[path] = math.fsum(tot) ** 0.5
    return out


def run_sync(params, batches, cfg, traffic, ar):
    """AdamW steps of the reference from ``params`` (updated in place),
    one on each of ``batches`` [(tokens, labels)]: the readings."""
    opt = AdamW(params, traffic["lr"], **traffic["adamw"])
    losses, g1 = [], None
    for tokens, labels in batches:
        opt.begin()
        losses.append(float(loss_and_grads(params, tokens, labels, cfg, ar,
                                           opt)))
        if g1 is None:
            g1 = _norms(opt.sumsq)
    return {"loss": losses, "grad_norm": g1}


def run_gossip(xs, ys, batches, cfg, traffic, ar, ring=True):
    """ECD-PSGD steps of the reference, one a batch, on replicas stacked in
    ``xs`` and ``ys`` (updated in place): the readings.  ``ring=False``
    leaves the exchange out (a fault the comparison must catch)."""
    R = traffic["replicas"]
    losses, g1 = [], None
    for step, (tokens, labels) in enumerate(batches):
        rows = tokens.shape[0] // R
        grads, sumsq, total = [], {}, 0.0
        for r in range(R):
            one = tmap(lambda x: x[r], xs)
            sink = GradTree(one)
            sl = slice(r * rows, (r + 1) * rows)
            total += float(loss_and_grads(one, tokens[sl], labels[sl], cfg,
                                          ar, sink))
            grads.append(sink.tree)
            for k, v in sink.sumsq.items():
                sumsq[k] = sumsq.get(k, 0.0) + v
        losses.append(total / R)
        if g1 is None:
            g1 = _norms(sumsq)
        G.exchange(xs, ys, grads, step, traffic, ring)
        del grads
    return {"loss": losses, "grad_norm": g1}
