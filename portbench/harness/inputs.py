"""What a run feeds the program, made from ``--seed`` on the run's device:
the weights (the tree of the ``param_specs`` of the configuration's
reference kind, every normal draw from one ``torch.Generator`` in a few
large calls into one buffer, in the configuration's type) and a pool of
distinct token batches."""

from __future__ import annotations

import math

import torch

from portbench.harness import kinds
from portbench.reference.trees import leaves

#: elements a single normal draw fills
DRAW = 1 << 28


def _seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of the run's inputs."""
    return (int(seed) * 4 + stream) % (1 << 63)


def weights(cfg, seed: int, device):
    """The weight tree for ``cfg`` drawn from ``seed``."""
    specs = kinds.reference(cfg).param_specs(cfg)
    dtype = getattr(torch, cfg["dtype"])
    normal = [(p, s) for p, s in leaves(specs) if not isinstance(s[2], str)]
    total = sum(math.prod(s[0]) for _, s in normal)
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 0))
    for i in range(0, total, DRAW):
        buf[i:i + DRAW].normal_(generator=gen)
    views, off = {}, 0
    for path, (shape, dt, scale) in normal:
        if getattr(torch, dt) != dtype:
            raise ValueError(f"{path}: normal draws come in {dtype}")
        n = math.prod(shape)
        views[path] = buf[off:off + n].view(shape).mul_(scale)
        off += n

    def build(spec, path):
        if isinstance(spec, dict):
            return {k: build(v, f"{path}/{k}" if path else k)
                    for k, v in spec.items()}
        if isinstance(spec, list):
            return [build(v, f"{path}/{i}") for i, v in enumerate(spec)]
        if path in views:
            return views[path]
        shape, dt, init = spec
        fill = torch.ones if init == "ones" else torch.zeros
        return fill(shape, dtype=getattr(torch, dt), device=device)

    return build(specs, "")


def halve(tokens, labels):
    """The batch with its second half of rows replaced by its first (half
    of it left out, the mean over the rest): a fault the checks catch."""
    h = tokens.shape[0] // 2
    return (torch.cat([tokens[:h], tokens[:h]]),
            torch.cat([labels[:h], labels[:h]]))


def batches(traffic, vocab: int, seed: int, device):
    """``traffic["pool"]`` batches of (tokens, labels), int64 (B, S): every
    row's S + 1 ids drawn uniformly from the vocabulary, labels the
    tokens shifted by one."""
    B, S = traffic["batch"], traffic["seq"]
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 1))
    ids = torch.randint(0, vocab, (traffic["pool"], B, S + 1),
                        generator=gen, device=device)
    return [(ids[i, :, :-1].contiguous(), ids[i, :, 1:].contiguous())
            for i in range(traffic["pool"])]
