"""Qwen2-VL's M-RoPE position ids for a prompt that opens with vision
patches (arXiv:2409.12191 §2.1), shared by the CPU and card tests and
chip_smoke.py: this module imports only torch."""

import math

import torch


def grid_positions(batch, seq, vision, device=None):
    """(3, batch, seq) temporal, height and width ids: ``vision`` patches
    of a square grid (t = 0, h = row, w = col), then text that continues
    from the grid's side on all three streams."""
    side = math.isqrt(vision)
    if side * side != vision:
        raise ValueError(f"{vision} patches are not a square grid")
    idx = torch.arange(vision, device=device)
    text = side + torch.arange(seq - vision, device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(idx), text]),
                       torch.cat([idx // side, text]),
                       torch.cat([idx % side, text])])
    return pos[:, None].expand(3, batch, seq).contiguous()
