"""Registry of assigned architectures (public pool); the port's copy of
``repro/configs/registry.py``."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, InputShape

_ARCH_MODULES = [
    "qwen1_5_110b",
    "gemma3_1b",
    "arctic_480b",
    "qwen2_vl_72b",
    "qwen2_5_3b",
    "xlstm_350m",
    "deepseek_v2_236b",
    "zamba2_1_2b",
    "whisper_small",
    "phi3_mini_3_8b",
]

_CACHE: Dict[str, ArchConfig] = {}


# canonical ids as assigned
ARCH_IDS = [
    "qwen1.5-110b",
    "gemma3-1b",
    "arctic-480b",
    "qwen2-vl-72b",
    "qwen2.5-3b",
    "xlstm-350m",
    "deepseek-v2-236b",
    "zamba2-1.2b",
    "whisper-small",
    "phi3-mini-3.8b",
]

_ID_TO_MODULE = dict(zip(ARCH_IDS, _ARCH_MODULES))


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _CACHE:
        if arch_id not in _ID_TO_MODULE:
            raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
        mod = importlib.import_module(
            f"repro_torch.configs.{_ID_TO_MODULE[arch_id]}")
        _CACHE[arch_id] = mod.CONFIG
    return _CACHE[arch_id]


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


# ---------------------------------------------------------------------------
# Applicability matrix: which (arch, shape) pairs run.  decode shapes lower
# serve_step; long_500k needs sub-quadratic attention (see DESIGN.md).
# ---------------------------------------------------------------------------

_LONG_OK = {"xlstm-350m", "zamba2-1.2b", "gemma3-1b", "qwen2.5-3b"}
# qwen2.5-3b runs long_500k through its sliding-window variant flag.


def pair_supported(arch_id: str, shape_name: str) -> tuple[bool, str]:
    """(supported, reason-if-skipped)."""
    if shape_name == "long_500k" and arch_id not in _LONG_OK:
        return False, ("pure full-attention arch: 500k decode would be a "
                       "quadratic-attention port; skipped per DESIGN.md")
    return True, ""


def supported_pairs():
    out = []
    for a in ARCH_IDS:
        for s in INPUT_SHAPES:
            ok, _ = pair_supported(a, s)
            if ok:
                out.append((a, s))
    return out
