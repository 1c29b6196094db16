# Copy of src/repro/configs/registry.py, kept numpy-only; change both copies together.
"""Architecture registry: --arch <id> resolution."""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable  # noqa: F401

_MODULES = {
    "gemma-2b": "gemma_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "granite-3-2b": "granite_3_2b",
    "deepseek-67b": "deepseek_67b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "internvl2-76b": "internvl2_76b",
    "mamba2-780m": "mamba2_780m",
    "whisper-small": "whisper_small",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells():
    """Every (arch, shape) pair with its applicability verdict."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            yield cfg, shape, ok, why
