"""Architecture registry: --arch <id> resolution."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, ShapeSpec, SHAPES, reduced,
                                shape_applicable)

_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen1.5-32b": "qwen1_5_32b",
    "stablelm-12b": "stablelm_12b",
    "minicpm3-4b": "minicpm3_4b",
    "gemma3-1b": "gemma3_1b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "musicgen-large": "musicgen_large",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return reduced(get_config(name[: -len("-reduced")]))
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.config()


def list_configs():
    return [get_config(n) for n in ARCH_IDS]


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "get_config",
           "list_configs", "reduced", "shape_applicable"]
