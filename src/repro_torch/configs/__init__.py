"""Assigned-architecture registry: --arch <id> -> ArchConfig.

The port's copy of ``repro.configs``: pure Python, byte for byte the
reference's modules apart from this docstring, with the whole
``REGISTRY``. The port builds, prefills and decodes every family.
"""

from .base import SHAPES, ArchConfig, MoEConfig, SSMConfig, ShapeConfig, \
    shape_applicable
from . import (deepseek_67b, gemma3_1b, granite_moe_3b_a800m, internlm2_20b,
               mamba2_780m, qwen2_5_3b, qwen2_vl_7b, qwen3_moe_235b_a22b,
               whisper_small, zamba2_2_7b)

REGISTRY = {
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "deepseek-67b": deepseek_67b.CONFIG,
    "gemma3-1b": gemma3_1b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "zamba2-2.7b": zamba2_2_7b.CONFIG,
    "whisper-small": whisper_small.CONFIG,
    "qwen2-vl-7b": qwen2_vl_7b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ArchConfig", "MoEConfig", "REGISTRY", "SHAPES", "SSMConfig",
           "ShapeConfig", "get_config", "shape_applicable"]
