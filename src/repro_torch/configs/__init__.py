"""Architecture registry: one module per assigned architecture."""

from __future__ import annotations

import importlib
from typing import Dict

from .base import (ModelConfig, ShapeSpec, CodingConfig, TRAIN_4K,
                   PREFILL_32K, DECODE_32K, LONG_500K, ALL_SHAPES)

ARCH_IDS = (
    "qwen1.5-4b",
    "zamba2-1.2b",
    "deepseek-coder-33b",
    "yi-34b",
    "deepseek-moe-16b",
    "llama4-scout-17b-a16e",
    "granite-3-8b",
    "seamless-m4t-large-v2",
    "pixtral-12b",
    "xlstm-1.3b",
)

_MODULES = {
    "qwen1.5-4b": "qwen15_4b",
    "zamba2-1.2b": "zamba2_1p2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-34b": "yi_34b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "granite-3-8b": "granite_3_8b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "pixtral-12b": "pixtral_12b",
    "xlstm-1.3b": "xlstm_1p3b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __name__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ModelConfig", "ShapeSpec", "CodingConfig", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K", "ALL_SHAPES",
           "ARCH_IDS", "get_config", "all_configs"]
