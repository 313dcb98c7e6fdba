"""Architecture configs — one module per assigned architecture.

``get_config(arch_id)`` returns the exact published configuration;
``get_config(arch_id, reduced=True)`` the same-family CPU smoke config.
The reference's ``configs/env.py`` sets jax and ``XLA_FLAGS`` and has no
counterpart here.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = (
    "zamba2-7b", "internvl2-76b", "qwen3-14b", "yi-9b", "gemma2-27b",
    "nemotron-4-340b", "xlstm-125m", "whisper-tiny", "olmoe-1b-7b",
    "qwen2-moe-a2.7b",
)

_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "internvl2-76b": "internvl2_76b",
    "qwen3-14b": "qwen3_14b",
    "yi-9b": "yi_9b",
    "gemma2-27b": "gemma2_27b",
    "nemotron-4-340b": "nemotron4_340b",
    "xlstm-125m": "xlstm_125m",
    "whisper-tiny": "whisper_tiny",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
}


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __name__)
    cfg = mod.config()
    return cfg.reduced() if reduced else cfg


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
