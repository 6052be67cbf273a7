"""Architecture registry: ``get_config(name)`` / ``list_archs()``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    reduce_config,
    supported_shapes,
)

_ARCH_MODULES = {
    "starcoder2-15b": "starcoder2_15b",
    "granite-34b": "granite_34b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "whisper-medium": "whisper_medium",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "chameleon-34b": "chameleon_34b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def list_archs() -> tuple:
    return tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
