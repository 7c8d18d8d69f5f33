"""Architecture registry of the port: ``get_config(name)`` /
``list_archs()``.  Holds the configurations whose layers the port runs;
the others of ``repro/configs`` come with their slices (ROADMAP)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    LayerSpec,
    make_reduced,
)

_MODULES = {
    "gemma2-27b": "gemma2_27b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen3-4b": "qwen3_4b",
    "granite-8b": "granite_8b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}


def list_archs():
    return sorted(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
