"""Assigned-architecture registry: ``get_config(name)`` / ``--arch <id>``."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "qwen3-0.6b",
    "h2o-danube-1.8b",
    "qwen2-0.5b",
    "gemma3-1b",
    "rwkv6-3b",
    "llama4-scout-17b-a16e",
    "mixtral-8x22b",
    "whisper-base",
    "zamba2-7b",
    "internvl2-2b",
]

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_")
            for name in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(_MODULES[name]).CONFIG
