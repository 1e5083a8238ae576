"""Architecture registry: ``get`` / ``get_reduced`` by architecture id.

Other architectures join as their families are ported (ROADMAP (a)4,
other families)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
}

ARCH_IDS: List[str] = list(_MODULES.keys())


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get(arch_id: str, dtype: str = "bfloat16") -> ModelConfig:
    return _mod(arch_id).config(dtype=dtype)


def get_reduced(arch_id: str, dtype: str = "float32") -> ModelConfig:
    return _mod(arch_id).reduced(dtype=dtype)
