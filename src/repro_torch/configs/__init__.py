"""Architecture registry of the port: ``get_config(arch)`` returns the
published config and ``get_reduced(arch)`` a same-family smoke-test
reduction.  The port has internlm2-1.8b (dense GQA) and olmoe-1b-7b (MoE)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED
