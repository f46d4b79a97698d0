"""Architecture registry of the port: ``get_config(arch)`` returns the
published config and ``get_reduced(arch)`` a same-family smoke-test
reduction.  The port has the dense decoders internlm2-1.8b (GQA),
gemma2-27b (alternating local / global layers, softcaps, post-norms),
gemma3-4b (5:1 local / global, two rope bases, qk-norm, head_dim 256) and
granite-34b (MQA, a non-gated MLP, an untied head); the MoE decoder
olmoe-1b-7b; deepseek-v3-671b (MLA + MoE with leading dense layers); and
the recurrent families, mamba2-2.7b (SSD) and recurrentgemma-2b (RG-LRU
blocks with local MQA attention, in RRL units); the encoder-decoder
whisper-large-v3 and the image-prefix paligemma-3b."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "gemma2-27b": "gemma2_27b",
    "gemma3-4b": "gemma3_4b",
    "granite-34b": "granite_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-large-v3": "whisper_large_v3",
    "paligemma-3b": "paligemma_3b",
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
