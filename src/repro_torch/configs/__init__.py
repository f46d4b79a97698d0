"""Architecture registry of the port: ``get_config(arch)`` returns the
published config and ``get_reduced(arch)`` a same-family smoke-test
reduction.  The port has the dense decoders internlm2-1.8b (GQA),
gemma2-27b (alternating local / global layers, softcaps, post-norms),
gemma3-4b (5:1 local / global, two rope bases, qk-norm, head_dim 256) and
granite-34b (MQA, a non-gated MLP, an untied head); the MoE decoder
olmoe-1b-7b; deepseek-v3-671b (MLA + MoE with leading dense layers); and
the recurrent families, mamba2-2.7b (SSD) and recurrentgemma-2b (RG-LRU
blocks with local MQA attention, in RRL units); the encoder-decoder
whisper-large-v3 and the image-prefix paligemma-3b.

The shape cells are the JAX package's: ``SHAPES`` (``train_4k``,
``prefill_32k``, ``decode_32k``, ``long_500k``), ``cell_supported`` (its
skip rule and reason text) and ``input_specs(cfg, shape)``, every input of
a cell's step as a tensor on the ``meta`` device (shape and dtype, no
storage: torch's idiom for JAX's ``ShapeDtypeStruct``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import torch

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


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(supported, reason-if-not) per the assignment's skip rules."""
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.supports_long:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} has unbounded full-attention KV (see DESIGN.md §5)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """``meta`` tensors for the cell's step function inputs (global shapes).

    train:   {'tokens': (B,S) int32 [, 'frames'/'patches' (B, L, D) fp32]}
    prefill: same as train (no labels needed — loss-free path)
    decode:  {'tokens': (B,1) int32, 'pos': () int32, 'caches': <tree>}
    """
    cell = SHAPES[shape]
    B, S = cell.batch, cell.seq

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    def frontend(specs, batch):
        if cfg.family == "encdec":
            specs["frames"] = meta((batch, cfg.encoder_len, cfg.d_model), torch.float32)
        if cfg.family == "vlm":
            specs["patches"] = meta((batch, cfg.prefix_len, cfg.d_model), torch.float32)
        return specs

    if cell.kind in ("train", "prefill"):
        return frontend({"tokens": meta((B, S), torch.int32)}, B)

    # decode: one new token against a seq-long cache
    from repro_torch.models.lm import init_caches

    specs = frontend({"tokens": meta((B, 1), torch.int32), "pos": meta((), torch.int32)}, B)
    specs["caches"] = init_caches(cfg, B, S, device="meta")
    return specs
