"""Kernel backend dispatch (mirrors ``repro/kernels/dispatch.py``; the
update backend is the port's own: the JAX trainer never calls its fused
kernel).

Packed matmul backends (``set_packed_backend``):

  'kernel' — the hand-written CUDA ``fixedpoint_matmul`` (its experts form,
             ``fixedpoint_matmul_experts``, for a per-expert MoE stack):
             packed words are read once from device memory and unpacked
             next to the FMA.
  'unpack' — dequantize-then-matmul in plain torch (the reference; exact,
             since mantissa × 2^-f is exact).

Attention backends (``set_attention_backend``):

  'fused'    — the CUDA ``paged_attention`` kernel (``paged_attention_mla``
               for MLA's absorbed decode): the block-table walk runs inside
               the online-softmax loop (float, KV_F int8 and SYMOG int8 /
               int4 pools, dequantized on load).
  'composed' — paged_gather → mask → dense softmax attention in torch.

Optimizer-update backends (``set_update_backend``), read by
``train.make_train_step``:

  'fused'    — one ``symog_update`` per quantizable leaf: the CUDA kernel for
               CUDA tensors (its plain version for CPU tensors); only for
               the paper's optimizer (``optim.sgd`` Nesterov, no decay, fp32
               momentum, nothing chained) with SYMOG clipping on;
  'composed' — the JAX trainer's order in torch: reg grad, ``tx.update``,
               ``apply_updates``, ``clip_tree``.

All default to 'auto', resolved per device: the kernels for CUDA tensors,
the plain paths for CPU tensors ('auto' takes 'composed' for an optimizer
the fused kernel does not compute).  ``ServeEngine`` pins the resolved
values at construction and restores the globals around each call;
``make_train_step`` pins the update backend when it is made.
"""
from __future__ import annotations

import torch

PACKED_BACKENDS = ("auto", "kernel", "unpack")
ATTN_BACKENDS = ("auto", "fused", "composed")
UPDATE_BACKENDS = ("auto", "fused", "composed")

_packed_backend = "auto"
_attn_backend = "auto"
_update_backend = "auto"


def _check(name: str, options) -> str:
    if name not in options:
        raise ValueError(f"backend must be one of {options}, got {name!r}")
    return name


def set_packed_backend(name: str) -> None:
    global _packed_backend
    _packed_backend = _check(name, PACKED_BACKENDS)


def get_packed_backend() -> str:
    return _packed_backend


def resolve_packed_backend(device) -> str:
    """'auto' → 'kernel' for a CUDA device, 'unpack' elsewhere."""
    if _packed_backend != "auto":
        return _packed_backend
    return "kernel" if torch.device(device).type == "cuda" else "unpack"


def set_attention_backend(name: str) -> None:
    global _attn_backend
    _attn_backend = _check(name, ATTN_BACKENDS)


def get_attention_backend() -> str:
    return _attn_backend


def resolve_attention_backend(device) -> str:
    """'auto' → 'fused' for a CUDA device, 'composed' elsewhere."""
    if _attn_backend != "auto":
        return _attn_backend
    return "fused" if torch.device(device).type == "cuda" else "composed"


def set_update_backend(name: str) -> None:
    global _update_backend
    _update_backend = _check(name, UPDATE_BACKENDS)


def get_update_backend() -> str:
    return _update_backend


def resolve_update_backend(device, backend: str = None) -> str:
    """'auto' → 'fused' for a CUDA device, 'composed' elsewhere."""
    backend = _update_backend if backend is None else backend
    if backend != "auto":
        return backend
    return "fused" if torch.device(device).type == "cuda" else "composed"
