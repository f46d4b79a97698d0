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
values at construction and sets them around each call;
``make_train_step`` pins the update backend when it is made.

The settings are per thread (``threading.local``), each thread starting
from 'auto': an engine stepping on a worker thread (the async front end)
cannot switch the route of another engine stepping on another thread.
"""
from __future__ import annotations

import threading

import torch

PACKED_BACKENDS = ("auto", "kernel", "unpack")
ATTN_BACKENDS = ("auto", "fused", "composed")
UPDATE_BACKENDS = ("auto", "fused", "composed")



class _Backends(threading.local):
    """This thread's backend names; every thread starts at 'auto'."""

    packed = "auto"
    attn = "auto"
    update = "auto"


_local = _Backends()


def _check(name: str, options) -> str:
    if name not in options:
        raise ValueError(f"backend must be one of {options}, got {name!r}")
    return name


def set_packed_backend(name: str) -> None:
    _local.packed = _check(name, PACKED_BACKENDS)


def get_packed_backend() -> str:
    return _local.packed


def resolve_packed_backend(device) -> str:
    """'auto' → 'kernel' for a CUDA device, 'unpack' elsewhere."""
    if _local.packed != "auto":
        return _local.packed
    return "kernel" if torch.device(device).type == "cuda" else "unpack"


def set_attention_backend(name: str) -> None:
    _local.attn = _check(name, ATTN_BACKENDS)


def get_attention_backend() -> str:
    return _local.attn


def resolve_attention_backend(device) -> str:
    """'auto' → 'fused' for a CUDA device, 'composed' elsewhere."""
    if _local.attn != "auto":
        return _local.attn
    return "fused" if torch.device(device).type == "cuda" else "composed"


def set_update_backend(name: str) -> None:
    _local.update = _check(name, UPDATE_BACKENDS)


def get_update_backend() -> str:
    return _local.update


def resolve_update_backend(device, backend: str = None) -> str:
    """'auto' → 'fused' for a CUDA device, 'composed' elsewhere."""
    backend = _local.update if backend is None else backend
    if backend != "auto":
        return backend
    return "fused" if torch.device(device).type == "cuda" else "composed"
