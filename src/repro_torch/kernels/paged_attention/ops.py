"""Public wrapper: fused paged GQA/MQA attention for decode / verify /
tail prefill.

``paged_attention`` launches the CUDA kernel (``csrc/paged_attention.cu``)
for CUDA tensors and runs its plain version (``ref.py``) for CPU tensors.
Queries must be contiguous per row: q_pos[b, t] = pos0[b] + t.
``window=None`` maps onto the 2^30 sentinel; ``kv_scale`` is 2^-KV_F for
int8 fixed-point pools and 1.0 for float pools.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_NO_WINDOW = 2**30  # models.config.GLOBAL_WINDOW
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
launches = 0  # kernel launches (plain-version calls on the CPU do not count)


def _n_split(B: int, K: int, row_tiles: int, max_blocks: int, n_sm: int) -> int:
    """KV splits per (b, kv_head, row tile): ~4 thread blocks per SM."""
    base = B * K * row_tiles
    return max(1, min(max_blocks, math.ceil(4 * n_sm / base)))


def _launch(q, k_pool, v_pool, block_tables, pos0, *, scale, cap, window, kv_scale):
    global launches
    dev = q.device
    B, T, K, G, hd = q.shape
    nb, block = k_pool.shape[:2]
    q_code, kv_code = _Q_CODE.get(q.dtype), _KV_CODE.get(k_pool.dtype)
    if q_code is None:
        raise TypeError(f"paged_attention kernel takes f32/bf16 q, got {q.dtype}")
    if kv_code is None or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share a f32/bf16/int8 dtype, got {k_pool.dtype}/{v_pool.dtype}")
    want = (nb, block, K, hd)
    if k_pool.shape != want or v_pool.shape != want:
        raise ValueError(f"pools must be {want}, got {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (a layer's slice of a stacked pool is)")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be int32 ({B}, max_blocks)")
    if pos0.dtype != torch.int32 or pos0.shape != (B,):
        raise ValueError(f"pos0 must be int32 ({B},)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
                    ("pos0", pos0)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    # the kernel reads q and writes out in the caller's (B, T, K, G, hd) layout
    q = q.contiguous()
    bt, pos0 = block_tables.contiguous(), pos0.contiguous()
    TG, max_blocks = T * G, bt.shape[1]
    n_split = _n_split(B, K, math.ceil(TG / 16), max_blocks, build.sm_count(dev))
    out = torch.empty_like(q)
    ptrs = (None, None, None)
    if n_split > 1:
        ws = torch.empty((B * K * n_split * TG * (hd + 2),), dtype=torch.float32, device=dev)
        n_ml = B * K * n_split * TG
        ptrs = (ws.data_ptr(), ws.data_ptr() + 4 * n_ml, ws.data_ptr() + 8 * n_ml)
    err = build.library().paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(), pos0.data_ptr(),
        out.data_ptr(), *ptrs, B, K, T, G, hd, block, max_blocks, int(window), q_code, kv_code,
        n_split, float(scale), float(cap), float(kv_scale), build.current_stream(dev),
    )
    build.check(err, "paged_attention")
    launches += 1
    return out


def paged_attention(q, k_pool, v_pool, block_tables, pos0, *, scale: float, cap: float = 0.0,
                    window=None, kv_scale: float = 1.0, out_dtype=None):
    """q (B, T, K, G, hd); k/v pools (n_blocks, block, K, hd) float or int8;
    block_tables (B, max_blocks) int32 (trash block 0 for unused entries);
    pos0 (B,) int32 first query position per row.  Returns (B, T, K, G, hd)."""
    if q.is_cuda:
        w = _NO_WINDOW if window is None else int(window)
        out = _launch(q, k_pool, v_pool, block_tables, pos0, scale=scale, cap=cap,
                      window=w, kv_scale=kv_scale)
    else:
        out = paged_attention_ref(q, k_pool, v_pool, block_tables, pos0, scale=scale,
                                  cap=cap, window=window, kv_scale=kv_scale)
    return out.to(out_dtype) if out_dtype is not None else out
