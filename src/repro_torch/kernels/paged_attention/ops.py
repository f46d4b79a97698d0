"""Public wrapper: fused paged GQA/MQA attention for decode / verify /
tail prefill.

``paged_attention`` launches the CUDA kernel (``csrc/paged_attention.cu``)
for CUDA tensors and runs its plain version (``ref.py``) for CPU tensors.
Queries must be contiguous per row: q_pos[b, t] = pos0[b] + t.
``window=None`` maps onto the 2^30 sentinel; ``kv_scale`` is 2^-KV_F for
int8 fixed-point (KV_F) pools and 1.0 for float pools.  SYMOG-quantized
pools pass ``k_scale_exp``/``v_scale_exp`` (n_blocks, K) int32 exponents
and ``kv_bits`` 8 (int8 words) or 4 (split-halves int4 words, last dim
hd/2); each (block, KV head) is dequantized as word · 2^e.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_NO_WINDOW = 2**30  # models.config.GLOBAL_WINDOW
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_QUANT_CODE = {8: 3, 4: 4}  # int8 words / int4 split-halves words, with exponents
# kernel launches (plain-version calls on the CPU do not count): float / KV_F
# pools, and SYMOG-quantized pools (the `_attn_kernel_quant` variant)
launches = 0
quant_launches = 0


def _n_split(B: int, K: int, row_tiles: int, max_blocks: int, n_sm: int) -> int:
    """KV splits per (b, kv_head, row tile): ~4 thread blocks per SM."""
    base = B * K * row_tiles
    return max(1, min(max_blocks, math.ceil(4 * n_sm / base)))


def _check_quant(k_pool, v_pool, k_exp, v_exp, kv_bits: int, nb: int, K: int) -> int:
    """The pool code of a SYMOG-quantized pool pair (3: int8, 4: int4)."""
    if kv_bits not in _QUANT_CODE:
        raise ValueError(f"kv_bits must be 8 or 4 with exponent leaves, got {kv_bits}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"quantized pools hold int8 words, got {k_pool.dtype}/{v_pool.dtype}")
    for name, e in (("k_scale_exp", k_exp), ("v_scale_exp", v_exp)):
        if e is None or e.dtype != torch.int32 or e.shape != (nb, K):
            raise ValueError(f"{name} must be int32 ({nb}, {K}), got "
                             f"{getattr(e, 'dtype', None)} {tuple(getattr(e, 'shape', ()))}")
        if not e.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return _QUANT_CODE[kv_bits]


def _launch(q, k_pool, v_pool, block_tables, pos0, *, scale, cap, window, kv_scale,
            k_exp=None, v_exp=None, kv_bits: int = 0):
    global launches, quant_launches
    dev = q.device
    B, T, K, G, hd = q.shape
    nb, block = k_pool.shape[:2]
    q_code, kv_code = _Q_CODE.get(q.dtype), _KV_CODE.get(k_pool.dtype)
    if q_code is None:
        raise TypeError(f"paged_attention kernel takes f32/bf16 q, got {q.dtype}")
    if kv_code is None or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share a f32/bf16/int8 dtype, got {k_pool.dtype}/{v_pool.dtype}")
    hdw = hd
    if kv_bits:
        kv_code = _check_quant(k_pool, v_pool, k_exp, v_exp, kv_bits, nb, K)
        if kv_bits == 4:
            if hd % 2:
                raise ValueError(f"int4 pools need an even head_dim, got {hd}")
            hdw = hd // 2  # two lanes per int8 word
    want = (nb, block, K, hdw)
    if k_pool.shape != want or v_pool.shape != want:
        raise ValueError(f"pools must be {want}, got {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (a layer's slice of a stacked pool is)")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be int32 ({B}, max_blocks)")
    if pos0.dtype != torch.int32 or pos0.shape != (B,):
        raise ValueError(f"pos0 must be int32 ({B},)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
                    ("pos0", pos0), ("k_scale_exp", k_exp), ("v_scale_exp", v_exp)):
        if t is not None and t.device != dev:
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
        None if k_exp is None else k_exp.data_ptr(), None if v_exp is None else v_exp.data_ptr(),
        out.data_ptr(), *ptrs, B, K, T, G, hd, block, max_blocks, int(window), q_code, kv_code,
        n_split, float(scale), float(cap), float(kv_scale), build.current_stream(dev),
    )
    build.check(err, "paged_attention")
    if kv_bits:
        quant_launches += 1
    else:
        launches += 1
    return out


def paged_attention(q, k_pool, v_pool, block_tables, pos0, *, scale: float, cap: float = 0.0,
                    window=None, kv_scale: float = 1.0, k_scale_exp=None, v_scale_exp=None,
                    kv_bits: int = 0, out_dtype=None):
    """q (B, T, K, G, hd); k/v pools (n_blocks, block, K, hd) float or int8
    (hd/2 int8 words for int4 pools); block_tables (B, max_blocks) int32
    (trash block 0 for unused entries); pos0 (B,) int32 first query position
    per row; ``k_scale_exp``/``v_scale_exp`` (n_blocks, K) int32 with
    ``kv_bits`` for SYMOG-quantized pools.  Returns (B, T, K, G, hd)."""
    quant = k_scale_exp is not None
    if quant != (v_scale_exp is not None) or quant != (kv_bits != 0) or kv_bits not in (0, 4, 8):
        raise ValueError("quantized pools take both exponent leaves and kv_bits 8 or 4; "
                         f"got k/v exponents {quant}/{v_scale_exp is not None}, kv_bits {kv_bits}")
    if q.is_cuda:
        w = _NO_WINDOW if window is None else int(window)
        out = _launch(q, k_pool, v_pool, block_tables, pos0, scale=scale, cap=cap,
                      window=w, kv_scale=kv_scale, k_exp=k_scale_exp, v_exp=v_scale_exp,
                      kv_bits=kv_bits)
    else:
        out = paged_attention_ref(q, k_pool, v_pool, block_tables, pos0, scale=scale,
                                  cap=cap, window=window, kv_scale=kv_scale,
                                  k_scale_exp=k_scale_exp, v_scale_exp=v_scale_exp,
                                  kv_bits=kv_bits)
    return out.to(out_dtype) if out_dtype is not None else out
