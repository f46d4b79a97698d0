"""GQA/MQA self-attention (mirrors the GQA half of
``repro/models/attention.py``): full-sequence prefill attention, dense and
paged KV caches (float, or SYMOG-quantized int8/int4 with a per-(block,
KV head) power-of-two scale), and single-token decode.

Shapes: x (B, T, D); q (B, T, H, hd); k/v (B, S, K, hd) with H = K·G.

JAX's arrays are immutable and its serving traces donate the cache; here the
caches are updated IN PLACE (``index_put_`` on views of the pool), and the
functions return the same cache dict for the JAX call shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_attention_backend
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention.ref import dequant_logical
from repro_torch.models.layers import (
    apply_rope,
    dense_apply,
    dense_init,
    rmsnorm_apply,
    rmsnorm_init,
    softcap as softcap_fn,
)

Q_CHUNK_DEFAULT = 1024  # chunk queries when T exceeds this
# Fixed-point KV caches, two regimes:
#   - DENSE caches: one global power-of-two scale Δ = 2^-KV_F (int8_fp);
#   - PAGED pools: per-block, per-head SYMOG scales.  Each physical block
#     carries an int32 exponent in a ``<leaf>_scale`` sibling leaf,
#     calibrated once from the k/v vector at the block's first slot and
#     never re-rounded.  int4 packs two lanes per int8 word (split halves:
#     low nibbles = lanes [0, w/2), high = [w/2, w)).
KV_F = 5  # int8 fixed-point KV cache: Δ = 2^-5
KV_QMAX = {8: 127, 4: 7}  # symmetric mantissa range per wordlength
KV_EXP_MIN, KV_EXP_MAX = -20, 20  # exponent clamp (2^±20 stays finite)


def cache_write(x: torch.Tensor, like_dtype) -> torch.Tensor:
    """Quantize a new cache entry when the cache is int8 fixed-point."""
    if like_dtype == torch.int8:
        scaled = torch.round(x.to(torch.float32) * (2.0**KV_F))
        return torch.clamp(scaled, -127, 127).to(torch.int8)
    return x.to(like_dtype)


def cache_read(c: torch.Tensor, dtype) -> torch.Tensor:
    """Dequantize cache contents (exponent-shift scale)."""
    if c.dtype == torch.int8:
        return c.to(dtype) * (2.0**-KV_F)
    return c.to(dtype)


def block_scale_exp(new: torch.Tensor, qmax: int) -> torch.Tensor:
    """Per-entry SYMOG exponent: smallest e with amax/2^e ≤ qmax/2, as the
    JAX package computes it in fp32 (``ceil(log2(amax) + 1 - log2(qmax))``).
    ``new`` (N, ..., width); the amax runs over the feature axis, so the
    result (N, ...) is per KV head.  The +1 margin bit leaves factor-2
    headroom for the block's later tokens."""
    amax = torch.amax(torch.abs(new.to(torch.float32)), dim=-1)
    e = torch.ceil(torch.log2(torch.clamp(amax, min=2.0**-30)) + 1.0 - math.log2(qmax))
    return torch.clamp(e, KV_EXP_MIN, KV_EXP_MAX).to(torch.int32)


def quantize_fixed(x: torch.Tensor, e: torch.Tensor, qmax: int) -> torch.Tensor:
    """Round x to int8 mantissas under per-entry exponents ``e`` (broadcast
    over the trailing feature axis); round half to even."""
    scale = torch.exp2(-e.to(torch.float32))[..., None]
    q = torch.round(x.to(torch.float32) * scale)
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """Pack 2w int4 mantissas into w int8 words, split halves: word i holds
    lane i in its low nibble and lane i + w in its high (sign) nibble.  The
    cast to int8 keeps the low byte, the two's-complement word."""
    w = x.shape[-1] // 2
    return ((x[..., :w] & 15) | (x[..., w:] << 4)).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope: bool = True
    qk_norm: bool = False
    softcap: float = 0.0
    bias: bool = False
    query_scale: Optional[float] = None  # default hd^-0.5


def _scale(cfg: AttnConfig) -> float:
    return cfg.query_scale if cfg.query_scale is not None else cfg.head_dim**-0.5


def attn_init(gen, cfg: AttnConfig, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    std = 1.0 / math.sqrt(cfg.d_model)
    kw = dict(bias=cfg.bias, dtype=dtype, lead=lead)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "q_proj": dense_init(gen, (cfg.d_model,), (H, hd), stddev=std, **kw),
        "k_proj": dense_init(gen, (cfg.d_model,), (K, hd), stddev=std, **kw),
        "v_proj": dense_init(gen, (cfg.d_model,), (K, hd), stddev=std, **kw),
        "o_proj": dense_init(gen, (H, hd), (cfg.d_model,), stddev=1.0 / math.sqrt(H * hd), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device, lead)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device, lead)
    return p


def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, window=None) -> torch.Tensor:
    """Causal boolean mask (..., T, S) from query/key positions."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    m = k <= q
    if window is not None:
        m = m & (q - k < window)
    return m


def _qk_attn(q, k, v, mask, *, scale: float, cap: float) -> torch.Tensor:
    """q (B,T,K,G,hd), k/v (B,S,K,hd), mask (B,T,S) -> out (B,T,K,G,hd)."""
    logits = torch.einsum("btkgh,bskh->bkgts", q, k).to(torch.float32) * scale
    if cap > 0:
        logits = softcap_fn(logits, cap)
    logits = torch.where(mask[:, None, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)


def attend(q, k, v, q_pos, kv_pos, *, window=None, scale: float, cap: float,
           q_chunk: int = Q_CHUNK_DEFAULT):
    """Exact causal attention, query-chunked when T > q_chunk (and divides)."""
    B, T = q.shape[:2]
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None].expand(B, kv_pos.shape[0])
    if q_chunk <= 0 or T <= q_chunk or T % q_chunk != 0:
        mask = make_mask(q_pos, kv_pos, window=window)
        return _qk_attn(q, k, v, mask, scale=scale, cap=cap)
    outs = []
    for c in range(T // q_chunk):
        sl = slice(c * q_chunk, (c + 1) * q_chunk)
        mask = make_mask(q_pos[:, sl], kv_pos, window=window)
        outs.append(_qk_attn(q[:, sl], k, v, mask, scale=scale, cap=cap))
    return torch.cat(outs, dim=1)


def _project_qkv(p, x, positions, cfg: AttnConfig, rope_base, compute_dtype, rope_table=None):
    q = dense_apply(p["q_proj"], x, compute_dtype=compute_dtype)
    k = dense_apply(p["k_proj"], x, compute_dtype=compute_dtype)
    v = dense_apply(p["v_proj"], x, compute_dtype=compute_dtype)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    if cfg.rope:
        q = apply_rope(q, positions, rope_base, rope_table)
        k = apply_rope(k, positions, rope_base, rope_table)
    return q, k, v


def attn_apply(p, x, *, cfg: AttnConfig, positions, window=None,
               rope_base=10000.0, compute_dtype=torch.bfloat16,
               q_chunk: int = Q_CHUNK_DEFAULT, return_kv: bool = False, rope_table=None):
    """Full-sequence (prefill) causal self-attention.  ``return_kv`` also returns
    the roped (k, v) it attended to — the prefill cache entries, which the
    JAX package recomputes with two more projections.  ``rope_table`` is the
    layers' shared ``rope_table(positions, rope_base, hd)``."""
    B, T, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
    q = q.reshape(B, T, K, H // K, hd)
    k, v = k.to(compute_dtype), v.to(compute_dtype)
    out = attend(q, k, v, positions, positions, window=window, scale=_scale(cfg),
                 cap=cfg.softcap, q_chunk=q_chunk)
    y = dense_apply(p["o_proj"], out.reshape(B, T, H, hd), n_in=2, compute_dtype=compute_dtype)
    return (y, (k, v)) if return_kv else y


def attn_init_cache(batch: int, max_len: int, cfg: AttnConfig, dtype=torch.bfloat16,
                    device=None, lead: Tuple[int, ...] = ()):
    shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_positions(pos, batch: int, device) -> Tuple[torch.Tensor, bool]:
    """Normalize a decode position to (B, 1) int32 plus a per-row flag:
    a Python int means a uniform batch, a (B,) tensor per-row positions."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        if pos.dtype != torch.int32:
            pos = pos.to(torch.int32)
        return pos[:, None], True
    return torch.full((batch, 1), int(pos), dtype=torch.int32, device=device), False


def cache_update_rows(cache_leaf, new, pos, *, per_row: bool):
    """Write a one-step entry (B, 1, ...) at position ``pos`` (int) or at
    per-row positions ``pos`` (B,), in place."""
    new = cache_write(new, cache_leaf.dtype)
    if not per_row:
        cache_leaf[:, int(pos)] = new[:, 0]
    else:
        rows = torch.arange(cache_leaf.shape[0], device=cache_leaf.device)
        cache_leaf[rows, pos.to(torch.int64)] = new[:, 0]
    return cache_leaf


# ---------------------------------------------------------------------------
# paged KV cache: a (n_blocks, block, ...) pool shared by every slot,
# resolved through per-slot block tables.  Block 0 is the reserved trash
# block that evicted slots' zeroed table rows write into.
# ---------------------------------------------------------------------------
def paged_token_index(block_tables, pos, block: int):
    """Flat pool index (B,) of each row's write position ``pos`` (B,)."""
    b = torch.arange(pos.shape[0], device=pos.device)
    pos = pos.to(torch.int64)
    return block_tables[b, pos // block].to(torch.int64) * block + pos % block


def paged_update(pool, new, idx):
    """Scatter one entry per row into the pool, in place (the JAX package
    donates the pool to the same effect).  pool (n_blocks, block, ...);
    new (B, ...); idx (B,) flat token indices."""
    nb, block = pool.shape[:2]
    flat = pool.view((nb * block,) + tuple(pool.shape[2:]))
    flat[idx] = cache_write(new, pool.dtype)
    return pool


def paged_gather(pool, block_tables):
    """REFERENCE paged cache view: (B, max_blocks*block, ...) per row."""
    nb, block = pool.shape[:2]
    flat = pool.reshape((nb * block,) + tuple(pool.shape[2:]))
    idx = (block_tables.to(torch.int64)[:, :, None] * block
           + torch.arange(block, device=pool.device)[None, None, :])
    return flat[idx.reshape(block_tables.shape[0], -1)]


def _pool_dequant_scale(pool) -> float:
    """Static in-kernel dequantization scale for a paged pool leaf."""
    return 2.0**-KV_F if pool.dtype == torch.int8 else 1.0


def word_bits(pool: torch.Tensor, width: int) -> int:
    """Wordlength of a SYMOG pool leaf holding entries of ``width`` lanes:
    4 when its words are half as many (two lanes per int8 word), else 8."""
    return 4 if pool.shape[-1] * 2 == width else 8


def paged_quant_update(pool, exp_leaf, new, idx):
    """Scatter entries into a SYMOG-quantized pool, in place.

    pool (n_blocks, block, ..., w) int8 mantissa words; exp_leaf (n_blocks,
    ...) int32 per-block exponents; new (N, ..., width) float entries; idx
    (N,) flat token indices.  A block's exponent is calibrated ONCE, from
    the entry at its first slot (idx % block == 0); other entries scatter
    their candidate exponent into the trash row 0 instead, so a later write
    never re-rounds KV an earlier one committed."""
    nb, block = pool.shape[:2]
    bits = word_bits(pool, new.shape[-1])
    qmax = KV_QMAX[bits]
    bid = idx // block
    tgt = torch.where(idx % block == 0, bid, torch.zeros_like(bid))
    exp_leaf[tgt] = block_scale_exp(new, qmax)
    q = quantize_fixed(new, exp_leaf[bid], qmax)
    if bits == 4:
        q = pack_int4(q)
    pool.view((nb * block,) + tuple(pool.shape[2:]))[idx] = q
    return pool, exp_leaf


def _paged_write(cache, names, news, idx) -> None:
    """Scatter into paged leaves, in place: a leaf with a ``<name>_scale``
    sibling quantizes at write with its block's scale
    (``paged_quant_update``); any other leaf takes ``paged_update``.
    ``news`` are flat (N, ...) entries matching ``idx`` (N,)."""
    for name, new in zip(names, news):
        sname = name + "_scale"
        if sname in cache:
            paged_quant_update(cache[name], cache[sname], new, idx)
        else:
            paged_update(cache[name], new, idx)


def _paged_read(cache, name, block_tables, dtype, width):
    """Composed-path gather + dequantize of one paged leaf: per-block-scale
    leaves unpack int4 words and scale every row of physical block p by
    2^exp[p] (per KV head); KV_F/float leaves keep ``cache_read``."""
    sname = name + "_scale"
    if sname not in cache:
        return cache_read(paged_gather(cache[name], block_tables), dtype)
    bits = word_bits(cache[name], width)
    return dequant_logical(cache[name], cache[sname], block_tables, kv_bits=bits).to(dtype)


def _fused_paged_attn(q, cache, block_tables, positions, *, cfg: AttnConfig, window,
                      compute_dtype):
    """The CUDA paged-attention kernel in place of gather → mask →
    ``_qk_attn``.  q (B, T, H, hd) post-rope; positions (B, T) contiguous."""
    B, T = q.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = paged_attention(
        q.reshape(B, T, K, H // K, hd), cache["k"], cache["v"], block_tables,
        positions[:, 0].contiguous(), scale=_scale(cfg), cap=cfg.softcap, window=window,
        kv_scale=_pool_dequant_scale(cache["k"]), k_scale_exp=cache.get("k_scale"),
        v_scale_exp=cache.get("v_scale"),
        kv_bits=word_bits(cache["k"], hd) if "k_scale" in cache else 0, out_dtype=compute_dtype,
    )
    return out.reshape(B, T, H, hd)


def attn_decode(p, x, cache, pos, *, cfg: AttnConfig, window=None, rope_base=10000.0,
                compute_dtype=torch.bfloat16, block_tables: Optional[torch.Tensor] = None,
                rope_table=None, cache_index: Optional[torch.Tensor] = None):
    """Single-token decode.  x (B,1,D); ``pos`` an int (uniform batch) or a
    (B,) tensor (per-row).  ``block_tables`` (B, max_blocks) switches the
    cache to the paged layout: leaves are (n_blocks, block, K, hd) pools and
    row b resolves pos[b] through its table row (needs a (B,) ``pos``).
    ``rope_table`` and ``cache_index`` (``paged_token_index``) are the same
    for every layer of a step; the caller may compute them once."""
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions, per_row = decode_positions(pos, B, x.device)
    q, k_new, v_new = _project_qkv(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
    if block_tables is not None:
        if not per_row:
            raise ValueError("paged decode requires per-row (B,) positions")
        idx = cache_index
        if idx is None:
            idx = paged_token_index(block_tables, positions[:, 0], cache["k"].shape[1])
        _paged_write(cache, ("k", "v"), (k_new[:, 0], v_new[:, 0]), idx)
        if resolve_attention_backend(x.device) != "composed":
            out = _fused_paged_attn(q, cache, block_tables, positions, cfg=cfg,
                                    window=window, compute_dtype=compute_dtype)
            y = dense_apply(p["o_proj"], out, n_in=2, compute_dtype=compute_dtype)
            return y, cache
        k = _paged_read(cache, "k", block_tables, compute_dtype, hd)
        v = _paged_read(cache, "v", block_tables, compute_dtype, hd)
    else:
        cache_update_rows(cache["k"], k_new, pos if not per_row else positions[:, 0],
                          per_row=per_row)
        cache_update_rows(cache["v"], v_new, pos if not per_row else positions[:, 0],
                          per_row=per_row)
        k, v = cache_read(cache["k"], compute_dtype), cache_read(cache["v"], compute_dtype)
    S = k.shape[1]
    kv_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    mask = make_mask(positions, kv_pos[None, :], window=window)
    q = q.reshape(B, 1, K, H // K, hd)
    out = _qk_attn(q, k.to(compute_dtype), v.to(compute_dtype), mask, scale=_scale(cfg),
                   cap=cfg.softcap)
    y = dense_apply(p["o_proj"], out.reshape(B, 1, H, hd), n_in=2, compute_dtype=compute_dtype)
    return y, cache
