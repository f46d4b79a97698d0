"""Self-attention (mirrors ``repro/models/attention.py``): GQA/MQA and
deepseek-v3's multi-head latent attention (MLA).  Full-sequence prefill
attention, dense and paged KV caches (float, or SYMOG-quantized int8/int4
with a power-of-two scale per (block, KV head), per block for MLA's
head-less c_kv/k_rope), single-token decode, and the tail prefill that
writes a prompt's k/v into the paged pool and attends the pool itself.

Shapes: x (B, T, D); q (B, T, H, hd); k/v (B, S, K, hd) with H = K·G.
MLA: c_kv (B, S, r) and k_rope (B, S, rope), shared by all H heads.

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
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_mla
from repro_torch.kernels.paged_attention.ref import dequant_logical
from repro_torch.models.layers import (
    apply_rope,
    dense_apply,
    dense_init,
    rmsnorm_apply,
    rmsnorm_init,
    softcap as softcap_fn,
)
from repro_torch.models.kv_exponent import (  # noqa: F401 (KV_EXP_MAX: the clamp, for callers)
    KV_EXP_MAX,
    KV_EXP_MIN,
    exponent_thresholds,
    on_device,
    quant_scales,
)
from repro_torch.models.quantized import as_dense

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
    """Per-entry SYMOG exponent: smallest e with amax/2^e ≤ qmax/2, with the
    bits of the JAX package's jitted fp32 ``ceil(log2(amax) + 1 -
    log2(qmax))`` on every device (``models.kv_exponent``): e is KV_EXP_MIN
    plus the number of that exponent's step points at or below amax (a NaN
    amax gives 0, as XLA's clamp and conversion do).
    ``new`` (N, ..., width); the amax runs over the feature axis, so the
    result (N, ...) is per KV head.  The +1 margin bit leaves factor-2
    headroom for the block's later tokens."""
    amax = torch.amax(torch.abs(new.to(torch.float32)), dim=-1)
    th = on_device(exponent_thresholds, amax.device, qmax)
    amax = torch.nan_to_num(amax, nan=exponent_thresholds(qmax)[-KV_EXP_MIN - 1].item())  # e 0
    return torch.bucketize(amax, th, out_int32=True, right=True) + KV_EXP_MIN


def quantize_fixed(x: torch.Tensor, e: torch.Tensor, qmax: int) -> torch.Tensor:
    """Round x to int8 mantissas under per-entry exponents ``e`` in
    [KV_EXP_MIN, KV_EXP_MAX] (broadcast over the trailing feature axis);
    round half to even.  The factor is the JAX package's jitted
    ``exp2(-e)`` (``kv_exponent.quant_scales``): 2^-e but for |e| >= 13."""
    scale = torch.index_select(on_device(quant_scales, e.device), 0,
                               (e - KV_EXP_MIN).reshape(-1)).view(*e.shape, 1)
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


def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool = True, window=None,
              prefix_len: int = 0, kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean mask (..., T, S) from query/key positions, the JAX package's
    clauses in its order: causal (else all keys), the window, then the
    image prefix OR-ed in (every query sees every key below ``prefix_len``:
    a prefix-LM), then ``kv_valid`` (..., S) AND-ed last."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    if causal:
        m = k <= q
    else:
        m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                       device=q.device)
    if window is not None:
        m = m & (q - k < window)
    if prefix_len:
        m = m | (k < prefix_len)
    if kv_valid is not None:
        m = m & kv_valid[..., None, :]
    return m


def _qk_attn(q, k, v, mask, *, scale: float, cap: float) -> torch.Tensor:
    """q (B,T,K,G,hd), k/v (B,S,K,hd), mask (B,T,S) -> out (B,T,K,G,hd)."""
    logits = torch.einsum("btkgh,bskh->bkgts", q, k).to(torch.float32) * scale
    if cap > 0:
        logits = softcap_fn(logits, cap)
    logits = torch.where(mask[:, None, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype), v)


def attend(q, k, v, q_pos, kv_pos, *, causal: bool = True, window=None, prefix_len: int = 0,
           scale: float, cap: float, q_chunk: int = Q_CHUNK_DEFAULT):
    """Exact attention under ``make_mask``, query-chunked when T > q_chunk
    and q_chunk divides T (whisper's 1,500 frames run unchunked, as in JAX)."""
    B, T = q.shape[:2]
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None].expand(B, kv_pos.shape[0])
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    if q_chunk <= 0 or T <= q_chunk or T % q_chunk != 0:
        return _qk_attn(q, k, v, make_mask(q_pos, kv_pos, **kw), scale=scale, cap=cap)
    outs = []
    for c in range(T // q_chunk):
        sl = slice(c * q_chunk, (c + 1) * q_chunk)
        mask = make_mask(q_pos[:, sl], kv_pos, **kw)
        outs.append(_qk_attn(q[:, sl], k, v, mask, scale=scale, cap=cap))
    return torch.cat(outs, dim=1)


def _project_q(p, x, positions, cfg: AttnConfig, rope_base, compute_dtype, rope_table=None):
    q = dense_apply(p["q_proj"], x, compute_dtype=compute_dtype)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
    if cfg.rope:
        q = apply_rope(q, positions, rope_base, rope_table)
    return q


def _project_qkv(p, x, positions, cfg: AttnConfig, rope_base, compute_dtype, rope_table=None):
    q = _project_q(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
    k = dense_apply(p["k_proj"], x, compute_dtype=compute_dtype)
    v = dense_apply(p["v_proj"], x, compute_dtype=compute_dtype)
    if cfg.qk_norm:
        k = rmsnorm_apply(p["k_norm"], k)
    if cfg.rope:
        k = apply_rope(k, positions, rope_base, rope_table)
    return q, k, v


def attn_apply(p, x, *, cfg: AttnConfig, positions, causal: bool = True,
               window=None, prefix_len: int = 0, rope_base=10000.0,
               compute_dtype=torch.bfloat16, kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               q_chunk: int = Q_CHUNK_DEFAULT, return_kv: bool = False, rope_table=None):
    """Full-sequence (prefill) attention under ``make_mask(causal, window,
    prefix_len)``.  ``kv``: precomputed (k, v) (B, S, K, hd) for
    cross-attention, which attends every key (``causal`` applies to
    self-attention only, as in JAX).
    ``return_kv`` also returns the roped (k, v) a self-attention attended to
    — the prefill cache entries, which the JAX package recomputes with two
    more projections.  ``rope_table`` is the layers' shared
    ``rope_table(positions, rope_base, hd)``."""
    B, T, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kv is None:
        q, k, v = _project_qkv(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
        kv_pos = positions
    else:
        q = _project_q(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
        k, v = kv
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    q = q.reshape(B, T, K, H // K, hd)
    k, v = k.to(compute_dtype), v.to(compute_dtype)
    out = attend(q, k, v, positions, kv_pos, causal=causal and kv is None, window=window,
                 prefix_len=prefix_len, scale=_scale(cfg), cap=cfg.softcap, q_chunk=q_chunk)
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
    """Flat pool index (B,) of each row's write position ``pos`` (B,).  The
    block index is clamped to the table, as JAX's gather clamps it: a row
    that finished at max_len keeps pos = max_len while inactive, and its
    zeroed table row sends the write to the trash block."""
    b = torch.arange(pos.shape[0], device=pos.device)
    pos = pos.to(torch.int64)
    bi = torch.clamp(pos // block, max=block_tables.shape[1] - 1)
    return block_tables[b, bi].to(torch.int64) * block + pos % block


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


def _paged_attend(p, q, cache, block_tables, positions, *, cfg: AttnConfig, window,
                  compute_dtype):
    """q (B, T, H, hd) at ``positions`` (B, T) attends the paged pool its
    rows were just written into, then the output projection: the fused
    ``paged_attention`` kernel unless the backend is 'composed', else the
    plain gather -> mask -> softmax."""
    B, T = q.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if resolve_attention_backend(q.device) != "composed":
        out = _fused_paged_attn(q, cache, block_tables, positions, cfg=cfg, window=window,
                                compute_dtype=compute_dtype)
    else:
        k = _paged_read(cache, "k", block_tables, compute_dtype, hd)
        v = _paged_read(cache, "v", block_tables, compute_dtype, hd)
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
        mask = make_mask(positions, kv_pos[None, :], window=window)
        out = _qk_attn(q.reshape(B, T, K, H // K, hd), k.to(compute_dtype),
                       v.to(compute_dtype), mask, scale=_scale(cfg),
                       cap=cfg.softcap).reshape(B, T, H, hd)
    return dense_apply(p["o_proj"], out, n_in=2, compute_dtype=compute_dtype)


def attn_decode(p, x, cache, pos, *, cfg: AttnConfig, window=None, rope_base=10000.0,
                compute_dtype=torch.bfloat16, kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                block_tables: Optional[torch.Tensor] = None,
                rope_table=None, cache_index: Optional[torch.Tensor] = None):
    """Single-token decode.  x (B,1,D); ``pos`` an int (uniform batch) or a
    (B,) tensor (per-row).  Self-attention writes each row's new k/v at its
    own position and attends its cache; ``kv`` (cross-attention) attends
    the fixed encoder context instead and leaves ``cache`` alone (None
    allowed).  ``block_tables`` (B, max_blocks) switches the cache to the
    paged layout: leaves are (n_blocks, block, K, hd) pools and row b
    resolves pos[b] through its table row (needs a (B,) ``pos``).
    ``rope_table`` and ``cache_index`` (``paged_token_index``) are the same
    for every layer of a step; the caller may compute them once."""
    B = x.shape[0]
    positions, per_row = decode_positions(pos, B, x.device)
    if kv is not None:  # plain PyTorch, as JAX's ``_qk_attn``: no Pallas kernel computes it
        q = _project_q(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
        k, v = kv
        mask = torch.ones((B, 1, k.shape[1]), dtype=torch.bool, device=x.device)
        return _attend_out(p, q, k, v, mask, cfg, compute_dtype), cache
    q, k_new, v_new = _project_qkv(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
    if block_tables is not None:
        if not per_row:
            raise ValueError("paged decode requires per-row (B,) positions")
        idx = cache_index
        if idx is None:
            idx = paged_token_index(block_tables, positions[:, 0], cache["k"].shape[1])
        _paged_write(cache, ("k", "v"), (k_new[:, 0], v_new[:, 0]), idx)
        y = _paged_attend(p, q, cache, block_tables, positions, cfg=cfg, window=window,
                          compute_dtype=compute_dtype)
        return y, cache
    cache_update_rows(cache["k"], k_new, pos if not per_row else positions[:, 0],
                      per_row=per_row)
    cache_update_rows(cache["v"], v_new, pos if not per_row else positions[:, 0],
                      per_row=per_row)
    k, v = cache_read(cache["k"], compute_dtype), cache_read(cache["v"], compute_dtype)
    kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
    mask = make_mask(positions, kv_pos[None, :], window=window)
    return _attend_out(p, q, k, v, mask, cfg, compute_dtype), cache


def _attend_out(p, q, k, v, mask, cfg: AttnConfig, compute_dtype):
    """One decode query a row (q (B, 1, H, hd)) over k / v (B, S, K, hd)
    under ``mask`` (B, 1, S), then the output projection."""
    B = q.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = _qk_attn(q.reshape(B, 1, K, H // K, hd), k.to(compute_dtype), v.to(compute_dtype),
                   mask, scale=_scale(cfg), cap=cfg.softcap)
    return dense_apply(p["o_proj"], out.reshape(B, 1, H, hd), n_in=2, compute_dtype=compute_dtype)


def attn_prefill_paged(p, x, cache, bt_row, positions, *, cfg: AttnConfig, seq_len: int,
                       window=None, rope_base=10000.0, compute_dtype=torch.bfloat16,
                       rope_table=None):
    """Tail prefill of one request against the paged pool.

    x (1, T, D) is the right-padded tail of a prompt whose first
    ``positions[0, 0]`` tokens already sit in the pool blocks named by
    ``bt_row`` (max_blocks,); ``seq_len`` is the real tail length.  Each
    real tail token writes its k/v into the pool at its global position
    first (a quantized pool quantizes at write under its block's exponent,
    set once, at the block's first slot); pad rows write into the trash
    block.  Then the tail attends the whole table row: on the card the
    ``paged_attention`` kernel with T = the bucket and pos0 = the start, on
    the CPU the plain gather → mask → softmax."""
    T = x.shape[1]
    q, k_new, v_new = _project_qkv(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
    block = cache["k"].shape[1]
    pos_t = positions[0].to(torch.int64)
    # a pad row's position may run past the table: clamp before the lookup
    bi = torch.clamp(pos_t // block, max=bt_row.shape[0] - 1)
    idx = bt_row.to(torch.int64)[bi] * block + pos_t % block
    real = torch.arange(T, device=x.device) < seq_len
    idx = torch.where(real, idx, torch.zeros_like(idx))  # pads -> trash
    _paged_write(cache, ("k", "v"), (k_new[0], v_new[0]), idx)
    y = _paged_attend(p, q, cache, bt_row[None], positions, cfg=cfg, window=window,
                      compute_dtype=compute_dtype)
    return y, cache


def verify_token_index(block_tables, positions, block: int, valid):
    """Flat pool indices (B, T) of a grid of speculative write positions:
    entry (b, t) addresses ``positions[b, t]`` through row b's table.  The
    block index is clamped to the table before the lookup, and ``valid``
    (B, T) sends out-of-range or inactive positions to the trash block, so
    a row near ``max_len`` rides the fixed-width verify without reading
    past its table."""
    B, max_blocks = block_tables.shape
    pos = positions.to(torch.int64)
    bi = torch.clamp(pos // block, max=max_blocks - 1)
    rows = torch.arange(B, device=pos.device)[:, None]
    idx = block_tables.to(torch.int64)[rows, bi] * block + pos % block
    return torch.where(valid, idx, torch.zeros_like(idx))


def _verify_scatter(cache, names, news, idx) -> None:
    """Scatter (B, T, ...) entries into each paged leaf at flat ``idx``
    (B, T), in place.  Rows own disjoint blocks and a row's positions are
    distinct, so only trash-redirected entries collide."""
    B, T = idx.shape
    news = [new.reshape((B * T,) + tuple(new.shape[2:])) for new in news]
    _paged_write(cache, names, news, idx.reshape(B * T))


def attn_verify_paged(p, x, cache, block_tables, positions, *, cfg: AttnConfig, valid,
                      window=None, rope_base=10000.0, compute_dtype=torch.bfloat16,
                      rope_table=None, cache_index: Optional[torch.Tensor] = None):
    """Speculative multi-token verify against the paged pool.

    x (B, T, D) embeds [last committed token, drafts d_1..d_{T-1}] per row;
    ``positions`` (B, T) are the global positions ``pos[b] + t`` and
    ``valid`` (B, T) sends inactive rows and positions past ``max_len`` to
    the trash block.  Every row writes its T k/v entries first, then
    attends its whole table row, so each query reads real KV across its
    causal horizon and the output at every valid position is what T
    sequential decode steps give.  On the card: the ``paged_attention``
    kernel with B rows of T queries from pos0 = ``positions[:, 0]``.
    ``cache_index`` (``verify_token_index``) is the same for every layer."""
    q, k_new, v_new = _project_qkv(p, x, positions, cfg, rope_base, compute_dtype, rope_table)
    idx = cache_index
    if idx is None:
        idx = verify_token_index(block_tables, positions, cache["k"].shape[1], valid)
    _verify_scatter(cache, ("k", "v"), (k_new, v_new), idx)
    y = _paged_attend(p, q, cache, block_tables, positions, cfg=cfg, window=window,
                      compute_dtype=compute_dtype)
    return y, cache


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


def mla_init(gen, cfg: MLAConfig, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    D, H = cfg.d_model, cfg.n_heads
    dev = gen.device
    kw = dict(dtype=dtype, lead=lead)

    def sd(fan):
        return 1.0 / math.sqrt(fan)

    return {
        "q_a_proj": dense_init(gen, (D,), (cfg.q_lora_rank,), stddev=sd(D), **kw),
        "q_a_norm": rmsnorm_init(cfg.q_lora_rank, dtype, dev, lead),
        "q_b_proj": dense_init(gen, (cfg.q_lora_rank,), (H, cfg.qk_nope_dim + cfg.qk_rope_dim),
                               stddev=sd(cfg.q_lora_rank), **kw),
        "kv_a_proj": dense_init(gen, (D,), (cfg.kv_lora_rank,), stddev=sd(D), **kw),
        "kv_a_norm": rmsnorm_init(cfg.kv_lora_rank, dtype, dev, lead),
        "k_rope_proj": dense_init(gen, (D,), (cfg.qk_rope_dim,), stddev=sd(D), **kw),
        "kv_b_k_proj": dense_init(gen, (cfg.kv_lora_rank,), (H, cfg.qk_nope_dim),
                                  stddev=sd(cfg.kv_lora_rank), **kw),
        "kv_b_v_proj": dense_init(gen, (cfg.kv_lora_rank,), (H, cfg.v_head_dim),
                                  stddev=sd(cfg.kv_lora_rank), **kw),
        "o_proj": dense_init(gen, (H, cfg.v_head_dim), (D,), stddev=sd(H * cfg.v_head_dim), **kw),
    }


def _mla_scale(cfg: MLAConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def _mla_project(p, x, positions, cfg: MLAConfig, rope_base, compute_dtype, rope_table):
    """(q_nope, q_rope, c_kv, k_rope): the low-rank query, the compressed kv
    and the shared roped key of x (B, T, D)."""
    cq = rmsnorm_apply(p["q_a_norm"], dense_apply(p["q_a_proj"], x, compute_dtype=compute_dtype))
    q = dense_apply(p["q_b_proj"], cq, compute_dtype=compute_dtype)  # (B,T,H,nope+rope)
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, rope_base, rope_table)
    c_kv = rmsnorm_apply(p["kv_a_norm"],
                         dense_apply(p["kv_a_proj"], x, compute_dtype=compute_dtype))  # (B,T,r)
    k_rope = dense_apply(p["k_rope_proj"], x, compute_dtype=compute_dtype)[..., None, :]
    k_rope = apply_rope(k_rope, positions, rope_base, rope_table)[..., 0, :]  # (B,T,rope)
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(p, x, *, cfg: MLAConfig, positions, rope_base=10000.0,
              compute_dtype=torch.bfloat16, q_chunk: int = Q_CHUNK_DEFAULT,
              return_kv: bool = False, rope_table=None):
    """Full-sequence MLA (prefill): the expanded-KV form, query-chunked.
    ``return_kv`` also returns (c_kv, k_rope), the prefill cache entries,
    which the JAX package recomputes with two more projections.
    ``rope_table`` is ``rope_table(positions, rope_base, qk_rope_dim)``."""
    B, T, _ = x.shape
    H, rope = cfg.n_heads, cfg.qk_rope_dim
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, x, positions, cfg, rope_base, compute_dtype,
                                                rope_table)
    k_nope = dense_apply(p["kv_b_k_proj"], c_kv, compute_dtype=compute_dtype)  # (B,T,H,nope)
    v = dense_apply(p["kv_b_v_proj"], c_kv, compute_dtype=compute_dtype)  # (B,T,H,v)
    # every head's key: its own nope part and the shared roped part
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, rope)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]  # K = H, G = 1
    out = attend(q_full, k_full, v, positions, positions, scale=_mla_scale(cfg), cap=0.0,
                 q_chunk=q_chunk)
    y = dense_apply(p["o_proj"], out.reshape(B, T, H, cfg.v_head_dim), n_in=2,
                    compute_dtype=compute_dtype)
    return (y, (c_kv, k_rope)) if return_kv else y


def mla_init_cache(batch: int, max_len: int, cfg: MLAConfig, dtype=torch.bfloat16, device=None,
                   lead: Tuple[int, ...] = ()):
    return {
        "c_kv": torch.zeros(lead + (batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros(lead + (batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def _fused_paged_mla(q_eff, q_rope, cache, block_tables, positions, *, cfg: MLAConfig,
                     compute_dtype):
    """The CUDA MLA kernel over the compressed c_kv/k_rope pools.  Returns
    the rank-space (B, T, H, r) output; the caller applies kv_b_v."""
    quant = "c_kv_scale" in cache
    return paged_attention_mla(
        q_eff, q_rope, cache["c_kv"], cache["k_rope"], block_tables,
        positions[:, 0].contiguous(), scale=_mla_scale(cfg),
        kv_scale=_pool_dequant_scale(cache["c_kv"]), ckv_scale_exp=cache.get("c_kv_scale"),
        kr_scale_exp=cache.get("k_rope_scale"),
        kv_bits=word_bits(cache["c_kv"], q_eff.shape[-1]) if quant else 0,
        out_dtype=compute_dtype,
    )


def mla_decode(p, x, cache, pos, *, cfg: MLAConfig, rope_base=10000.0,
               compute_dtype=torch.bfloat16, block_tables: Optional[torch.Tensor] = None,
               rope_table=None, cache_index: Optional[torch.Tensor] = None):
    """Absorbed decode: attention runs in the compressed rank-r space.

        q_eff = q_nope @ kv_b_k  (per head);  logits = q_eff·c_kv + q_rope·k_rope;
        out = (probs·c_kv) @ kv_b_v

    The absorbed kv_b_k / kv_b_v contractions dequantize a Packed kernel
    through ``as_dense`` on every call, as the JAX package does: they run no
    fixed-point matmul kernel.  ``block_tables`` selects the paged c_kv /
    k_rope pools (``rope_table``/``cache_index``: see ``attn_decode``)."""
    B = x.shape[0]
    r = cfg.kv_lora_rank
    positions, per_row = decode_positions(pos, B, x.device)
    q_nope, q_rope, c_new, kr_new = _mla_project(p, x, positions, cfg, rope_base, compute_dtype,
                                                 rope_table)
    q_eff = torch.einsum("bthn,rhn->bthr", q_nope,
                         as_dense(p["kv_b_k_proj"]["kernel"], compute_dtype))
    if block_tables is not None:
        if not per_row:
            raise ValueError("paged decode requires per-row (B,) positions")
        idx = cache_index
        if idx is None:
            idx = paged_token_index(block_tables, positions[:, 0], cache["c_kv"].shape[1])
        _paged_write(cache, ("c_kv", "k_rope"), (c_new[:, 0], kr_new[:, 0]), idx)
        if resolve_attention_backend(x.device) != "composed":
            out_c = _fused_paged_mla(q_eff, q_rope, cache, block_tables, positions, cfg=cfg,
                                     compute_dtype=compute_dtype)
        else:
            c_kv = _paged_read(cache, "c_kv", block_tables, compute_dtype, r)
            k_rope = _paged_read(cache, "k_rope", block_tables, compute_dtype, cfg.qk_rope_dim)
            out_c = _mla_attend(q_eff, q_rope, c_kv, k_rope, positions, cfg, compute_dtype)
    else:
        p_or_rows = pos if not per_row else positions[:, 0]
        cache_update_rows(cache["c_kv"], c_new, p_or_rows, per_row=per_row)
        cache_update_rows(cache["k_rope"], kr_new, p_or_rows, per_row=per_row)
        out_c = _mla_attend(q_eff, q_rope, cache_read(cache["c_kv"], compute_dtype),
                            cache_read(cache["k_rope"], compute_dtype), positions, cfg,
                            compute_dtype)
    out = torch.einsum("bthr,rhv->bthv", out_c, as_dense(p["kv_b_v_proj"]["kernel"], compute_dtype))
    y = dense_apply(p["o_proj"], out, n_in=2, compute_dtype=compute_dtype)
    return y, cache


def _mla_attend(q_eff, q_rope, c_kv, k_rope, positions, cfg: MLAConfig, compute_dtype):
    """The composed absorbed attention over a logical (B, S, ...) view:
    rank-space output (B, T, H, r), query t of row b masked to its own
    causal horizon ``positions[b, t]``."""
    S = c_kv.shape[1]
    kv_pos = torch.arange(S, dtype=torch.int32, device=c_kv.device)
    mask = kv_pos[None, None, None, :] <= positions[:, None, :, None]  # (B, 1, T, S)
    logits = (torch.einsum("bthr,bsr->bhts", q_eff, c_kv)
              + torch.einsum("bthr,bsr->bhts", q_rope, k_rope)).to(torch.float32) * _mla_scale(cfg)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(compute_dtype)
    return torch.einsum("bhts,bsr->bthr", probs, c_kv)  # compressed values


def mla_verify_paged(p, x, cache, block_tables, positions, *, cfg: MLAConfig, valid,
                     rope_base=10000.0, compute_dtype=torch.bfloat16, rope_table=None,
                     cache_index: Optional[torch.Tensor] = None):
    """Speculative multi-token MLA verify against the paged c_kv / k_rope
    pools: ``mla_decode``'s paged branch at T > 1.  The T compressed entries
    of each row are written at their global positions first, then each
    query attends its own causal horizon; on the card the MLA kernels at T
    query rows from pos0 = ``positions[:, 0]``.  x (B, T, D); ``positions``
    / ``valid`` (B, T) as in ``attn_verify_paged``."""
    q_nope, q_rope, c_new, kr_new = _mla_project(p, x, positions, cfg, rope_base, compute_dtype,
                                                 rope_table)
    q_eff = torch.einsum("bthn,rhn->bthr", q_nope,
                         as_dense(p["kv_b_k_proj"]["kernel"], compute_dtype))
    idx = cache_index
    if idx is None:
        idx = verify_token_index(block_tables, positions, cache["c_kv"].shape[1], valid)
    _verify_scatter(cache, ("c_kv", "k_rope"), (c_new, kr_new), idx)
    if resolve_attention_backend(x.device) != "composed":
        out_c = _fused_paged_mla(q_eff, q_rope, cache, block_tables, positions, cfg=cfg,
                                 compute_dtype=compute_dtype)
    else:
        c_kv = _paged_read(cache, "c_kv", block_tables, compute_dtype, cfg.kv_lora_rank)
        k_rope = _paged_read(cache, "k_rope", block_tables, compute_dtype, cfg.qk_rope_dim)
        out_c = _mla_attend(q_eff, q_rope, c_kv, k_rope, positions, cfg, compute_dtype)
    out = torch.einsum("bthr,rhv->bthv", out_c, as_dense(p["kv_b_v_proj"]["kernel"], compute_dtype))
    y = dense_apply(p["o_proj"], out, n_in=2, compute_dtype=compute_dtype)
    return y, cache
