"""Per-layer blocks (mirrors ``repro/models/blocks.py``) of the decoder
family: kind 'A' (attention + MLP), kind 'D' (the same, as an MoE model's
leading dense layers: deepseek-v3) and kind 'E' (attention + MoE: olmoe,
deepseek-v3), each with GQA attention or, with ``cfg.use_mla``, MLA.  The
recurrent kinds ('R', 'M') are not ported and raise.  ``window`` and
``rope_base`` are per-layer values read from the config."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.attention import (
    AttnConfig,
    MLAConfig,
    attn_apply,
    attn_decode,
    attn_init,
    attn_init_cache,
    attn_prefill_paged,
    cache_write,
    mla_apply,
    mla_decode,
    mla_init,
    mla_init_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    layernorm_apply,
    layernorm_init,
    rmsnorm_apply,
    rmsnorm_init,
)
from repro_torch.models.mlp import MLPConfig, mlp_apply, mlp_init
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init


def _attn_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        rope=cfg.use_rope,
        qk_norm=cfg.qk_norm,
        softcap=cfg.attn_softcap,
        bias=cfg.attn_bias,
        query_scale=cfg.query_scale,
    )


def _mla_cfg(cfg: ModelConfig) -> MLAConfig:
    return MLAConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim,
    )


def _mlp_cfg(cfg: ModelConfig) -> MLPConfig:
    return MLPConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff, gated=cfg.mlp_gated, act=cfg.act, bias=cfg.attn_bias
    )


def _moe_cfg(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        d_ff_expert=cfg.d_ff_expert,
        n_shared_experts=cfg.n_shared_experts,
        router=cfg.router,
        capacity_factor=cfg.capacity_factor,
        act=cfg.act,
    )


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in ("A", "D", "E"):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; the port serves the attention+MLP "
            "('A', 'D') and attention+MoE ('E') decoder blocks, with GQA or MLA attention "
            "(ROADMAP Queue 1 item 12)"
        )


def _norm_init(cfg: ModelConfig, dtype, device, lead=()):
    if cfg.norm == "rmsnorm":
        return rmsnorm_init(cfg.d_model, dtype, device, lead)
    return layernorm_init(cfg.d_model, dtype, device, lead)


def _norm_apply(cfg: ModelConfig, p, x):
    return rmsnorm_apply(p, x) if cfg.norm == "rmsnorm" else layernorm_apply(p, x)


def block_init(gen, cfg: ModelConfig, kind: str, dtype=torch.float32,
               lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    _check_kind(cfg, kind)
    dev = gen.device
    p: Dict[str, Any] = {"pre_norm": _norm_init(cfg, dtype, dev, lead)}
    if cfg.use_mla:
        p["attn"] = mla_init(gen, _mla_cfg(cfg), dtype, lead)
    else:
        p["attn"] = attn_init(gen, _attn_cfg(cfg), dtype, lead)
    if cfg.post_norm:
        p["post_attn_norm"] = _norm_init(cfg, dtype, dev, lead)
    p["pre_mlp_norm"] = _norm_init(cfg, dtype, dev, lead)
    if kind == "E":
        p["moe"] = moe_init(gen, _moe_cfg(cfg), dtype, lead)
    else:
        p["mlp"] = mlp_init(gen, _mlp_cfg(cfg), dtype, lead)
    if cfg.post_norm:
        p["post_mlp_norm"] = _norm_init(cfg, dtype, dev, lead)
    return p


def _attn_prefill_cache(k, v, cfg: ModelConfig, cache_len: int):
    """Pad the roped k/v prefill attention used into a (B, cache_len, K, hd)
    cache.  Float caches store at compute dtype, as in the JAX package."""
    compute_dtype = k.dtype
    pad = cache_len - k.shape[1]
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    dt = torch.int8 if cfg.kv_cache_dtype == "int8_fp" else compute_dtype
    return {"k": cache_write(k, dt), "v": cache_write(v, dt)}


def _mla_prefill_cache(c_kv, k_rope, cfg: ModelConfig, cache_len: int):
    """Pad the c_kv (B, T, r) and roped k_rope (B, T, rope) that prefill
    attention used into the layer's (B, cache_len, ...) cache."""
    compute_dtype = c_kv.dtype
    pad = cache_len - c_kv.shape[1]
    c_kv = torch.nn.functional.pad(c_kv, (0, 0, 0, pad))
    k_rope = torch.nn.functional.pad(k_rope, (0, 0, 0, pad))
    dt = torch.int8 if cfg.kv_cache_dtype == "int8_fp" else compute_dtype
    return {"c_kv": cache_write(c_kv, dt), "k_rope": cache_write(k_rope, dt)}


def _ffn(p, h, cfg: ModelConfig, kind: str, compute_dtype, **moe_kw):
    if kind == "E":
        y, _ = moe_apply(p["moe"], h, cfg=_moe_cfg(cfg), compute_dtype=compute_dtype,
                         with_aux=False, **moe_kw)
        return y
    return mlp_apply(p["mlp"], h, cfg=_mlp_cfg(cfg), compute_dtype=compute_dtype)


def _finish_block(p, x, y, cfg: ModelConfig, kind: str, compute_dtype, **moe_kw):
    """The block after attention: y (the attention output) through the
    post-attention norm into the residual, then the FFN the same way."""
    if cfg.post_norm:
        y = _norm_apply(cfg, p["post_attn_norm"], y)
    x = x + y
    h = _norm_apply(cfg, p["pre_mlp_norm"], x)
    y = _ffn(p, h, cfg, kind, compute_dtype, **moe_kw)
    if cfg.post_norm:
        y = _norm_apply(cfg, p["post_mlp_norm"], y)
    return x + y


def block_apply(p, x, *, cfg: ModelConfig, kind: str, positions, window=None,
                rope_base=10000.0, compute_dtype=torch.bfloat16, cache_len: int = 0,
                rope_table=None, seq_len: Optional[int] = None):
    """Full-sequence block.  Returns (x, cache); ``cache_len`` > 0 also
    returns the layer's prefill cache padded to that length.  ``seq_len``
    (bucketed prefill): positions >= seq_len are padding, which only the
    MoE capacity dispatch has to know (causal attention isolates them).
    The MoE aux losses are not computed: serving reads none of them."""
    _check_kind(cfg, kind)
    cache = None
    h = _norm_apply(cfg, p["pre_norm"], x)
    if cfg.use_mla:
        y, (c_kv, k_rope) = mla_apply(p["attn"], h, cfg=_mla_cfg(cfg), positions=positions,
                                      rope_base=rope_base, compute_dtype=compute_dtype,
                                      return_kv=True, rope_table=rope_table)
        if cache_len:
            cache = _mla_prefill_cache(c_kv, k_rope, cfg, cache_len)
    else:
        y, (k, v) = attn_apply(p["attn"], h, cfg=_attn_cfg(cfg), positions=positions,
                               window=window, rope_base=rope_base, compute_dtype=compute_dtype,
                               return_kv=True, rope_table=rope_table)
        if cache_len:
            cache = _attn_prefill_cache(k, v, cfg, cache_len)
    return _finish_block(p, x, y, cfg, kind, compute_dtype, seq_len=seq_len), cache


def block_prefill_paged(p, x, cache, bt_row, positions, *, cfg: ModelConfig, seq_len: int,
                        window=None, rope_base=10000.0, compute_dtype=torch.bfloat16,
                        rope_table=None):
    """Tail prefill of an attention + MLP ('A') block: ``block_apply``'s
    per-token math, with attention run against the paged pool by
    ``attn_prefill_paged`` (the tail's k/v written into the pool, no
    prefill cache returned).  Only the fully-paged tier takes this path,
    so the FFN is always the dense MLP."""
    h = _norm_apply(cfg, p["pre_norm"], x)
    y, cache = attn_prefill_paged(p["attn"], h, cache, bt_row, positions, cfg=_attn_cfg(cfg),
                                  seq_len=seq_len, window=window, rope_base=rope_base,
                                  compute_dtype=compute_dtype, rope_table=rope_table)
    return _finish_block(p, x, y, cfg, "A", compute_dtype), cache


def block_cache_init(batch: int, max_len: int, cfg: ModelConfig, kind: str,
                     dtype=torch.bfloat16, device=None, lead: Tuple[int, ...] = ()):
    _check_kind(cfg, kind)
    if cfg.use_mla:
        return mla_init_cache(batch, max_len, _mla_cfg(cfg), dtype, device, lead)
    return attn_init_cache(batch, max_len, _attn_cfg(cfg), dtype, device, lead)


def block_decode(p, x, cache, pos, *, cfg: ModelConfig, kind: str, window=None,
                 rope_base=10000.0, compute_dtype=torch.bfloat16,
                 block_tables: Optional[torch.Tensor] = None, rope_table=None,
                 cache_index: Optional[torch.Tensor] = None, dropless_moe: bool = False):
    """One decode step of a block; ``block_tables`` selects the paged cache
    (``rope_table``/``cache_index``: see ``attn_decode``).

    MoE capacity: ``dropless_moe`` (the scheduler's ragged decode) sizes
    each expert's buffer at the batch: a token's top-k experts are
    distinct, so an expert sees at most B assignments and none drops — a
    row's output then never depends on who shares the slot table.  The
    static loop keeps the bounded max(top_k, ceil(2·B·top_k/E))."""
    _check_kind(cfg, kind)
    h = _norm_apply(cfg, p["pre_norm"], x)
    if cfg.use_mla:
        y, cache = mla_decode(p["attn"], h, cache, pos, cfg=_mla_cfg(cfg), rope_base=rope_base,
                              compute_dtype=compute_dtype, block_tables=block_tables,
                              rope_table=rope_table, cache_index=cache_index)
    else:
        y, cache = attn_decode(p["attn"], h, cache, pos, cfg=_attn_cfg(cfg), window=window,
                               rope_base=rope_base, compute_dtype=compute_dtype,
                               block_tables=block_tables, rope_table=rope_table,
                               cache_index=cache_index)
    cap = 0
    if kind == "E":
        B = x.shape[0]
        cap = B if dropless_moe else max(cfg.top_k,
                                         math.ceil(2.0 * B * cfg.top_k / cfg.n_experts))
    return _finish_block(p, x, y, cfg, kind, compute_dtype, capacity=cap), cache
