"""Per-layer blocks (mirrors ``repro/models/blocks.py``): kind 'A'
(attention + MLP), kind 'D' (the same, as an MoE model's leading dense
layers: deepseek-v3) and kind 'E' (attention + MoE: olmoe, deepseek-v3),
each with GQA attention or, with ``cfg.use_mla``, MLA; kind 'R' (RG-LRU
block + MLP: recurrentgemma) and kind 'M' (mamba2's SSD block, no MLP).
An 'A' block built with ``cross=True`` (whisper's decoder) adds a
cross-attention sublayer over the encoder output between its
self-attention and its MLP.  ``window`` and ``rope_base`` are per-layer
values read from the config.

The recurrent kinds' decode returns new state tensors and writes nothing
in place; the attention kinds write their caches in place, as the rest of
the port does."""
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
    attn_verify_paged,
    _project_qkv,
    _qk_attn,
    _scale,
    cache_read,
    cache_update_rows,
    cache_write,
    decode_positions,
    mla_apply,
    mla_decode,
    mla_init,
    mla_init_cache,
    mla_verify_paged,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dense_apply,
    layernorm_apply,
    layernorm_init,
    rmsnorm_apply,
    rmsnorm_init,
    tp_reduce,
)
from repro_torch.models.mlp import MLPConfig, mlp_apply, mlp_init
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init
from repro_torch.models.rglru import (
    RGLRUConfig,
    rglru_block_apply,
    rglru_block_decode,
    rglru_init,
    rglru_init_cache,
)
from repro_torch.models.ssd import (
    SSDConfig,
    ssd_block_apply,
    ssd_block_decode,
    ssd_init,
    ssd_init_cache,
)
from repro_torch.nn.sharding import current_mesh, mesh_axis_size


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


def _ep_active(cfg: ModelConfig, mesh=None) -> bool:
    """True when the mesh (default: the thread's current one, ``with
    mesh:``) carries the config's EP axes at total size > 1 and the expert
    count divides over them: the condition under which ``moe_impl='ep'``
    dispatches ``moe_apply_ep``.  Off a mesh MoE layers take the capacity
    dispatch: the same routing decisions, so the fallback is
    token-compatible.  The trainer enters no mesh: its MoE layers dispatch."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return False
    ep = mesh_axis_size(mesh, *cfg.ep_axes)
    return ep > 1 and cfg.n_experts % ep == 0


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


def _rglru_cfg(cfg: ModelConfig) -> RGLRUConfig:
    return RGLRUConfig(
        d_model=cfg.d_model, d_rnn=cfg.d_rnn, n_heads=cfg.rnn_heads, conv_width=cfg.conv_width
    )


def _ssd_cfg(cfg: ModelConfig) -> SSDConfig:
    return SSDConfig(
        d_model=cfg.d_model,
        d_inner=cfg.d_inner,
        n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim,
        d_state=cfg.ssm_state,
        conv_width=cfg.conv_width,
        chunk=cfg.ssd_chunk,
    )


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in ("A", "D", "E", "M", "R"):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; the port runs the attention+MLP "
            "('A', 'D'), attention+MoE ('E'), mamba2 SSD ('M') and RG-LRU ('R') blocks "
            "(ROADMAP Queue 1 item 4)"
        )


def zero_aux(device=None) -> Dict[str, torch.Tensor]:
    """The MoE losses of a block without an MoE (JAX's ``zero_aux``)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_aux_loss": z, "moe_z_loss": z}


def _norm_init(cfg: ModelConfig, dtype, device, lead=()):
    if cfg.norm == "rmsnorm":
        return rmsnorm_init(cfg.d_model, dtype, device, lead)
    return layernorm_init(cfg.d_model, dtype, device, lead)


def _norm_apply(cfg: ModelConfig, p, x):
    return rmsnorm_apply(p, x) if cfg.norm == "rmsnorm" else layernorm_apply(p, x)


def block_init(gen, cfg: ModelConfig, kind: str, dtype=torch.float32,
               lead: Tuple[int, ...] = (), cross: bool = False) -> Dict[str, Any]:
    _check_kind(cfg, kind)
    dev = gen.device
    p: Dict[str, Any] = {"pre_norm": _norm_init(cfg, dtype, dev, lead)}
    if kind == "M":
        p["ssd"] = ssd_init(gen, _ssd_cfg(cfg), dtype, lead)
        return p
    if kind == "R":
        p["rglru"] = rglru_init(gen, _rglru_cfg(cfg), dtype, lead)
    elif cfg.use_mla:
        p["attn"] = mla_init(gen, _mla_cfg(cfg), dtype, lead)
    else:
        p["attn"] = attn_init(gen, _attn_cfg(cfg), dtype, lead)
    if cfg.post_norm and kind != "R":
        p["post_attn_norm"] = _norm_init(cfg, dtype, dev, lead)
    if cross:
        p["cross_norm"] = _norm_init(cfg, dtype, dev, lead)
        p["cross_attn"] = attn_init(gen, _attn_cfg(cfg), dtype, lead)
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


def _ffn(p, h, cfg: ModelConfig, kind: str, compute_dtype, with_aux: bool = False,
         dropless: Optional[bool] = None, **moe_kw):
    """(y, aux): aux is None unless asked for, then the MoE losses (zeros
    for an MLP block).  An MoE block under ``moe_impl='ep'`` on a mesh
    routes expert-parallel (``_ep_active``): a full-sequence call with the
    dispatch's capacity factor as ``capacity_mult``, a decode step
    (``dropless`` not None) at the EP capacities' bounds when dropless.  In
    serving every rank holds the whole batch (``dp_axes=()``)."""
    if kind == "E":
        if cfg.moe_impl == "ep" and _ep_active(cfg):
            from repro_torch.models.moe_ep import moe_apply_ep

            if dropless is None:
                ep_kw = dict(seq_len=moe_kw.get("seq_len"), capacity_mult=cfg.capacity_factor)
            else:
                ep_kw = dict(dropless=dropless)
            y, aux = moe_apply_ep(p["moe"], h, cfg=_moe_cfg(cfg), compute_dtype=compute_dtype,
                                  ep_axes=tuple(cfg.ep_axes), dp_axes=(), with_aux=with_aux,
                                  **ep_kw)
        else:
            y, aux = moe_apply(p["moe"], h, cfg=_moe_cfg(cfg), compute_dtype=compute_dtype,
                               with_aux=with_aux, **moe_kw)
        return y, (aux if with_aux else None)
    y = tp_reduce(mlp_apply(p["mlp"], h, cfg=_mlp_cfg(cfg), compute_dtype=compute_dtype), "mlp")
    return y, (zero_aux(h.device) if with_aux else None)


def _ffn_residual(p, x, cfg: ModelConfig, kind: str, compute_dtype, with_aux: bool = False,
                  **moe_kw):
    """The FFN half of a block: pre-MLP norm, FFN, post-MLP norm, residual.
    Returns (x, aux) as ``_ffn``."""
    h = _norm_apply(cfg, p["pre_mlp_norm"], x)
    y, aux = _ffn(p, h, cfg, kind, compute_dtype, with_aux, **moe_kw)
    if cfg.post_norm:
        y = _norm_apply(cfg, p["post_mlp_norm"], y)
    return x + y, aux


def _finish_block(p, x, y, cfg: ModelConfig, kind: str, compute_dtype, with_aux: bool = False,
                  **moe_kw):
    """The block after attention: y (the attention output) through the
    post-attention norm into the residual, then the FFN half.  Returns (x,
    aux) as ``_ffn``.  A tensor-parallel attention's ``o_proj`` partials
    are summed here."""
    y = tp_reduce(y, "attn")
    if cfg.post_norm:
        y = _norm_apply(cfg, p["post_attn_norm"], y)
    return _ffn_residual(p, x + y, cfg, kind, compute_dtype, with_aux, **moe_kw)


def block_apply(p, x, *, cfg: ModelConfig, kind: str, positions, window=None,
                rope_base=10000.0, causal: bool = True, prefix_len: int = 0,
                compute_dtype=torch.bfloat16, enc_out: Optional[torch.Tensor] = None,
                cache_len: int = 0, rope_table=None, seq_len: Optional[int] = None,
                with_aux: bool = False):
    """Full-sequence block.  Returns (x, aux, cache), as JAX's: ``cache`` is
    the layer's prefill cache padded to ``cache_len`` (None unless > 0);
    ``aux`` the MoE load-balancing and z losses when ``with_aux`` (training;
    zeros for an MLP block), None otherwise: serving reads neither.
    ``seq_len`` (bucketed prefill): positions >= seq_len are padding, which
    only the couplings that are not per-token causal have to know: the MoE
    capacity dispatch and the recurrent / SSD state and conv caches (causal
    attention isolates them).  A recurrent block's cache is its state after
    the last real token, whatever ``cache_len``.

    ``causal`` False (whisper's encoder) attends every key; ``prefix_len``
    (paligemma) lets every query see the image prefix.  ``enc_out`` (whisper's
    decoder) runs the cross-attention sublayer; its (k, v) are projected
    once, attended at compute dtype and, at a prefill, cached in bf16 as
    ``cross_k`` / ``cross_v`` whatever the compute dtype, as JAX's
    ``prefill_lm`` casts them (it projects them a second time: the same
    values)."""
    _check_kind(cfg, kind)
    cache = None
    h = _norm_apply(cfg, p["pre_norm"], x)
    if kind == "M":
        y, cache = ssd_block_apply(p["ssd"], h, cfg=_ssd_cfg(cfg), compute_dtype=compute_dtype,
                                   seq_len=seq_len)
        return x + y, (zero_aux(x.device) if with_aux else None), (cache if cache_len else None)
    if kind == "R":
        y, cache = rglru_block_apply(p["rglru"], h, cfg=_rglru_cfg(cfg),
                                     compute_dtype=compute_dtype, seq_len=seq_len)
        x, aux = _ffn_residual(p, x + y, cfg, kind, compute_dtype, with_aux)
        return x, aux, (cache if cache_len else None)
    if cfg.use_mla:
        y, (c_kv, k_rope) = mla_apply(p["attn"], h, cfg=_mla_cfg(cfg), positions=positions,
                                      rope_base=rope_base, compute_dtype=compute_dtype,
                                      return_kv=True, rope_table=rope_table)
        if cache_len:
            cache = _mla_prefill_cache(c_kv, k_rope, cfg, cache_len)
    else:
        y, (k, v) = attn_apply(p["attn"], h, cfg=_attn_cfg(cfg), positions=positions,
                               causal=causal, window=window, prefix_len=prefix_len,
                               rope_base=rope_base, compute_dtype=compute_dtype,
                               return_kv=True, rope_table=rope_table)
        if cache_len:
            cache = _attn_prefill_cache(k, v, cfg, cache_len)
    if enc_out is None:
        x, aux = _finish_block(p, x, y, cfg, kind, compute_dtype, with_aux, seq_len=seq_len)
        return x, aux, cache
    if cfg.post_norm:
        y = _norm_apply(cfg, p["post_attn_norm"], y)
    x = x + y
    ca = p["cross_attn"]
    kv = tuple(dense_apply(ca[n], enc_out, compute_dtype=compute_dtype)
               for n in ("k_proj", "v_proj"))
    h = _norm_apply(cfg, p["cross_norm"], x)
    x = x + attn_apply(ca, h, cfg=_attn_cfg(cfg), positions=positions, causal=False,
                       rope_base=rope_base, compute_dtype=compute_dtype, kv=kv)
    if cache_len:
        cache.update(cross_k=kv[0].to(torch.bfloat16), cross_v=kv[1].to(torch.bfloat16))
    x, aux = _ffn_residual(p, x, cfg, kind, compute_dtype, with_aux)
    return x, aux, cache


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
    return _finish_block(p, x, y, cfg, "A", compute_dtype)[0], cache


def block_verify_paged(p, x, cache, block_tables, positions, *, cfg: ModelConfig, valid,
                       window=None, rope_base=10000.0, compute_dtype=torch.bfloat16,
                       rope_table=None, cache_index: Optional[torch.Tensor] = None):
    """Speculative multi-token verify of an attention ('A' / 'D') block:
    ``block_decode``'s per-token math at T = k + 1 tokens a row, attention
    against the paged pool by ``attn_verify_paged`` / ``mla_verify_paged``.
    Only the fully-paged tier verifies, so the FFN is always the dense MLP:
    MoE capacity competition across the k + 1 tokens would break the
    one-pass == sequential-decode equivalence."""
    h = _norm_apply(cfg, p["pre_norm"], x)
    if cfg.use_mla:
        y, cache = mla_verify_paged(p["attn"], h, cache, block_tables, positions,
                                    cfg=_mla_cfg(cfg), valid=valid, rope_base=rope_base,
                                    compute_dtype=compute_dtype, rope_table=rope_table,
                                    cache_index=cache_index)
    else:
        y, cache = attn_verify_paged(p["attn"], h, cache, block_tables, positions,
                                     cfg=_attn_cfg(cfg), valid=valid, window=window,
                                     rope_base=rope_base, compute_dtype=compute_dtype,
                                     rope_table=rope_table, cache_index=cache_index)
    return _finish_block(p, x, y, cfg, "A", compute_dtype)[0], cache


def block_cache_init(batch: int, max_len: int, cfg: ModelConfig, kind: str,
                     dtype=torch.bfloat16, device=None, lead: Tuple[int, ...] = (),
                     ring: bool = False):
    """Zero decode caches of one block.  ``dtype`` is the attention caches'
    dtype and the recurrent blocks' conv window's (their state is fp32).
    ``ring`` (a local-attention layer whose window is shorter than
    ``max_len``): a ring buffer of ``window`` entries per row, with a
    ``kv_pos`` (batch, window) map of the position each entry holds (-1:
    empty), so that every row keeps its own write offset."""
    _check_kind(cfg, kind)
    if kind == "M":
        return ssd_init_cache(batch, _ssd_cfg(cfg), dtype, device, lead)
    if kind == "R":
        return rglru_init_cache(batch, _rglru_cfg(cfg), dtype, device, lead)
    if cfg.use_mla:
        return mla_init_cache(batch, max_len, _mla_cfg(cfg), dtype, device, lead)
    if ring and cfg.window and cfg.window < max_len:
        c = attn_init_cache(batch, cfg.window, _attn_cfg(cfg), dtype, device, lead)
        c["kv_pos"] = torch.full(lead + (batch, cfg.window), -1, dtype=torch.int32, device=device)
        return c
    return attn_init_cache(batch, max_len, _attn_cfg(cfg), dtype, device, lead)


def _attn_decode_ring(pa, x, cache, pos, *, cfg: ModelConfig, rope_base, compute_dtype,
                      rope_table=None):
    """Ring-buffer local-attention decode, in place: the cache holds the
    window W; row b writes slot pos[b] % W, and the positions stored in
    ``kv_pos`` (B, W) give the mask.  ``pos`` an int or (B,) per row."""
    acfg = _attn_cfg(cfg)
    B = x.shape[0]
    H, K, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    W = cache["k"].shape[1]
    positions, per_row = decode_positions(pos, B, x.device)
    q, k_new, v_new = _project_qkv(pa, x, positions, acfg, rope_base, compute_dtype, rope_table)
    slot = torch.remainder(pos, W) if per_row else int(pos) % W
    for name, new in (("k", k_new), ("v", v_new), ("kv_pos", positions)):
        cache_update_rows(cache[name], new, slot, per_row=per_row)
    kv_pos = cache["kv_pos"]  # (B, W)
    valid = (kv_pos >= 0) & (kv_pos <= positions) & (positions - kv_pos < W)
    out = _qk_attn(q.reshape(B, 1, K, H // K, hd), cache_read(cache["k"], compute_dtype),
                   cache_read(cache["v"], compute_dtype), valid[:, None, :],
                   scale=_scale(acfg), cap=acfg.softcap)
    y = dense_apply(pa["o_proj"], out.reshape(B, 1, H, hd), n_in=2, compute_dtype=compute_dtype)
    return y, cache


def block_decode(p, x, cache, pos, *, cfg: ModelConfig, kind: str, window=None,
                 rope_base=10000.0, compute_dtype=torch.bfloat16,
                 enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 block_tables: Optional[torch.Tensor] = None, rope_table=None,
                 cache_index: Optional[torch.Tensor] = None, dropless_moe: bool = False):
    """One decode step of a block; ``block_tables`` selects the paged cache
    (``rope_table``/``cache_index``: see ``attn_decode``); ``enc_kv`` (the
    layer's resident cross_k / cross_v) runs the cross-attention sublayer.

    MoE capacity: ``dropless_moe`` (the scheduler's ragged decode) sizes
    each expert's buffer at the batch: a token's top-k experts are
    distinct, so an expert sees at most B assignments and none drops — a
    row's output then never depends on who shares the slot table.  The
    static loop keeps the bounded max(top_k, ceil(2·B·top_k/E)).

    The recurrent kinds ('M', 'R') return their new state as new tensors;
    a ring cache (``kv_pos``) is written in place like a dense one."""
    _check_kind(cfg, kind)
    h = _norm_apply(cfg, p["pre_norm"], x)
    if kind == "M":
        y, cache = ssd_block_decode(p["ssd"], h, cache, cfg=_ssd_cfg(cfg),
                                    compute_dtype=compute_dtype)
        return x + y, cache
    if kind == "R":
        y, cache = rglru_block_decode(p["rglru"], h, cache, cfg=_rglru_cfg(cfg),
                                      compute_dtype=compute_dtype)
        return _ffn_residual(p, x + y, cfg, kind, compute_dtype)[0], cache
    if cfg.use_mla:
        y, cache = mla_decode(p["attn"], h, cache, pos, cfg=_mla_cfg(cfg), rope_base=rope_base,
                              compute_dtype=compute_dtype, block_tables=block_tables,
                              rope_table=rope_table, cache_index=cache_index)
    elif "kv_pos" in cache:
        y, cache = _attn_decode_ring(p["attn"], h, cache, pos, cfg=cfg, rope_base=rope_base,
                                     compute_dtype=compute_dtype, rope_table=rope_table)
    else:
        y, cache = attn_decode(p["attn"], h, cache, pos, cfg=_attn_cfg(cfg), window=window,
                               rope_base=rope_base, compute_dtype=compute_dtype,
                               block_tables=block_tables, rope_table=rope_table,
                               cache_index=cache_index)
    if enc_kv is not None:
        if cfg.post_norm:
            y = _norm_apply(cfg, p["post_attn_norm"], y)
        x = x + y
        h = _norm_apply(cfg, p["cross_norm"], x)
        y, _ = attn_decode(p["cross_attn"], h, None, pos, cfg=_attn_cfg(cfg), rope_base=rope_base,
                           compute_dtype=compute_dtype, kv=enc_kv)
        return _ffn_residual(p, x + y, cfg, kind, compute_dtype)[0], cache
    cap = 0
    if kind == "E":
        B = x.shape[0]
        cap = B if dropless_moe else max(cfg.top_k,
                                         math.ceil(2.0 * B * cfg.top_k / cfg.n_experts))
    return _finish_block(p, x, y, cfg, kind, compute_dtype, capacity=cap,
                         **({"dropless": dropless_moe} if kind == "E" else {}))[0], cache
