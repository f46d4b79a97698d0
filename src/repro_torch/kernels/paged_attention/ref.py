"""Plain torch version of paged attention: the composed gather → mask →
softmax path.  The CPU path of the wrapper and the CUDA kernel's oracle."""
from __future__ import annotations

import torch


def gather_logical(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(B, max_blocks·block, ...) logical view — what the kernel avoids."""
    nb, block = pool.shape[:2]
    flat = pool.reshape((nb * block,) + tuple(pool.shape[2:]))
    idx = (
        block_tables.to(torch.int64)[:, :, None] * block
        + torch.arange(block, device=pool.device)[None, None, :]
    )
    return flat[idx.reshape(block_tables.shape[0], -1)]


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Split-halves int4 unpack: word i of a packed row holds lane i in its
    low nibble and lane i + w/2 in its high (sign-carrying) nibble, so the
    unpack is a lane-axis concatenate."""
    x = packed.to(torch.int32)
    lo = (x << 28) >> 28  # arithmetic shifts sign-extend the low nibble
    hi = x >> 4
    return torch.cat([lo, hi], dim=-1)


def dequant_logical(pool, exp_leaf, block_tables, *, kv_bits: int) -> torch.Tensor:
    """Gathered logical view (fp32) of a SYMOG-quantized pool: int4 words
    unpacked, then every row of physical block p scaled by 2^exp_leaf[p]
    (per KV head where the exponent leaf carries a head axis)."""
    data = gather_logical(pool, block_tables)
    if kv_bits == 4:
        data = unpack_int4(data)
    block = pool.shape[1]
    e = torch.repeat_interleave(exp_leaf[block_tables.to(torch.int64)], block, dim=1)
    scale = torch.exp2(e.to(torch.float32))[..., None]  # (B, S[, K], 1)
    return data.to(torch.float32) * scale


def paged_attention_ref(q, k_pool, v_pool, block_tables, pos0, *, scale, cap=0.0,
                        window=None, kv_scale=1.0, k_scale_exp=None, v_scale_exp=None,
                        kv_bits=0):
    """Composed reference for ``paged_attention`` (same contract), in q's dtype."""
    B, T, K, G, hd = q.shape
    if k_scale_exp is not None:
        k = dequant_logical(k_pool, k_scale_exp, block_tables, kv_bits=kv_bits)
        v = dequant_logical(v_pool, v_scale_exp, block_tables, kv_bits=kv_bits)
    else:
        k = gather_logical(k_pool, block_tables).to(torch.float32) * kv_scale
        v = gather_logical(v_pool, block_tables).to(torch.float32) * kv_scale
    S = k.shape[1]
    kv_pos = torch.arange(S, device=q.device, dtype=torch.int32)
    q_pos = pos0.to(torch.int32)[:, None] + torch.arange(T, device=q.device, dtype=torch.int32)[None]
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]  # (B, T, S)
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[None, None, :] < window)
    logits = torch.einsum("btkgh,bskh->bkgts", q.to(torch.float32), k) * scale
    if cap > 0:
        logits = torch.tanh(logits / cap) * cap
    logits = torch.where(mask[:, None, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgts,bskh->btkgh", probs, v).to(q.dtype)


def paged_attention_mla_ref(q_eff, q_rope, ckv_pool, krope_pool, block_tables, pos0, *, scale,
                            kv_scale=1.0, ckv_scale_exp=None, kr_scale_exp=None, kv_bits=0):
    """Composed reference for ``paged_attention_mla`` (same contract), in
    q_eff's dtype: logits q_eff·c_kv + q_rope·k_rope, value c_kv itself."""
    B, T, H, r = q_eff.shape
    if ckv_scale_exp is not None:
        c_kv = dequant_logical(ckv_pool, ckv_scale_exp, block_tables, kv_bits=kv_bits)
        k_rope = dequant_logical(krope_pool, kr_scale_exp, block_tables, kv_bits=kv_bits)
    else:
        c_kv = gather_logical(ckv_pool, block_tables).to(torch.float32) * kv_scale
        k_rope = gather_logical(krope_pool, block_tables).to(torch.float32) * kv_scale
    S = c_kv.shape[1]
    dev = q_eff.device
    kv_pos = torch.arange(S, device=dev, dtype=torch.int32)
    q_pos = pos0.to(torch.int32)[:, None] + torch.arange(T, device=dev, dtype=torch.int32)[None]
    mask = kv_pos[None, None, None, :] <= q_pos[:, None, :, None]  # (B, 1, T, S)
    logits = (torch.einsum("bthr,bsr->bhts", q_eff.to(torch.float32), c_kv)
              + torch.einsum("bthr,bsr->bhts", q_rope.to(torch.float32), k_rope)) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bsr->bthr", probs, c_kv).to(q_eff.dtype)
