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


def paged_attention_ref(q, k_pool, v_pool, block_tables, pos0, *, scale, cap=0.0,
                        window=None, kv_scale=1.0):
    """Composed reference for ``paged_attention`` (same contract), in q's dtype."""
    B, T, K, G, hd = q.shape
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
