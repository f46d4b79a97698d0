"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060), chunked form
(mirrors ``repro/models/ssd.py``).

Per step (head h, state dim N, head dim P):
    h_t = exp(dt_t·A_h)·h_{t-1} + dt_t·(B_t ⊗ x_t)        (B_t ∈ ℝ^N shared)
    y_t = C_t·h_t + D_h·x_t

The chunked algorithm (matmuls, and one short loop over chunks):
  within-chunk "attention"  y_diag[i] = Σ_{j≤i} (C_i·B_j)·exp(cum_i-cum_j)·dt_j·x_j
  chunk states              S_c       = Σ_j exp(end-cum_j)·dt_j·(B_j ⊗ x_j)
  inter-chunk recurrence    H_c       = exp(Σ log a)·H_{c-1} + S_c
  cross term                y_off[i]  = exp(cum_i)·(C_i·H_{c-1})

Recurrence and decay math is fp32 (bf16 underflows the decay products).
Every function returns new state tensors and writes no cache in place: the
caller gates the write-back per row (``models.lm.decode_lm``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    _normal,
    dense_apply,
    dense_init,
    rmsnorm_apply,
    rmsnorm_init,
)
from repro_torch.models.quantized import as_dense
from repro_torch.models.rglru import _conv_causal, _softplus


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int  # P = d_inner / n_heads
    d_state: int = 128
    conv_width: int = 4
    chunk: int = 128


def ssd_init(gen, cfg: SSDConfig, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    D, R, H, N = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.d_state
    dev = gen.device
    sd = 1.0 / math.sqrt(D)
    kw = dict(stddev=sd, dtype=dtype, lead=lead)
    u = torch.rand(lead + (H,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    A_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev))
    return {
        "in_proj_z": dense_init(gen, (D,), (R,), **kw),
        "in_proj_x": dense_init(gen, (D,), (R,), **kw),
        "in_proj_B": dense_init(gen, (D,), (N,), **kw),
        "in_proj_C": dense_init(gen, (D,), (N,), **kw),
        "in_proj_dt": dense_init(gen, (D,), (H,), **kw),
        "conv1d": {"kernel": _normal(gen, lead + (cfg.conv_width, R + 2 * N), 0.1, dtype)},
        "A_log": A_log.expand(lead + (H,)).clone(),
        "ssm_D": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt)).to(torch.float32),  # softplus^-1
        "norm": rmsnorm_init(R, dtype, dev, lead),
        "out_proj": dense_init(gen, (R,), (D,), stddev=1.0 / math.sqrt(R), dtype=dtype,
                               lead=lead),
    }


def _in_projections(p, u, cfg: SSDConfig, compute_dtype, conv_state=None,
                    seq_len: Optional[int] = None):
    """Shared by full / decode: projections + causal conv over (x, B, C)."""
    z = dense_apply(p["in_proj_z"], u, compute_dtype=compute_dtype)
    x = dense_apply(p["in_proj_x"], u, compute_dtype=compute_dtype)
    Bm = dense_apply(p["in_proj_B"], u, compute_dtype=compute_dtype)
    Cm = dense_apply(p["in_proj_C"], u, compute_dtype=compute_dtype)
    dt_raw = dense_apply(p["in_proj_dt"], u, compute_dtype=compute_dtype)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc, new_conv = _conv_causal(as_dense(p["conv1d"]["kernel"]), F.silu(xbc), conv_state,
                                 seq_len=seq_len)
    R, N = cfg.d_inner, cfg.d_state
    x, Bm, Cm = xbc[..., :R], xbc[..., R: R + N], xbc[..., R + N:]
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B,T,H)
    if seq_len is not None:
        # padded steps get dt = 0: decay exp(0) = 1 and zero input, identity
        # state updates (the chunk padding relies on the same)
        valid = (torch.arange(u.shape[1], device=u.device) < seq_len)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    return z, x, Bm, Cm, dt, new_conv


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int):
    """Chunked SSD scan in fp32.  x (B,T,H,P); dt (B,T,H); A (H,) negative;
    Bm / Cm (B,T,N).  Returns y (B,T,H,P) and the final state (B,H,P,N).

    The decay is exp(cum_i − cum_j) masked to the lower triangle by a
    select after the exp, as in the JAX package: the upper entries may
    overflow to inf before the select, harmless in a forward pass (a
    backward through it would need the mask first).  The within-chunk term
    is the scores × decay product, then one batched matmul over j, which
    never builds the (B, nc, Q, Q, H, P) product."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = T // Q
    assert T % Q == 0, (T, Q)
    xf = x.to(torch.float32).reshape(B, nc, Q, H, P)
    dtc = dt.to(torch.float32).reshape(B, nc, Q, H)
    Bc = Bm.to(torch.float32).reshape(B, nc, Q, N)
    Cc = Cm.to(torch.float32).reshape(B, nc, Q, N)

    la = dtc * A  # (B,nc,Q,H) log-decay per step (negative)
    cum = torch.cumsum(la, dim=2)
    total = cum[:, :, -1, :]  # (B,nc,H)
    bx = dtc[..., None] * xf  # dt_j·x_j (B,nc,Q,H,P)

    # within-chunk: decay (B,nc,Q,Q,H), lower-triangular
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], decay, 0.0)
    scores = torch.einsum("bciN,bcjN->bcij", Cc, Bc)  # (B,nc,Q,Q)
    w = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)  # (B,nc,H,i,j)
    y_diag = torch.matmul(w, bx.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)  # (B,nc,Q,H,P)

    # chunk states S (B,nc,H,N,P): Σ_j B_j ⊗ (exp(end - cum_j)·dt_j·x_j)
    decay_out = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,H)
    wx = (decay_out[..., None] * bx).reshape(B, nc, Q, H * P)
    S = torch.matmul(Bc.transpose(2, 3), wx).reshape(B, nc, N, H, P).permute(0, 1, 3, 2, 4)

    # inter-chunk recurrence, the state before each chunk
    Ac = torch.exp(total)  # (B,nc,H)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = Ac[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B,nc,H,N,P)

    # cross term: exp(cum_i)·(C_i·H_{c-1})
    ch = torch.matmul(Cc[:, :, None], h_prev).permute(0, 1, 3, 2, 4)  # (B,nc,Q,H,P)
    y_off = ch * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(B, T, H, P)
    return y, h.transpose(-1, -2)  # final state (B,H,P,N)


def ssd_block_apply(p, u, *, cfg: SSDConfig, compute_dtype=torch.bfloat16,
                    seq_len: Optional[int] = None):
    """Full-sequence mamba2 block from the zero state.  u (B,T,D) -> (y
    (B,T,D), cache).

    With ``seq_len`` (bucketed prefill) positions >= seq_len are padding:
    their dt is zeroed (identity state update) and the conv window is cut
    at seq_len, so the cache equals an exact-length prefill's."""
    B, T, _ = u.shape
    H, P = cfg.n_heads, cfg.head_dim
    z, x, Bm, Cm, dt, new_conv = _in_projections(p, u, cfg, compute_dtype, seq_len=seq_len)
    A = -torch.exp(p["A_log"])  # (H,)
    # T padded to a chunk multiple: dt = 0 gives decay 1 and zero input
    Q = min(cfg.chunk, T)
    pad = (-T) % Q
    xh = x.reshape(B, T, H, P)
    if pad:
        xh, dt, Bm, Cm = (F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad)) for a in (xh, dt, Bm, Cm))
    y, h_last = ssd_scan_ref(xh, dt, A, Bm, Cm, chunk=Q)
    if pad:
        y = y[:, :T]
    y = y + p["ssm_D"][None, None, :, None] * x.reshape(B, T, H, P).to(torch.float32)
    y = y.reshape(B, T, cfg.d_inner).to(compute_dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    out = dense_apply(p["out_proj"], y, compute_dtype=compute_dtype)
    return out, {"h": h_last, "conv": new_conv}


def ssd_init_cache(batch: int, cfg: SSDConfig, dtype=torch.bfloat16, device=None,
                   lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    return {
        "h": torch.zeros(lead + (batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def ssd_block_decode(p, u, cache, *, cfg: SSDConfig, compute_dtype=torch.bfloat16):
    """Single-step decode.  u (B,1,D) -> (y, new cache); ``cache`` is only
    read."""
    B = u.shape[0]
    H, P = cfg.n_heads, cfg.head_dim
    z, x, Bm, Cm, dt, new_conv = _in_projections(p, u, cfg, compute_dtype, cache["conv"])
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[:, 0, :] * A)  # (B,H)
    xh = x.reshape(B, H, P).to(torch.float32)
    dB = dt[:, 0, :, None, None] * (xh[..., None] * Bm[:, 0, None, None, :].to(torch.float32))
    h = a[:, :, None, None] * cache["h"] + dB  # (B,H,P,N)
    y = torch.matmul(h, Cm[:, 0].to(torch.float32)[:, None, :, None])[..., 0]  # (B,H,P)
    y = y + p["ssm_D"][None, :, None] * xh
    y = y.reshape(B, 1, cfg.d_inner).to(compute_dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    out = dense_apply(p["out_proj"], y, compute_dtype=compute_dtype)
    return out, {"h": h, "conv": new_conv}
