"""RG-LRU recurrent block (Griffin / RecurrentGemma; mirrors
``repro/models/rglru.py``).

    r_t = σ(W_a·x_t + b_a)              (recurrence gate, block-diag per head)
    i_t = σ(W_x·x_t + b_x)              (input gate,      block-diag per head)
    a_t = exp(-c·softplus(Λ)·r_t)       (c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1-a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the recurrence as a parallel prefix scan over time
(``_associative_scan``: the odd / even recursion of
``jax.lax.associative_scan``, log₂T levels of whole-tensor ops, its combines
in the same order); decode is the single-step recurrence.  The recurrence
is fp32 (the decay products underflow bf16); Λ ("a_param") stays
unquantized (``core.symog.DEFAULT_EXCLUDES``).

The full recurrent block is: in_proj_x → temporal conv (width 4, causal,
depthwise) → RG-LRU, gated by gelu(in_proj_y), then out_proj.  Every
function returns new state tensors and writes no cache in place: the
caller gates the write-back per row (``models.lm.decode_lm``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dense_apply, dense_init
from repro_torch.models.quantized import as_dense

C_FACTOR = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int
    n_heads: int
    conv_width: int = 4


def rglru_init(gen, cfg: RGLRUConfig, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    D, R, H = cfg.d_model, cfg.d_rnn, cfg.n_heads
    dh = R // H
    dev = gen.device
    sd, sdh = 1.0 / math.sqrt(D), 1.0 / math.sqrt(dh)
    # Λ so that a lies in (0.9, 0.999) at r = 1 (Griffin's init)
    u = torch.rand(lead + (R,), generator=gen, device=dev) * (0.999 - 0.9) + 0.9
    a_param = torch.log(torch.expm1(-torch.log(u) / C_FACTOR))  # softplus^-1(-log u / c)

    def gate():
        return {"kernel": _normal(gen, lead + (H, dh, dh), sdh, dtype),
                "bias": torch.zeros(lead + (H, dh), dtype=dtype, device=dev)}

    return {
        "in_proj_x": dense_init(gen, (D,), (R,), stddev=sd, dtype=dtype, lead=lead),
        "in_proj_y": dense_init(gen, (D,), (R,), stddev=sd, dtype=dtype, lead=lead),
        "conv1d": {"kernel": _normal(gen, lead + (cfg.conv_width, R), sdh, dtype)},
        "rg_lru": {"a_param": a_param.to(torch.float32), "input_gate": gate(),
                   "a_gate": gate()},
        "out_proj": dense_init(gen, (R,), (D,), stddev=1.0 / math.sqrt(R), dtype=dtype,
                               lead=lead),
    }


def _block_diag_gate(gp, x, H: int, compute_dtype):
    """x (B,T,R) -> σ(blockdiag(W)·x + b) in fp32: one (dh, dh) block a head."""
    B, T, R = x.shape
    xh = x.reshape(B, T, H, R // H).to(compute_dtype)
    y = torch.einsum("bthi,hij->bthj", xh, as_dense(gp["kernel"], compute_dtype))
    y = y + gp["bias"].to(compute_dtype)
    return torch.sigmoid(y.to(torch.float32)).reshape(B, T, R)


def _conv_causal(kernel, x, state=None, seq_len: Optional[int] = None):
    """Depthwise causal conv, width W.  x (B,T,R); state (B,W-1,R) or None.
    Returns (y, new_state).  With ``seq_len`` only the first seq_len
    positions are real (bucketed prefill): the carried state is the window
    ending at seq_len, not at T.  The conv is causal, so real outputs never
    see the padded tail either way."""
    W = kernel.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+W-1, R)
    T = x.shape[1]
    y = sum(xp[:, i: i + T, :] * kernel[W - 1 - i].to(x.dtype) for i in range(W))
    if W <= 1:
        new_state = pad
    elif seq_len is None:
        new_state = xp[:, -(W - 1):, :]
    else:
        # inputs seq_len-W+1 .. seq_len-1 == xp[:, seq_len : seq_len+W-1]
        new_state = xp[:, int(seq_len): int(seq_len) + W - 1, :]
    return y, new_state


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gates(p, xc, H: int, compute_dtype):
    lru = p["rg_lru"]
    r = _block_diag_gate(lru["a_gate"], xc, H, compute_dtype)  # (B,T,R) fp32
    i = _block_diag_gate(lru["input_gate"], xc, H, compute_dtype)
    log_a = -C_FACTOR * _softplus(lru["a_param"].to(torch.float32)) * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xc.to(torch.float32))
    return a, gated_x


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along dim 1 (``even`` may be one longer)."""
    n_odd = odd.shape[1]
    pairs = torch.stack([even[:, :n_odd], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n_odd else torch.cat([pairs, even[:, n_odd:]], dim=1)


def _associative_scan(a, b):
    """Inclusive scan over dim 1 of the linear recurrence's elements (a, b)
    under (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2): ``jax.lax.associative_scan``'s
    recursion (pair adjacent elements, scan the half, fill in the even
    positions), so the combines happen in its order.  Returns (A, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a1, b1, a2, b2 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _associative_scan(a1 * a2, a2 * b1 + b2)
    if n % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    ea, eb = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], pa * ea], dim=1)
    even_b = torch.cat([b[:, :1], ea * pb + eb], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_block_apply(p, x, *, cfg: RGLRUConfig, compute_dtype=torch.bfloat16, h0=None,
                      seq_len: Optional[int] = None):
    """Full-sequence recurrent block, from the state ``h0`` (B, R) or zero
    (the conv window always starts empty).  Returns (y, final cache).

    With ``seq_len`` (bucketed prefill) positions >= seq_len are padding:
    identity recurrence steps (a = 1, input 0), so the carried ``h`` is the
    state after the seq_len-th real token, and the conv window is cut at
    seq_len: the cache equals an exact-length prefill's."""
    T = x.shape[1]
    xb = dense_apply(p["in_proj_x"], x, compute_dtype=compute_dtype)
    yb = F.gelu(dense_apply(p["in_proj_y"], x, compute_dtype=compute_dtype), approximate="tanh")
    xc, new_conv = _conv_causal(as_dense(p["conv1d"]["kernel"]), xb, seq_len=seq_len)
    a, gated_x = _gates(p, xc, cfg.n_heads, compute_dtype)
    if seq_len is not None:
        valid = (torch.arange(T, device=x.device) < seq_len)[None, :, None]
        a = torch.where(valid, a, 1.0)
        gated_x = torch.where(valid, gated_x, 0.0)
    if h0 is not None:
        # the carried state as a virtual first step: a_0 = 1, b_0 = h0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        gated_x = torch.cat([h0.to(torch.float32)[:, None, :], gated_x], dim=1)
    _, h = _associative_scan(a, gated_x)
    if h0 is not None:
        h = h[:, 1:]
    y = h.to(compute_dtype) * yb
    out = dense_apply(p["out_proj"], y, compute_dtype=compute_dtype)
    return out, {"h": h[:, -1], "conv": new_conv}


def rglru_init_cache(batch: int, cfg: RGLRUConfig, dtype=torch.float32, device=None,
                     lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros(lead + (batch, cfg.d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, cfg.d_rnn), dtype=dtype,
                            device=device),
    }


def rglru_block_decode(p, x, cache, *, cfg: RGLRUConfig, compute_dtype=torch.bfloat16):
    """Single-step decode: x (B,1,D) -> (y (B,1,D), new cache).  The new
    state comes out as new tensors; ``cache`` is only read."""
    xb = dense_apply(p["in_proj_x"], x, compute_dtype=compute_dtype)
    yb = F.gelu(dense_apply(p["in_proj_y"], x, compute_dtype=compute_dtype), approximate="tanh")
    xc, new_conv = _conv_causal(as_dense(p["conv1d"]["kernel"]), xb, cache["conv"])
    a, gated_x = _gates(p, xc, cfg.n_heads, compute_dtype)
    h = a[:, 0] * cache["h"] + gated_x[:, 0]  # (B,R) fp32
    y = h[:, None, :].to(compute_dtype) * yb
    out = dense_apply(p["out_proj"], y, compute_dtype=compute_dtype)
    return out, {"h": h, "conv": new_conv}
