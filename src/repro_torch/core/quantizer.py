"""The symmetric uniform fixed-point quantizer Q_N (paper Eq. 1).

    Q_N(x; Δ) = Clip(round(x/Δ), -(2^{N-1}-1), 2^{N-1}-1) · Δ

with Δ = 2^{-f}, f ∈ ℤ: the dequantization scale is a pure exponent shift,
exact in any binary float format.  ``torch.round`` rounds half to even, as
``jnp.round`` does, so mantissas are bit-identical to the JAX package's.
"""
from __future__ import annotations

import torch


def qmax_int(n_bits: int) -> int:
    """Largest mantissa magnitude: 2^{N-1} - 1."""
    return 2 ** (n_bits - 1) - 1


def delta_from_f(f, device=None) -> torch.Tensor:
    """Δ = 2^{-f} as float32 (exact for integer f)."""
    f = torch.as_tensor(f, device=device)
    return torch.exp2(-f.to(torch.float32))


def quantize_int(x: torch.Tensor, delta, n_bits: int) -> torch.Tensor:
    """Signed integer mantissa m = Clip(round(x/Δ)) in [-qmax, qmax] (x's dtype)."""
    q = qmax_int(n_bits)
    return torch.clamp(torch.round(x / delta), -q, q)


def quantize(x: torch.Tensor, delta, n_bits: int) -> torch.Tensor:
    """Q_N(x; Δ): dequantized fixed-point value in x's dtype."""
    delta = torch.as_tensor(delta, device=x.device).to(x.dtype)
    return (quantize_int(x, delta, n_bits) * delta).to(x.dtype)


def quantize_ste(x: torch.Tensor, delta, n_bits: int) -> torch.Tensor:
    """Straight-through variant: forward Q_N, gradient identity (JAX's
    ``x + stop_gradient(Q_N(x) - x)``, the same ops in the same order).

    Not used by SYMOG training itself (the paper's gradient flows through
    the real-valued weights) but provided for the hard-quantization
    baselines (BinaryConnect-style)."""
    return x + (quantize(x, delta, n_bits) - x).detach()


def quant_error(x: torch.Tensor, delta, n_bits: int) -> torch.Tensor:
    """w - Q_N(w; Δ)."""
    return x - quantize(x, delta, n_bits)


def clip_range(delta, n_bits: int):
    """The fixed-point solution interval [-Δ·qmax, +Δ·qmax]."""
    lim = torch.as_tensor(delta).to(torch.float32) * qmax_int(n_bits)
    return -lim, lim


def clip_to_range(x: torch.Tensor, delta, n_bits: int) -> torch.Tensor:
    """Paper §3.4 weight clipping."""
    lo, hi = clip_range(delta, n_bits)
    return torch.clamp(x, lo.to(x.device, x.dtype), hi.to(x.device, x.dtype))
