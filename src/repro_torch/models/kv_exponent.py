"""The SYMOG KV exponent, and the scale it quantizes under, exactly as the
JAX reference computes them when serving.

The reference's ``block_scale_exp`` is ``ceil(log2(max(amax, 2^-30)) + 1 -
log2(qmax))`` in fp32, and its serving path runs it inside jitted traces
(the admission scatter, the decode step).  XLA's CPU backend compiles that
expression to

    e = ceil(fma(log(amax), f32(1/ln 2), f32(1 - log2(qmax))))

with ``log`` its own Cephes-style fp32 polynomial, every multiply-add of
which (and the one above) is a fused multiply-add.  ``torch.log`` /
``torch.log2`` round differently from that polynomial, and differently on
the CPU and on CUDA, so near the points where ``e`` steps (amax close to
qmax·2^k) the port's exponent moved a block's scale by a factor of two.

``jitted_exponent`` rebuilds that arithmetic from operations whose rounding
torch fixes on every device: fp32 / fp64 adds and multiplies, integer and
bit operations, and a correctly rounded fp32 fused multiply-add built from
them (``fma_f32``).  The jitted exponent is non-decreasing in amax over
every fp32 value, so ``e`` is fixed by the 40 amaxes at which it steps from
-20 up to 20; ``exponent_thresholds`` finds them by bisection on that
arithmetic, and the serving path's ``block_scale_exp``
(``models.attention``) compares against them: a few tensor operations per
call on any device, with the same bits as the full arithmetic.

The reference then quantizes under ``exp2(-e)``, which XLA compiles to
``exp(f32(-e)·f32(ln 2))`` with its own fp32 ``exp``: not a power of two
for |e| >= 13.  ``quant_scales`` holds those 41 values, from the same
arithmetic rebuilt (``_exp_f32``), so the port writes the reference's
words as well as its exponents.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

KV_EXP_MIN, KV_EXP_MAX = -20, 20  # exponent clamp (2^±20 stays finite)


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


# XLA's fp32 log: x = m·2^k with m in [sqrt(1/2), sqrt(2)), log(x) = p(m - 1)
# + k·ln 2, ln 2 split into 0.693359375 - 2.12194440e-4; p's coefficients
_LOG_P = [_f32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                            0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_LN2_LO, _LN2_HI = _f32(0xB95E8083), _f32(0x3F318000)
_SQRT_HALF = _f32(0x3F3504F3)
_INV_LN2 = _f32(0x3FB8AA3B)  # f32(1 / ln 2): XLA turns log(x) / log(2) into this product
_LN2 = _f32(0x3F317218)  # f32(ln 2): XLA's exp2(x) is exp(x·ln 2)
# XLA's fp32 exp: x = n·ln 2 + r, exp(x) = 2^n·(1 + r + r^2·q(r)); q's coefficients
_EXP_Q = [_f32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA)]
_EXP_LO, _EXP_HI = _f32(0xC2AF999A), _f32(0x42B1999A)  # its input clamp


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 ``a·b + c`` rounded once, as a fused multiply-add does.

    The product of two fp32 values is exact in fp64; TwoSum gives the fp64
    sum and its exact error; rounding that sum to odd (the last bit set
    when the sum was inexact) makes the final rounding to fp32 exact.  Every
    step is one IEEE fp64 add or multiply or an integer operation, so the
    bits are the same on every device."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else torch.full_like(p, c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    toward = torch.where((err > 0) == (s > 0), 1, -1)  # one fp64 step in err's direction
    return torch.where(inexact_even, bits + toward, bits).view(torch.float64).to(torch.float32)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 ``log`` for normal positive x, operation by operation."""
    bits = x.view(torch.int32)
    k = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # x = m·2^k, m in [1/2, 1)
    small = m < _SQRT_HALF
    r = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))  # m in [sqrt(1/2), sqrt(2)) - 1
    k = k - small.to(torch.float32)
    p = _LOG_P
    y1 = fma_f32(fma_f32(r, p[0], p[1]), r, p[2])
    y2 = fma_f32(fma_f32(r, p[3], p[4]), r, p[5])
    y3 = fma_f32(fma_f32(r, p[6], p[7]), r, p[8])
    r2 = r * r
    r3 = r2 * r
    y = fma_f32(fma_f32(r3, y1, y2), r3, y3)
    head = fma_f32(r2, -0.5, r)
    tail = fma_f32(r3, y, k * _LN2_LO)
    return fma_f32(k, _LN2_HI, head + tail)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 ``exp`` for x in its clamp range, operation by operation."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma_f32(x, _INV_LN2, 0.5)), -127, 127)
    r = fma_f32(n, -_LN2_HI, x)
    r = fma_f32(n, -_LN2_LO, r)
    y = torch.full_like(r, _EXP_Q[0])
    for c in _EXP_Q[1:] + [0.5]:
        y = fma_f32(y, r, c)
    y = fma_f32(y, r * r, r) + 1.0
    return y * torch.exp2(n)  # n is an integer in [-127, 127]: exact


def jitted_exponent(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """The reference's jitted ``block_scale_exp`` of per-entry amaxes (any
    shape, fp32), int32.  NaN gives 0 and +inf 20, as XLA's clamp and
    conversion do."""
    amax = amax.to(torch.float32)
    x = torch.clamp(amax, 2.0**-30, 2.0**64)  # log's argument stays normal and finite
    shift = float(np.float32(1.0) - np.float32(math.log2(qmax)))  # XLA folds 1 - log2(qmax)
    e = torch.clamp(torch.ceil(fma_f32(_log_f32(x), _INV_LN2, shift)), KV_EXP_MIN, KV_EXP_MAX)
    return torch.where(torch.isnan(amax), torch.zeros_like(e), e).to(torch.int32)


@functools.lru_cache(maxsize=None)
def exponent_thresholds(qmax: int) -> torch.Tensor:
    """fp32 (40,): entry i is the least amax whose jitted exponent is at
    least KV_EXP_MIN + 1 + i.  Bisection over the bit patterns of the
    non-negative fp32 values, all 40 at once, on the CPU."""
    want = torch.arange(KV_EXP_MIN + 1, KV_EXP_MAX + 1, dtype=torch.int32)
    lo = torch.zeros_like(want)  # 0.0: exponent KV_EXP_MIN, below every target
    hi = torch.full_like(want, int(np.float32(2.0**64).view(np.int32)))  # exponent KV_EXP_MAX
    while bool((hi - lo > 1).any()):
        mid = lo + (hi - lo) // 2
        up = jitted_exponent(mid.view(torch.float32), qmax) >= want
        hi, lo = torch.where(up, mid, hi), torch.where(up, lo, mid)
    return hi.view(torch.float32).clone()


@functools.lru_cache(maxsize=None)
def quant_scales() -> torch.Tensor:
    """fp32 (41,): entry e - KV_EXP_MIN is the reference's jitted
    ``exp2(-e)``, the factor a block of exponent e is quantized under."""
    e = torch.arange(KV_EXP_MIN, KV_EXP_MAX + 1, dtype=torch.float32)
    return _exp_f32(-e * _LN2)


_ON_DEVICE: dict = {}


def on_device(table, device: torch.device, *args) -> torch.Tensor:
    """``table(*args)`` (``exponent_thresholds`` or ``quant_scales``) on
    ``device``, copied there once."""
    key = (table, device) + args
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = table(*args).to(device)
    return _ON_DEVICE[key]
