"""Bit-packing of SYMOG mantissas for serving.

For N ∈ {2, 4} we pack 4 (resp. 2) mantissas per int8 byte along the last
axis.  Layout: value i of a group lands in bits [i·N, (i+1)·N) of the byte
(little-endian within byte), two's-complement within the N-bit field —
byte for byte the JAX package's layout, so a packed artifact bridges as is.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.quantizer import delta_from_f, quantize_int


@dataclasses.dataclass
class Packed:
    """A packed fixed-point tensor: int8 words, the bit width, and the
    integer exponent ``f`` (int32 scalar, or one per leading layer/expert).
    The unpacked shape is derived from the words: last dim · (8/n_bits)."""

    data: torch.Tensor  # int8, shape[..., last/per_byte]
    n_bits: int
    f: torch.Tensor  # int32

    @property
    def shape(self) -> Tuple[int, ...]:
        per = 8 // self.n_bits
        return tuple(self.data.shape[:-1]) + (self.data.shape[-1] * per,)

    def to(self, device) -> "Packed":
        return Packed(self.data.to(device), self.n_bits, self.f.to(device))


def values_per_byte(n_bits: int) -> int:
    if n_bits not in (2, 4, 8):
        raise ValueError(f"packing supports n_bits in (2,4,8), got {n_bits}")
    return 8 // n_bits


def pack_int(m: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Pack integer mantissas (values fit N-bit signed) into int8 words along
    the last axis.  The last dim must be divisible by 8//n_bits."""
    per = values_per_byte(n_bits)
    if n_bits == 8:
        return m.to(torch.int8)
    *lead, last = m.shape
    if last % per != 0:
        raise ValueError(f"last dim {last} not divisible by {per}")
    mask = (1 << n_bits) - 1
    g = m.to(torch.int32).reshape(*lead, last // per, per) & mask
    shifts = torch.arange(per, dtype=torch.int32, device=m.device) * n_bits
    word = torch.sum(g << shifts, dim=-1, dtype=torch.int32)  # < 256: no int64 copy
    return word.to(torch.uint8).view(torch.int8)


def unpack_int(packed: torch.Tensor, n_bits: int, last_dim: int) -> torch.Tensor:
    """Inverse of pack_int: int8 words -> sign-extended int8 mantissas."""
    per = values_per_byte(n_bits)
    if n_bits == 8:
        return packed.to(torch.int8)
    mask = (1 << n_bits) - 1
    sign = 1 << (n_bits - 1)
    # byte-wide throughout: fields < 2^n_bits, so (f ^ sign) fits int8 and the
    # sign extension (f ^ sign) - sign is exact in int8 — no int32 copies of
    # the table (the tied head unpacks 92544x2048 per call)
    w = packed.view(torch.uint8)
    shifts = torch.arange(0, 8, n_bits, dtype=torch.uint8, device=packed.device)
    fields = (w[..., None] >> shifts) & mask
    vals = (fields ^ sign).view(torch.int8) - sign
    out = vals.reshape(*packed.shape[:-1], packed.shape[-1] * per)
    if out.shape[-1] != last_dim:
        raise ValueError(f"unpacked last dim {out.shape[-1]} != {last_dim}")
    return out


def pack(weight: torch.Tensor, f, n_bits: int) -> Packed:
    """Quantize a converged SYMOG weight and pack its mantissas.  A stacked
    leaf (rank >= 3) is packed one leading slice at a time, so the
    quantizer's temporaries stay one layer large (an olmoe-1b-7b expert
    stack holds 2^31 values); the words are the same."""
    f = torch.as_tensor(f, device=weight.device)
    if weight.ndim < 3:
        return Packed(data=_pack_words(weight, f, n_bits), n_bits=n_bits, f=f.to(torch.int32))
    per = values_per_byte(n_bits)
    data = torch.empty(tuple(weight.shape[:-1]) + (weight.shape[-1] // per,), dtype=torch.int8,
                       device=weight.device)
    for i in range(weight.shape[0]):
        data[i] = _pack_words(weight[i], f[i] if f.ndim else f, n_bits)
    return Packed(data=data, n_bits=n_bits, f=f.to(torch.int32))


def _pack_words(weight: torch.Tensor, f: torch.Tensor, n_bits: int) -> torch.Tensor:
    delta = delta_from_f(f)
    while delta.ndim < weight.ndim:  # per-expert f broadcasts over trailing dims
        delta = delta[..., None]
    return pack_int(quantize_int(weight, delta, n_bits), n_bits)


def unpack(p: Packed, dtype=torch.float32) -> torch.Tensor:
    """Dequantize to ``dtype``: m · 2^{-f} (exact: exponent-only scale).
    int8 mantissas times a ``dtype`` scale promote to ``dtype`` in one pass."""
    m = unpack_int(p.data, p.n_bits, p.shape[-1])
    scale = torch.exp2(-p.f.to(dtype))
    while 0 < scale.ndim < m.ndim:
        scale = scale[..., None]
    return m * scale
