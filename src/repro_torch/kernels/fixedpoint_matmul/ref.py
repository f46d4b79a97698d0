"""Plain torch version of ``fixedpoint_matmul``: unpack, then matmul in fp32.
The CPU path of the wrapper and the oracle the CUDA kernels are held to."""
from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_int


def fixedpoint_matmul_ref(x, packed_w, f, bias=None, *, n_bits: int, n_out: int):
    """x (M, K) float; packed_w (K, n_out·n_bits/8) int8; f int scalar -> (M, N) f32."""
    m = unpack_int(packed_w, n_bits, n_out).to(torch.float32)
    scale = torch.exp2(-torch.as_tensor(f, device=x.device).to(torch.float32))
    y = (x.to(torch.float32) @ m) * scale
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y


def fixedpoint_matmul_experts_ref(x, packed_w, f, *, n_bits: int, n_out: int, rows=None):
    """x (E, C, K) float; packed_w (E, K, n_out·n_bits/8) int8; f (E,) ints
    -> (E, C, N) f32: y[e] = x[e] @ m[e] · 2^{-f[e]}.  With ``rows`` (E,),
    y[e] is +0 wherever rows[e] == 0 (selected, not computed from x[e], so
    no scale of an empty expert reaches the output); no host sync."""
    m = unpack_int(packed_w, n_bits, n_out).to(torch.float32)
    scale = torch.exp2(-torch.as_tensor(f, device=x.device).to(torch.float32))[:, None, None]
    y = torch.bmm(x.to(torch.float32), m) * scale
    if rows is not None:
        y = torch.where((rows > 0)[:, None, None], y, torch.zeros((), device=y.device))
    return y
