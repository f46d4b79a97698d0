"""Primitive layers: projections, norms, embeddings, RoPE, activations
(mirrors ``repro/models/layers.py``; params are plain dicts of tensors with
the JAX package's names).

Initializers draw from an explicit ``torch.Generator`` on the target device;
``lead`` prepends stacked-layer dims, so a scan group is drawn in one call.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.quantized import as_dense, is_packed, packed_dense_apply, packed_take


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    # scaled in place: one full-size temporary, not two (a deepseek-v3 expert
    # stack is 15 GB in fp32)
    return torch.randn(tuple(shape), generator=gen, device=gen.device).mul_(std).to(dtype)


def dense_init(gen, in_dims: Sequence[int], out_dims: Sequence[int], *, bias: bool = False,
               stddev: Optional[float] = None, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """General projection: kernel shape (*lead, *in_dims, *out_dims)."""
    in_dims, out_dims = tuple(in_dims), tuple(out_dims)
    std = stddev if stddev is not None else 1.0 / math.sqrt(math.prod(in_dims))
    p = {"kernel": _normal(gen, lead + in_dims + out_dims, std, dtype)}
    if bias:
        p["bias"] = torch.zeros(lead + out_dims, dtype=dtype, device=gen.device)
    return p


# On the card a float matmul runs at a multiple of ROW_TILE rows, zero
# rows appended: cuBLAS picks its kernel, and with it each row's rounding,
# from the row count, so without this a decode or verify row's bits would
# depend on how many slots share the step (and a sampled stream on the slot
# count).  A row's output then depends on its own row alone.
ROW_TILE = 64


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with rows batch-invariant on the card."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    M = x2.shape[0]
    pad = -M % ROW_TILE if x2.is_cuda else 0
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    return torch.matmul(x2, w)[:M].reshape(*lead, w.shape[-1])


def dense_apply(p, x, *, n_in: int = 1, compute_dtype=None):
    """Contract the last ``n_in`` dims of x with the first n_in of the kernel.
    A ``Packed`` kernel dispatches to the fixed-point matmul."""
    k = p["kernel"]
    if is_packed(k):
        return packed_dense_apply(p, x, n_in=n_in, compute_dtype=compute_dtype)
    if compute_dtype is not None:
        x, k = x.to(compute_dtype), k.to(compute_dtype)
    in_dims, out_dims = k.shape[:n_in], k.shape[n_in:]
    y = matmul_rows(x.reshape(*x.shape[: x.ndim - n_in], math.prod(in_dims)),
                    k.reshape(math.prod(in_dims), math.prod(out_dims)))
    y = y.reshape(*y.shape[:-1], *out_dims)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def rmsnorm_init(dim: int, dtype=torch.float32, device=None, lead: Tuple[int, ...] = ()):
    return {"scale": torch.zeros(lead + (dim,), dtype=dtype, device=device)}  # (1+scale)


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None, lead: Tuple[int, ...] = ()):
    return {
        "scale": torch.ones(lead + (dim,), dtype=dtype, device=device),
        "bias": torch.zeros(lead + (dim,), dtype=dtype, device=device),
    }


def layernorm_apply(p, x, *, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(x.dtype)


def embed_init(gen, vocab: int, dim: int, *, stddev: float = 0.02, dtype=torch.float32):
    return {"embedding": _normal(gen, (vocab, dim), stddev, dtype)}


def embed_apply(p, ids, *, compute_dtype=None):
    e = p["embedding"]
    if is_packed(e):  # gather packed rows, dequantize only those
        return packed_take(e, ids, dtype=compute_dtype)
    if compute_dtype is not None:
        e = e.to(compute_dtype)
    return e[ids]


def embed_logits(p, x):
    """Tied read-out x @ E^T in fp32.  A Packed table is dequantized whole on
    every call, as in the JAX package (92544x2048 fp32 at full width)."""
    e = as_dense(p["embedding"], torch.float32)
    return matmul_rows(x.to(torch.float32), e.t())


@functools.lru_cache(maxsize=64)
def _rope_freq(base: float, half: int, device: torch.device) -> torch.Tensor:
    """exp(-ln(base)·i/half) in fp32, as the JAX package computes it; built
    on the device once per (base, width) — every layer of every step reuses it."""
    lb = torch.log(torch.full((), base, dtype=torch.float32, device=device))
    return torch.exp(-lb * (torch.arange(half, dtype=torch.float32, device=device) / half))


def rope_table(positions: torch.Tensor, base, hd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos2, sin2), each (..., T, 1, hd): [cos, cos] and [-sin, sin] of the
    angles positions·freq.  Every layer with this base shares one table."""
    half = hd // 2
    ang = positions[..., None].to(torch.float32) * _rope_freq(float(base), half, positions.device)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base, table=None) -> torch.Tensor:
    """x: (..., T, H, hd); positions broadcastable to (..., T).  ``table``
    is ``rope_table(positions, base, hd)`` when the caller shares one.

    [x1·cos - x2·sin, x2·cos + x1·sin] in fp32, written as
    x·[cos, cos] + [x2, x1]·[-sin, sin] — the same IEEE operations (a - b is
    a + (-b) exactly), so the result equals the JAX package's bit for bit."""
    hd = x.shape[-1]
    half = hd // 2
    cos2, sin2 = table if table is not None else rope_table(positions, base, hd)
    xf = x.to(torch.float32)
    rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos2 + rot * sin2).to(x.dtype)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu,
        "relu": F.relu,
    }[name]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style logit soft capping: cap·tanh(x/cap)."""
    return (cap * torch.tanh(logits.to(torch.float32) / cap)).to(logits.dtype)
