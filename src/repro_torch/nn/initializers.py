"""Weight initializers (mirrors ``repro/nn/initializers.py``): each factory
returns ``init(gen, shape, dtype=torch.float32)``, a function of an
explicit ``torch.Generator``.  Values are drawn in fp32 on the generator's
device, then cast.  The laws are JAX's; ``jax.random``'s bits are not
reproduced."""
from __future__ import annotations

import math
from typing import Sequence

import torch

# std of a unit normal truncated to ±2σ (jax.nn.initializers' correction)
TRUNC2_STD = 0.87962566


def _normal(gen: torch.Generator, shape, stddev: float, dtype) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * stddev).to(dtype)


def normal_init(stddev: float = 0.02):
    def init(gen, shape, dtype=torch.float32):
        return _normal(gen, shape, stddev, dtype)

    return init


def truncated_normal_stddev(stddev: float):
    """A normal truncated to ±2σ, scaled so its std is ``stddev``."""

    def init(gen, shape, dtype=torch.float32):
        x = torch.empty(tuple(shape), device=gen.device, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (x * (stddev / TRUNC2_STD)).to(dtype)

    return init


def scaled_normal(scale: float = 1.0, fan_axis: int = 0):
    """stddev = sqrt(scale / fan_in) where fan_in = shape[fan_axis]."""

    def init(gen, shape, dtype=torch.float32):
        return _normal(gen, shape, math.sqrt(scale / max(shape[fan_axis], 1)), dtype)

    return init


def _fan_in(shape: Sequence[int], in_axes) -> int:
    return max(math.prod(shape[a] for a in in_axes), 1)


def he_normal(in_axes=(0,)):
    def init(gen, shape, dtype=torch.float32):
        return _normal(gen, shape, math.sqrt(2.0 / _fan_in(shape, in_axes)), dtype)

    return init


def lecun_normal(in_axes=(0,)):
    def init(gen, shape, dtype=torch.float32):
        return _normal(gen, shape, math.sqrt(1.0 / _fan_in(shape, in_axes)), dtype)

    return init


def zeros_init():
    def init(gen, shape, dtype=torch.float32):
        return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)

    return init


def ones_init():
    def init(gen, shape, dtype=torch.float32):
        return torch.ones(tuple(shape), dtype=dtype, device=gen.device)

    return init
