"""Schedules (paper §3.3 + Alg. 1 lines 7–8; mirrors ``repro/core/schedule.py``).

λ grows exponentially:  λ(e) = λ_0 · exp(α_E · e)    — weak prior early,
overwhelming prior late (quantization error → 0).
η decays linearly:      η(e) = η_0 - (η_0 - η_E)·e/E  (recommended 0.01→0.001).

Each schedule maps a Python int step to a Python float.  The arithmetic runs
on fp32 tensors in the JAX package's order, so η (+, −, ×, ÷, clip) equals
JAX's bit for bit; exp and cos are fp32 too, but torch's and XLA's fp32
exp/cos differ in the last bit for some arguments.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def exponential_lambda(
    lambda0: float = 10.0, alpha: float = 9.0, total_steps: int = 1000
) -> Schedule:
    """λ(s) = λ_0 · exp(α · s / total_steps)."""

    def fn(step: int) -> float:
        frac = _f32(step) / max(total_steps, 1)
        return float(_f32(lambda0) * torch.exp(_f32(alpha) * frac))

    return fn


def linear_lr(eta0: float = 0.01, eta_end: float = 0.001, total_steps: int = 1000) -> Schedule:
    def fn(step: int) -> float:
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return float(_f32(eta0) - _f32(eta0 - eta_end) * frac)

    return fn


def constant(value: float) -> Schedule:
    def fn(step: int) -> float:
        del step
        return float(_f32(value))

    return fn


def cosine_lr(eta0: float, eta_end: float, total_steps: int, warmup_steps: int = 0) -> Schedule:
    """Cosine decay with linear warmup (the transformer examples' schedule)."""

    def fn(step: int) -> float:
        s = _f32(step)
        if step < warmup_steps:
            return float(_f32(eta0) * s / max(warmup_steps, 1))
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = _f32(eta_end) + _f32(0.5 * (eta0 - eta_end)) * (1 + torch.cos(math.pi * prog))
        return float(cos)

    return fn
