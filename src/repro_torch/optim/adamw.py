"""AdamW — used by the transformer examples (beyond-paper substrate); mirrors
``repro/optim/adamw.py``.  Decoupled weight decay; bias-corrected first and
second moments kept in fp32."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.nn.tree import tree_map
from repro_torch.optim.transform import GradientTransformation


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: int


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> GradientTransformation:
    f32 = torch.float32

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=f32)

        return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params), count=0)

    def update(grads, state, params, *, lr):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(f32), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(f32)), state.nu, grads)
        # 1 - b^count in fp32, as JAX computes it from the int32 count
        c1 = float(1 - torch.tensor(b1, dtype=f32) ** torch.tensor(count, dtype=f32))
        c2 = float(1 - torch.tensor(b2, dtype=f32) ** torch.tensor(count, dtype=f32))

        def upd(m, v, p):
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(f32)
            return -lr * step

        return tree_map(upd, mu, nu, params), AdamWState(mu=mu, nu=nu, count=count)

    return GradientTransformation(init, update)
