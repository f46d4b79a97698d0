"""SGD with Nesterov momentum — the paper's optimizer (§4: momentum 0.9);
mirrors ``repro/optim/sgd.py``.

    v   ← μ·v + g
    u   ← g + μ·v        (nesterov)   |   u ← v   (classical)
    w   ← w − η·u
"""
from __future__ import annotations

import torch

from repro_torch.nn.tree import tree_map
from repro_torch.optim.transform import GradientTransformation


def sgd(momentum: float = 0.9, nesterov: bool = True, weight_decay: float = 0.0,
        momentum_dtype=torch.float32) -> GradientTransformation:
    """``momentum_dtype=torch.bfloat16`` halves optimizer-state memory; the
    update math still runs in fp32."""

    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=momentum_dtype), params)

    def update(grads, state, params, *, lr):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype), grads, params)
        f32 = torch.float32
        new_v = tree_map(lambda v, g: momentum * v.to(f32) + g.to(f32), state, grads)
        if nesterov:
            upd = tree_map(lambda g, v: -(lr * (g.to(f32) + momentum * v)), grads, new_v)
        else:
            upd = tree_map(lambda v: -(lr * v), new_v)
        return upd, tree_map(lambda v: v.to(momentum_dtype), new_v)

    paper = nesterov and not weight_decay and momentum_dtype == torch.float32
    return GradientTransformation(init, update, paper_sgd=float(momentum) if paper else None)
