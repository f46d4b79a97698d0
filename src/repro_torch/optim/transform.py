"""Minimal optax-style gradient transformations (mirrors
``repro/optim/transform.py``).

A ``GradientTransformation`` is an (init, update) pair over nested-dict
trees of tensors:

    state            = tx.init(params)
    updates, state   = tx.update(grads, state, params, lr=...)
    new_params       = apply_updates(params, updates)

``update`` receives the current learning rate (a Python float) so schedules
live in the trainer.  ``paper_sgd`` is set by ``sgd`` alone, to its momentum,
when it is the paper's optimizer (Nesterov, no weight decay, fp32 momentum):
``train.make_train_step`` may then run the fused ``symog_update`` kernel in
its place.  Every other transformation, a chain included, leaves it None.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.nn.tree import tree_leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (grads, state, params, *, lr) -> (updates, state)
    paper_sgd: Optional[float] = None


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u.to(p.dtype)) if u is not None else p, params, updates)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(grads, state, params, *, lr):
        new_state = []
        for tx, s in zip(txs, state):
            grads, s = tx.update(grads, s, params, lr=lr)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda p: (), lambda g, s, p, *, lr: (g, s))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (sorted-path order)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params, *, lr):
        scale = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
        return tree_map(lambda g: g * scale.to(g.dtype), grads), state

    return GradientTransformation(init, update)
