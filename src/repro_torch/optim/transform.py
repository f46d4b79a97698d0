"""Minimal optax-style gradient transformations (mirrors
``repro/optim/transform.py``).

A ``GradientTransformation`` is an (init, update) pair over nested-dict
trees of tensors:

    state            = tx.init(params)
    updates, state   = tx.update(grads, state, params, lr=...)
    new_params       = apply_updates(params, updates)

``update`` receives the current learning rate (a Python float) so schedules
live in the trainer.  Two fields tell ``train.make_train_step`` that it may
run the fused ``symog_update`` kernel in place of ``update``:

  ``paper_sgd``  the momentum μ, when the transformation is the paper's
                 optimizer: ``sgd`` with Nesterov, no weight decay and fp32
                 momentum, alone (its state is the momentum tree) or as
                 ``chain(clip_by_global_norm(c), sgd(...))`` (state[1] is);
  ``clip_norm``  c, set by ``clip_by_global_norm`` and by that chain.

Every other transformation, and every other chain, leaves both None.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.nn.tree import tree_leaves, tree_map


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]  # (grads, state, params, *, lr) -> (updates, state)
    paper_sgd: Optional[float] = None
    clip_norm: Optional[float] = None


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

    clipped_sgd = (len(txs) == 2 and txs[0].clip_norm is not None and txs[0].paper_sgd is None
                   and txs[1].paper_sgd is not None and txs[1].clip_norm is None)
    if clipped_sgd:
        return GradientTransformation(init, update, paper_sgd=txs[1].paper_sgd,
                                      clip_norm=txs[0].clip_norm)
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

    return GradientTransformation(init, update, clip_norm=float(max_norm))
