"""Optimizers: SGD+Nesterov (paper), AdamW, transformation chains (mirrors
``repro/optim``)."""
from repro_torch.optim.adamw import adamw
from repro_torch.optim.sgd import sgd
from repro_torch.optim.transform import (
    GradientTransformation,
    apply_updates,
    chain,
    clip_by_global_norm,
    global_norm,
    identity,
)

__all__ = [
    "GradientTransformation",
    "adamw",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "global_norm",
    "identity",
    "sgd",
]
