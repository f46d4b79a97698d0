"""The SYMOG training step (mirrors ``repro/train``)."""
from repro_torch.train.trainer import (
    TrainState,
    composed_update,
    fused_update,
    init_train_state,
    make_train_step,
)

__all__ = [
    "TrainState",
    "composed_update",
    "fused_update",
    "init_train_state",
    "make_train_step",
]
