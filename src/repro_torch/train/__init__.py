"""The SYMOG training step (mirrors ``repro/train``)."""
from repro_torch.train.trainer import (
    CNNTrainState,
    TrainState,
    composed_update,
    fused_update,
    init_train_state,
    make_cnn_eval,
    make_cnn_train_step,
    make_train_step,
    softmax_xent,
)

__all__ = [
    "CNNTrainState",
    "TrainState",
    "composed_update",
    "fused_update",
    "init_train_state",
    "make_cnn_eval",
    "make_cnn_train_step",
    "make_train_step",
    "softmax_xent",
]
