from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    load_manifest,
    load_pytree,
    save_pytree,
)

__all__ = ["CheckpointManager", "load_manifest", "load_pytree", "save_pytree"]
