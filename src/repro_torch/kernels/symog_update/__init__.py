from repro_torch.kernels.symog_update.ops import symog_update

__all__ = ["symog_update"]
