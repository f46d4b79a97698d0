"""PyTorch / CUDA port of the SYMOG serving path (``repro`` is the JAX
reference).  Importing this package never imports ``jax`` or ``repro`` and
never builds a kernel: the hand-written Hopper kernels under ``csrc/`` are
compiled by ``nvcc`` at their first launch (``kernels/build.py``)."""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
