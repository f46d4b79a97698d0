"""Device resolution shared by every entry point of the port.

Entry points (``init_lm``, ``ServeEngine``, ``ServeEngine.from_symog``) run
on the card unless the caller asks for the CPU explicitly, as the CPU tests
do.  With no CUDA device and no explicit ``device`` they raise instead of
silently running on the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card: ``cuda`` when available, else RuntimeError."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the port on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
