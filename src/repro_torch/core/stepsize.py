"""Per-layer step-size initialization (paper Alg. 1, lines 2–5):

    f_l = argmin_{f ∈ ℤ}  || W_l - Q_N(W_l; 2^{-f}) ||²

An exhaustive integer search over [F_MIN, F_MAX]; ties go to the smaller f
(``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does).  f* is
``f_min`` plus the argmin's index, computed on the device: no value is read
back to the host, so the search runs under ``FakeTensorMode`` and costs no
device sync."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quantizer import delta_from_f, quantize

F_MIN = -4
F_MAX = 16


def sse_for_f(w: torch.Tensor, f, n_bits: int) -> torch.Tensor:
    d = delta_from_f(f, device=w.device)
    err = w - quantize(w, d, n_bits)
    return torch.sum(torch.square(err.to(torch.float32)))


def optimal_f(
    w: torch.Tensor, n_bits: int, f_min: int = F_MIN, f_max: int = F_MAX
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (f*, Δ*=2^{-f*}) minimizing the quantization SSE of ``w``."""
    fs = torch.arange(f_min, f_max + 1, device=w.device)
    sses = torch.stack([sse_for_f(w, f, n_bits) for f in fs])
    f_star = f_min + torch.argmin(sses)
    return f_star, delta_from_f(f_star)
