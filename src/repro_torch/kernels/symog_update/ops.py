"""Public wrapper: the fused SYMOG update of one parameter tensor, in place.

``symog_update`` launches the CUDA kernel (``csrc/symog_update.cu``) for CUDA
tensors and runs its plain version (``ref.py``) for CPU tensors.  Either way
w and v are overwritten with (w', v') — JAX returns new arrays instead.  Any
shape; w, g and v must be contiguous fp32 tensors of one shape on one
device (no quiet cast).  ``delta`` is a Python float, a one-element fp32
tensor on that device, or a contiguous fp32 tensor of G values there, G
dividing ``w.numel()``: element i then takes ``delta[i // (numel / G)]``, the
JAX package's ``_delta_for`` broadcast of a per-expert f (G = L·E for an
(L, E, D, F) expert stack).  The trainer passes the leaf's 2^-f, made once,
so the host never reads f.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.symog_update.ref import symog_update_ref

launches = 0  # kernel launches (plain-version calls on the CPU do not count)
BLOCKS_PER_SM = 8


def _check(w, g, v, delta) -> torch.Tensor:
    for name, t in (("w", w), ("g", g), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"symog_update takes fp32 w, g, v; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"symog_update takes contiguous tensors; {name} is not")
        if t.shape != w.shape or t.device != w.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not match "
                             f"w {tuple(w.shape)} on {w.device}")
    if not isinstance(delta, torch.Tensor):
        return torch.tensor(float(delta), dtype=torch.float32, device=w.device)
    G, n = delta.numel(), w.numel()
    if (delta.dtype != torch.float32 or delta.device != w.device or not delta.is_contiguous()
            or G < 1 or (G > 1 and n % G)):
        raise ValueError(f"delta must be one fp32 value, or a contiguous fp32 tensor whose count "
                         f"divides w's {n} elements, on {w.device}; got {delta.dtype} "
                         f"{tuple(delta.shape)} on {delta.device}")
    return delta


def symog_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor, *, delta, lam_eff: float,
                 lr: float, mu: float, n_bits: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """w, v ← (w', v') of ``ref.symog_update_ref``; returns (w, v)."""
    global launches
    delta = _check(w, g, v, delta)
    qmax = float(2 ** (n_bits - 1) - 1)
    lam_eff, lr, mu = float(lam_eff), float(lr), float(mu)
    if not w.is_cuda:
        w_new, v_new = symog_update_ref(w, g, v, delta=delta, lam_eff=lam_eff, lr=lr, mu=mu,
                                        n_bits=n_bits)
        w.copy_(w_new)
        v.copy_(v_new)
        return w, v
    n = w.numel()
    group = max(1, n // delta.numel())  # elements per Δ (n: one Δ)
    blocks = max(1, min(math.ceil(n / (4 * 256)), BLOCKS_PER_SM * build.sm_count(w.device)))
    err = build.library().symog_update_launch(
        w.data_ptr(), g.data_ptr(), v.data_ptr(), delta.data_ptr(), n, group, lam_eff, lr, mu,
        qmax, blocks, build.current_stream(w.device),
    )
    build.check(err, "symog_update")
    launches += 1
    return w, v
