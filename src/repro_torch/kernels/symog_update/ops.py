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

``gscale`` scales the total gradient (the clip scale s of
``chain(clip_by_global_norm(c), sgd)``): a Python float, or a one-element
fp32 tensor on w's device that the kernel reads there, so the host never
waits for s.  ``symog_sqnorm`` is the clip's norm pass over one leaf,
Σ (g + λ_eff·(w − q))², a 0-d fp32 tensor on w's device; the kernel sums in
a fixed order, so two calls give the same bits.  ``launches`` counts the
update kernel's launches, ``sqnorm_launches`` the norm pass's.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.symog_update.ref import symog_sqnorm_ref, symog_update_ref

launches = 0  # update kernel launches (plain-version calls on the CPU do not count)
sqnorm_launches = 0  # norm-pass kernel launches
BLOCKS_PER_SM = 8


def _check(w, g, v, delta) -> torch.Tensor:
    """Δ as a tensor on w's device; v is None for the norm pass."""
    for name, t in [("w", w), ("g", g)] + ([("v", v)] if v is not None else []):
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


def _check_gscale(w, gscale):
    if not isinstance(gscale, torch.Tensor):
        return None, float(gscale)
    if (gscale.numel() != 1 or gscale.dtype != torch.float32 or gscale.device != w.device):
        raise ValueError(f"gscale must be a float or one fp32 value on {w.device}; got "
                         f"{gscale.dtype} {tuple(gscale.shape)} on {gscale.device}")
    return gscale, 1.0


def _blocks(w: torch.Tensor) -> int:
    return max(1, min(math.ceil(w.numel() / (4 * 256)), BLOCKS_PER_SM * build.sm_count(w.device)))


def symog_update(w: torch.Tensor, g: torch.Tensor, v: torch.Tensor, *, delta, lam_eff: float,
                 lr: float, mu: float, n_bits: int = 2,
                 gscale=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """w, v ← (w', v') of ``ref.symog_update_ref``; returns (w, v)."""
    global launches
    delta = _check(w, g, v, delta)
    scale_t, scale_v = _check_gscale(w, gscale)
    qmax = float(2 ** (n_bits - 1) - 1)
    lam_eff, lr, mu = float(lam_eff), float(lr), float(mu)
    if not w.is_cuda:
        w_new, v_new = symog_update_ref(w, g, v, delta=delta, lam_eff=lam_eff, lr=lr, mu=mu,
                                        n_bits=n_bits, gscale=gscale)
        w.copy_(w_new)
        v.copy_(v_new)
        return w, v
    n = w.numel()
    group = max(1, n // delta.numel())  # elements per Δ (n: one Δ)
    err = build.library().symog_update_launch(
        w.data_ptr(), g.data_ptr(), v.data_ptr(), delta.data_ptr(),
        scale_t.data_ptr() if scale_t is not None else None, n, group, lam_eff, lr, mu, qmax,
        scale_v, _blocks(w), build.current_stream(w.device),
    )
    build.check(err, "symog_update")
    launches += 1
    return w, v


def symog_sqnorm(w: torch.Tensor, g: torch.Tensor, *, delta, lam_eff: float,
                 n_bits: int = 2) -> torch.Tensor:
    """Σ (g + λ_eff·(w − q))² of ``ref.symog_sqnorm_ref``: a 0-d fp32 tensor."""
    global sqnorm_launches
    delta = _check(w, g, None, delta)
    qmax = float(2 ** (n_bits - 1) - 1)
    if not w.is_cuda:
        return symog_sqnorm_ref(w, g, delta=delta, lam_eff=float(lam_eff), n_bits=n_bits)
    n, blocks = w.numel(), _blocks(w)
    # [partials (blocks) | done counter (0 bits) | out]
    scratch = torch.zeros(blocks + 2, dtype=torch.float32, device=w.device)
    base, four = scratch.data_ptr(), scratch.element_size()
    err = build.library().symog_sqnorm_launch(
        w.data_ptr(), g.data_ptr(), delta.data_ptr(), n, max(1, n // delta.numel()),
        float(lam_eff), qmax, base, base + blocks * four, base + (blocks + 1) * four, blocks,
        build.current_stream(w.device),
    )
    build.check(err, "symog_sqnorm")
    sqnorm_launches += 1
    return scratch[blocks + 1]
