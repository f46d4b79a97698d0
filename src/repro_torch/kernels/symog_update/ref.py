"""Plain torch version of the fused SYMOG update (paper Alg. 1, lines 15–17),
ported from ``repro/kernels/symog_update/ref.py``.  The CPU path of the
wrapper and the oracle the CUDA kernel is held to.

Semantics (per layer l, SGD + Nesterov momentum μ):

    q     = Clip(round(w/Δ), ±(2^{N-1}-1))·Δ
    g_tot = (g + λ_eff·(w − q))·s        # λ_eff = λ·2/M_l folded outside
    v'    = μ·v + g_tot
    w'    = Clip(w − η·(g_tot + μ·v'), ±Δ(2^{N-1}-1))

Δ is one value, or G values over G leading groups of equal size (element i
takes Δ[i // (numel / G)]: the JAX package's per-expert ``_delta_for``).
s (``gscale``) is the clip scale of ``chain(clip_by_global_norm(c), sgd)``,
min(1, c/(√Σ + 1e-9)), with Σ summed over every leaf by the norm pass
``symog_sqnorm_ref``: Σ (g + λ_eff·(w − q))² on one leaf.  s = 1 (the
default) is the unclipped step: ×1 is exact.
"""
from __future__ import annotations

import torch


def _total_grad(w, g, delta, lam_eff, n_bits: int):
    """(g + λ_eff·(w − q)) in fp32, one row per Δ, and the row-shaped Δ."""
    qmax = 2 ** (n_bits - 1) - 1
    delta = torch.as_tensor(delta, dtype=torch.float32, device=w.device)
    G = delta.numel()
    wf = w.to(torch.float32).reshape(G, -1)  # one row per Δ
    delta = delta.reshape(G, 1)
    q = torch.clamp(torch.round(wf / delta), -qmax, qmax) * delta
    return wf, delta, g.to(torch.float32).reshape(G, -1) + lam_eff * (wf - q)


def symog_sqnorm_ref(w, g, *, delta, lam_eff, n_bits: int) -> torch.Tensor:
    """Σ (g + λ_eff·(w − q))² over the leaf: a 0-d fp32 tensor."""
    _, _, g_tot = _total_grad(w, g, delta, lam_eff, n_bits)
    return torch.sum(g_tot * g_tot)


def symog_update_ref(w, g, v, *, delta, lam_eff, lr, mu, n_bits: int, gscale=1.0):
    """Returns new (w', v') in the dtypes of w and v; the inputs are untouched."""
    qmax = 2 ** (n_bits - 1) - 1
    wf, delta, g_tot = _total_grad(w, g, delta, lam_eff, n_bits)
    g_tot = g_tot * gscale
    v_new = mu * v.to(torch.float32).reshape(wf.shape) + g_tot
    upd = g_tot + mu * v_new
    lim = delta * qmax
    w_new = torch.clamp(wf - lr * upd, -lim, lim)
    return w_new.reshape(w.shape).to(w.dtype), v_new.reshape(v.shape).to(v.dtype)
