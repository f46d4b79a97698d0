"""Plain torch version of the fused SYMOG update (paper Alg. 1, lines 15–17),
ported from ``repro/kernels/symog_update/ref.py``.  The CPU path of the
wrapper and the oracle the CUDA kernel is held to.

Semantics (per layer l, SGD + Nesterov momentum μ):

    q     = Clip(round(w/Δ), ±(2^{N-1}-1))·Δ
    g_tot = g + λ_eff·(w − q)            # λ_eff = λ·2/M_l folded outside
    v'    = μ·v + g_tot
    w'    = Clip(w − η·(g_tot + μ·v'), ±Δ(2^{N-1}-1))

Δ is one value, or G values over G leading groups of equal size (element i
takes Δ[i // (numel / G)]: the JAX package's per-expert ``_delta_for``).
"""
from __future__ import annotations

import torch


def symog_update_ref(w, g, v, *, delta, lam_eff, lr, mu, n_bits: int):
    """Returns new (w', v') in the dtypes of w and v; the inputs are untouched."""
    qmax = 2 ** (n_bits - 1) - 1
    delta = torch.as_tensor(delta, dtype=torch.float32, device=w.device)
    G = delta.numel()
    wf = w.to(torch.float32).reshape(G, -1)  # one row per Δ
    delta = delta.reshape(G, 1)
    q = torch.clamp(torch.round(wf / delta), -qmax, qmax) * delta
    g_tot = g.to(torch.float32).reshape(G, -1) + lam_eff * (wf - q)
    v_new = mu * v.to(torch.float32).reshape(G, -1) + g_tot
    upd = g_tot + mu * v_new
    lim = delta * qmax
    w_new = torch.clamp(wf - lr * upd, -lim, lim)
    return w_new.reshape(w.shape).to(w.dtype), v_new.reshape(v.shape).to(v.dtype)
