"""Mixture-of-Experts with top-k routing and capacity-bounded dispatch
(mirrors ``repro/models/moe.py``).

Dispatch is scatter/gather based (GShard capacity semantics): assignments
are numbered slot-major (all top-1 choices before any top-2), an expert
takes at most C of them, and the rest are dropped (they contribute zero).
Expert weights are stacked with a leading expert dim; a ``Packed`` stack
(one SYMOG Δ per expert) runs the experts form of the fixed-point matmul,
one launch per projection for all experts.

Routers: ``softmax`` (olmoe) and ``sigmoid`` (deepseek-v3), gates
normalized over the selected k.  Router math is fp32; router weights stay
unquantized.

Two places where torch idiom would change the JAX package's numbers, and
what this module does instead:
  * dropped assignments are left out of the dispatch scatter (they go to a
    dump row past the buffer), so no dropped token can overwrite the token
    that owns its slot, and no scatter accumulates;
  * the combine sums each token's k weighted expert outputs in slot order,
    in the compute dtype, one add at a time — the order of JAX's sequential
    scatter-add — so bf16 results are deterministic (no atomics).

The backward is deterministic too.  The dispatch reads ``xb.repeat(k, 1)``,
whose backward sums a token's k copies (a reduction, no atomics); the
dispatch write's backward is a gather, and the dump row's grad is cut off
with it.  The combine gather's backward is a gather as well
(``_CombineGather``): each kept row gets its one assignment's grad, and a
dropped read is weighted by 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import act_fn, dense_apply, dense_init
from repro_torch.models.quantized import is_packed, packed_expert_einsum


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    router: str = "softmax"  # or "sigmoid"
    capacity_factor: float = 1.25
    act: str = "silu"


def moe_init(gen, cfg: MoEConfig, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """Random MoE params (router fp32; ``lead`` prepends stacked-layer dims)."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    sd_in, sd_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)

    def normal(shape, std):
        return torch.randn(lead + shape, generator=gen, device=gen.device).mul_(std).to(dtype)

    p = {
        "router": dense_init(gen, (D,), (E,), stddev=sd_in, dtype=torch.float32, lead=lead),
        "experts": {
            "gate_proj": {"kernel": normal((E, D, F), sd_in)},
            "up_proj": {"kernel": normal((E, D, F), sd_in)},
            "down_proj": {"kernel": normal((E, F, D), sd_out)},
        },
    }
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        kw = dict(dtype=dtype, lead=lead)
        p["shared"] = {
            "gate_proj": dense_init(gen, (D,), (Fs,), stddev=sd_in, **kw),
            "up_proj": dense_init(gen, (D,), (Fs,), stddev=sd_in, **kw),
            "down_proj": dense_init(gen, (Fs,), (D,), stddev=1.0 / math.sqrt(Fs), **kw),
        }
    return p


def _route(p, x_flat, cfg: MoEConfig, with_aux: bool = True):
    """Returns (gates (N,k), expert_idx (N,k), logits fp32, aux metrics).
    ``with_aux=False`` skips the load-balancing and z losses (serving
    reads neither; eager torch would compute them on every call)."""
    logits = x_flat.to(torch.float32) @ p["router"]["kernel"]
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(scores, cfg.top_k, dim=-1)
    gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    aux: Dict[str, torch.Tensor] = {}
    if with_aux:
        # Switch-style load-balancing aux loss over all k assignments + z-loss
        E = cfg.n_experts
        me = torch.mean(torch.softmax(logits, dim=-1), dim=0)
        onehot = torch.nn.functional.one_hot(idx, E).to(torch.float32)
        ce = torch.mean(torch.sum(onehot, dim=1), dim=0) / cfg.top_k
        aux = {
            "moe_aux_loss": E * torch.sum(me * ce),
            "moe_z_loss": torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
        }
    return gates, idx, logits, aux


class _CombineGather(torch.autograd.Function):
    """``buf[read]``, whose backward is the gather through the inverse of
    ``dest`` (each kept assignment's own buffer row, E·C for a dropped one):
    buffer row r gets the grad of the one assignment it holds, or 0.  The
    autograd default, an ``index_put_`` with accumulate, sorts the indices;
    it made olmoe's train step 3–12% slower on an H100 (PERF.md)."""

    @staticmethod
    def forward(ctx, buf, read, dest):
        ctx.save_for_backward(dest)
        ctx.n_rows = buf.shape[0]
        return buf[read]

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        n = len(dest)
        src = torch.full((ctx.n_rows + 1,), n, dtype=dest.dtype, device=dest.device)
        src = src.scatter_(0, dest, torch.arange(n, device=dest.device))[: ctx.n_rows]
        return torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])[src], None, None


def _drop_limit(cfg: MoEConfig, n_real: int) -> int:
    """``ceil(cf · float32(n_real) / E)`` evaluated in fp32, as the JAX
    package evaluates it on its traced real length."""
    c = np.float32(cfg.capacity_factor) * np.float32(n_real) / np.float32(cfg.n_experts)
    return max(1, int(np.ceil(np.float32(c))))


def moe_apply(p, x, *, cfg: MoEConfig, compute_dtype=torch.bfloat16, capacity: int = 0,
              seq_len: Optional[int] = None, with_aux: bool = True):
    """x (B,T,D) -> ((B,T,D), aux).  ``capacity`` overrides the computed
    per-expert buffer (decode passes a fixed small capacity).

    The packed expert matmuls get each expert's count of kept assignments
    (counted on the device) and the bound min(E, N·k) on the experts that
    hold one, so that the decode kernel reads only those experts' words.
    An empty expert's rows are zero and its output +0 either way, so the
    value does not change.

    ``seq_len``: bucketed-prefill contract — only the first ``seq_len``
    positions of each row are real.  Padded tokens take no capacity and the
    drop test uses the real token count, while the buffer stays
    padded-size, so real tokens route as in an exact-length call."""
    B, T, D = x.shape
    N, k, E = B * T, cfg.top_k, cfg.n_experts
    x_flat = x.reshape(N, D)
    gates, idx, _, aux = _route(p, x_flat, cfg, with_aux)

    C = capacity or max(1, int(math.ceil(cfg.capacity_factor * N * k / E)))

    # --- dispatch: slot-major priority (all top-1 before top-2, GShard) ----
    dev = x.device
    e_ids = idx.t().reshape(-1)  # (kN,) expert of each assignment
    token_ids = torch.arange(N, device=dev).repeat(k)
    g_flat = gates.t().reshape(-1).to(torch.float32)
    onehot = torch.nn.functional.one_hot(e_ids, E)  # (kN, E) int64
    limit = C
    valid = None
    if seq_len is not None:
        valid = (torch.arange(T, device=dev) < seq_len).expand(B, T).reshape(N)[token_ids]
        onehot = onehot * valid[:, None]
        limit = min(_drop_limit(cfg, B * int(seq_len) * k), C)
    pos = torch.cumsum(onehot, dim=0).gather(1, e_ids[:, None])[:, 0] - 1  # (kN,)
    keep = pos < limit
    if valid is not None:
        keep = keep & valid
    pos_c = torch.clamp(pos, 0, C - 1)
    # kept assignments own distinct (expert, slot) rows; dropped ones go to
    # the dump row E·C, past the buffer.  xb.repeat(k, 1) holds the same
    # rows as xb[token_ids]; its backward is a sum, not a scatter-add
    dest = torch.where(keep, e_ids * C + pos_c, torch.full_like(e_ids, E * C))
    xb = x_flat.to(compute_dtype)
    buf = torch.zeros((E * C + 1, D), dtype=compute_dtype, device=dev)
    buf[dest] = xb.repeat(k, 1)
    buf = buf[: E * C].view(E, C, D)

    # --- expert FFN (gated) ---------------------------------------------------
    # Packed expert stacks (pack_tree artifacts, one f per expert) route to
    # the experts form of the fixed-point matmul; float stacks take bmm.
    we = p["experts"]
    f = act_fn(cfg.act)
    # no boolean indexing, no host sync
    rows = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, e_ids, keep.to(torch.int32))
    max_active = min(E, N * k)

    def expert_mm(proj, z):
        # down_proj takes the same rows: f(0)·0 = 0 for an empty expert
        kern = proj["kernel"]
        if is_packed(kern):
            return packed_expert_einsum(z, kern, compute_dtype=compute_dtype, rows=rows,
                                        max_active=max_active)
        return torch.bmm(z, kern.to(compute_dtype))

    h = expert_mm(we["gate_proj"], buf)
    u = expert_mm(we["up_proj"], buf)
    out_buf = expert_mm(we["down_proj"], f(h) * u).reshape(E * C, D)

    # --- combine: each token's k slots summed in slot order ------------------
    w_assign = g_flat.to(compute_dtype) * keep.to(compute_dtype)
    y_assign = (_CombineGather.apply(out_buf, e_ids * C + pos_c, dest) * w_assign[:, None]).view(k, N, D)
    y = y_assign[0]
    for j in range(1, k):
        y = y + y_assign[j]

    if cfg.n_shared_experts:
        sh = p["shared"]
        g = dense_apply(sh["gate_proj"], xb, compute_dtype=compute_dtype)
        u2 = dense_apply(sh["up_proj"], xb, compute_dtype=compute_dtype)
        y = y + dense_apply(sh["down_proj"], f(g) * u2, compute_dtype=compute_dtype)

    return y.reshape(B, T, D), aux


def moe_apply_dense_ref(p, x, *, cfg: MoEConfig) -> torch.Tensor:
    """O(E·N) reference: every expert computes every token, gated combine.
    Used by tests as the no-drop oracle (fp32)."""
    B, T, D = x.shape
    N = B * T
    x_flat = x.reshape(N, D).to(torch.float32)
    gates, idx, _, _ = _route(p, x_flat, cfg, with_aux=False)
    we = p["experts"]
    f = act_fn(cfg.act)

    def dense(leaf):
        return leaf.to(torch.float32)

    h = torch.einsum("nd,edf->enf", x_flat, dense(we["gate_proj"]["kernel"]))
    u = torch.einsum("nd,edf->enf", x_flat, dense(we["up_proj"]["kernel"]))
    all_out = torch.einsum("enf,efd->end", f(h) * u, dense(we["down_proj"]["kernel"]))
    dense_gates = torch.zeros((N, cfg.n_experts), dtype=torch.float32, device=x.device)
    dense_gates.scatter_add_(1, idx, gates)
    y = torch.einsum("ne,end->nd", dense_gates, all_out)
    if cfg.n_shared_experts:
        sh = p["shared"]
        g = x_flat @ dense(sh["gate_proj"]["kernel"])
        u2 = x_flat @ dense(sh["up_proj"]["kernel"])
        y = y + (f(g) * u2) @ dense(sh["down_proj"]["kernel"])
    return y.reshape(B, T, D)
