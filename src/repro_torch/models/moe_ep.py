"""Expert-parallel MoE over ``torch.distributed`` all-to-all (the port's
counterpart of ``repro/models/moe_ep.py``).

Every rank runs this SPMD: tokens are this rank's share over ``dp_axes``
(the axes the batch is split over) and copies over the EP axes' rest;
experts are split over ``ep_axes`` (1-D: ('model',); 2-D for deepseek:
('data', 'model')), each rank holding E / ep of them.

  per rank:
    1. route locally (top-k); split the assignments across the axes where
       the tokens are copies (an ownership partition) — without this every
       copy ships identical payloads;
    2. pack an (ep, C_send, D) send buffer (capacity per destination);
    3. ``all_to_all_single`` over the EP group → received token payloads;
    4. scatter into (E_local, C_loc, D) per-expert buffers, run the FFNs
       (a ``Packed`` stack: the experts form of the fixed-point matmul, the
       CUDA kernel on the card; JAX densifies here, with the same values);
    5. reverse all-to-all (same layout — outputs return to source slots);
    6. local combine (× gate, a token's k slots summed in slot order), then
       a sum over the copies' partitions, in fp32 rounded once.

``seq_len`` masks bucketed-prefill padding out of capacity competition, and
``dropless`` sizes both capacities at their worst-case bounds so no
assignment can ever drop (the row independence continuous batching needs).

Gradients: the all-to-all's backward is the reverse all-to-all
(``collectives.AllToAll``); the sum over copies passes the grad through
(every copy runs the same program after it), and a tensor the copies use
in disjoint parts (the tokens, the router) sums its grad over them on the
way back (``collectives.EnterReplicas``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.packing import Packed
from repro_torch.distributed.collectives import AllToAll, EnterReplicas, ReduceSum, all_to_all
from repro_torch.models.layers import act_fn, dense_apply
from repro_torch.models.moe import MoEConfig, _route
from repro_torch.models.quantized import is_packed, packed_expert_einsum
from repro_torch.nn.sharding import current_mesh, mesh_axis_size


def _positions_for(dest: torch.Tensor, n_dest: int, cap: int,
                   mask: Optional[torch.Tensor] = None):
    """dest (A,) → (slot, keep): positions within each destination's
    capacity-bounded buffer (first-come priority).  ``mask`` excludes rows
    from BOTH the output (keep=False) and the slot numbering — a masked-out
    assignment (bucket padding, another copy's ownership partition) must
    not consume capacity that drops a real one."""
    onehot = F.one_hot(dest, n_dest)  # (A, n_dest) int64
    if mask is not None:
        onehot = onehot * mask[:, None]
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, dest[:, None])[:, 0]
    keep = pos < cap
    if mask is not None:
        keep = keep & mask
    return torch.clamp(pos, 0, cap - 1), keep


def _local_experts(leaf, n_experts: int, e_local: int, me: int):
    """This rank's E_local experts of a stack: a stack already sliced by the
    sharding rules is used as it is, a whole one is cut here."""
    if is_packed(leaf):
        if leaf.data.shape[0] == e_local:
            return leaf
        sl = slice(me * e_local, (me + 1) * e_local)
        return Packed(data=leaf.data[sl], n_bits=leaf.n_bits,
                      f=leaf.f[sl] if leaf.f.ndim else leaf.f)
    if leaf.shape[0] == e_local:
        return leaf
    if leaf.shape[0] != n_experts:
        raise ValueError(f"expert stack of {leaf.shape[0]}: neither {n_experts} nor {e_local}")
    return leaf[me * e_local: (me + 1) * e_local]


def _shared_ffn(sh, x, f, compute_dtype):
    g = dense_apply(sh["gate_proj"], x, compute_dtype=compute_dtype)
    u = dense_apply(sh["up_proj"], x, compute_dtype=compute_dtype)
    return dense_apply(sh["down_proj"], f(g) * u, compute_dtype=compute_dtype)


def moe_apply_ep(
    p,
    x,
    *,
    cfg: MoEConfig,
    compute_dtype=torch.bfloat16,
    ep_axes=("model",),
    dp_axes=("pod", "data"),
    capacity_mult: float = 2.0,
    seq_len: Optional[int] = None,
    dropless: bool = False,
    with_aux: bool = True,
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """x (B_local, T, D) → (B_local, T, D) on ``mesh`` (default: the current
    one, ``with mesh:``).  ``dp_axes``: the mesh axes x is split over (JAX's
    batch axes; serving passes () — every rank holds the whole batch).
    Expert stacks may be this rank's slice or whole; the shared experts'
    d_ff may be split over ``model`` (their partials join the sum over
    copies) or whole."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("moe_apply_ep needs a mesh (`with mesh:` or mesh=)")
    ep_axes = tuple(a for a in mesh.axis_names if a in ep_axes)
    if not ep_axes:
        raise ValueError(f"none of the EP axes is on the mesh {mesh.axis_names}")
    dp = tuple(a for a in mesh.axis_names if a in dp_axes)
    repl_axes = tuple(a for a in ep_axes if a not in dp)
    ep_total = mesh_axis_size(mesh, *ep_axes)
    msize = mesh_axis_size(mesh, *repl_axes)
    E, k = cfg.n_experts, cfg.top_k
    if E % ep_total:
        raise ValueError(f"{E} experts do not divide over {ep_total} EP ranks")
    E_local = E // ep_total
    Bl, T, D = x.shape
    N, A = Bl * T, k * Bl * T
    dev = x.device
    f = act_fn(cfg.act)
    ep_group = mesh.group(ep_axes)
    repl_group = mesh.group(repl_axes) if msize > 1 else None
    me = mesh.axis_index(ep_axes)

    router_w = p["router"]["kernel"]
    xr = x
    if repl_group is not None:
        xr = EnterReplicas.apply(x, repl_group)
        router_w = EnterReplicas.apply(router_w, repl_group)
    xf = xr.reshape(N, D)
    gates, idx, _, aux = _route({"router": {"kernel": router_w}}, xf, cfg, with_aux)

    a_ids = idx.t().reshape(-1)  # (A,) global expert, slot-major
    g_flat = gates.t().reshape(-1).to(torch.float32)
    token_ids = torch.arange(N, device=dev).repeat(k)
    dest = a_ids // E_local  # destination EP rank
    local_eid = (a_ids % E_local).to(torch.int32)

    # partition the (copied) assignment set across the copies: each copy
    # routes a disjoint 1/msize of the assignments
    if msize > 1:
        own = (torch.arange(A, device=dev) % msize) == mesh.axis_index(repl_axes)
    else:
        own = torch.ones(A, dtype=torch.bool, device=dev)
    valid_len = T if seq_len is None else int(seq_len)
    token_valid = (torch.arange(T, device=dev) < valid_len).expand(Bl, T).reshape(N)
    own = own & token_valid[token_ids]

    if dropless:
        # ownership is a strided 1/msize partition: at most ceil(A/msize)
        # assignments per copy, all of which could target one destination
        c_send = max(1, -(-A // msize))
    else:
        c_send = max(1, int(math.ceil(capacity_mult * A / (msize * ep_total))))
    slot, keep = _positions_for(dest, ep_total, c_send, mask=own)
    n_send = ep_total * c_send
    send_row = torch.where(keep, dest * c_send + slot, torch.full_like(dest, n_send))

    xb = xf.to(compute_dtype)
    send_x = torch.zeros((n_send + 1, D), dtype=compute_dtype, device=dev)
    send_x[send_row] = xb.repeat(k, 1)  # kept rows distinct; dropped ones to the dump row
    send_e = torch.full((n_send + 1,), -1, dtype=torch.int32, device=dev)
    send_e[send_row] = local_eid
    send_e[n_send] = -1

    # ---- token payloads to expert owners ----------------------------------
    recv_x = AllToAll.apply(send_x[:n_send].view(ep_total, c_send, D), ep_group)
    re_ = all_to_all(send_e[:n_send].view(ep_total, c_send), ep_group).reshape(n_send)
    rx = recv_x.reshape(n_send, D)

    # ---- per-local-expert buffers -------------------------------------------
    if dropless:
        # a token's top-k experts are distinct, so ONE expert sees at most
        # one assignment per global token
        n_global = N * mesh_axis_size(mesh, *dp)
        c_loc = max(1, min(n_send, n_global))
    else:
        c_loc = max(1, int(math.ceil(capacity_mult * n_send / max(E_local, 1))))
    valid = re_ >= 0
    eid = torch.where(valid, re_, 0).to(torch.int64)
    eslot, ekeep = _positions_for(eid, E_local, c_loc, mask=valid)
    n_buf = E_local * c_loc
    buf_row = torch.where(ekeep, eid * c_loc + eslot, torch.full_like(eid, n_buf))
    buf = torch.zeros((n_buf + 1, D), dtype=compute_dtype, device=dev)
    buf[buf_row] = rx.to(compute_dtype)
    buf = buf[:n_buf].view(E_local, c_loc, D)

    we = p["experts"]
    rows = torch.zeros(E_local, dtype=torch.int32, device=dev).scatter_add_(
        0, eid, ekeep.to(torch.int32))
    max_active = min(E_local, n_send)

    def expert_mm(proj, z):
        kern = _local_experts(proj["kernel"], E, E_local, me)
        if is_packed(kern):
            return packed_expert_einsum(z, kern, compute_dtype=compute_dtype, rows=rows,
                                        max_active=max_active)
        return torch.bmm(z, kern.to(compute_dtype))

    h = expert_mm(we["gate_proj"], buf)
    u = expert_mm(we["up_proj"], buf)
    out_buf = expert_mm(we["down_proj"], f(h) * u).reshape(n_buf, D)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, D))])

    # ---- back to source layout ------------------------------------------------
    y_rows = out_buf[buf_row]  # a dropped received row reads the zero row
    back = AllToAll.apply(y_rows.view(ep_total, c_send, D), ep_group).reshape(n_send, D)
    back = torch.cat([back, back.new_zeros((1, D))])

    # ---- local combine, then the sum over the copies' partitions ------------
    w_assign = g_flat.to(compute_dtype) * keep.to(compute_dtype)
    y_assign = (back[send_row] * w_assign[:, None]).view(k, N, D)
    y = y_assign[0]
    for j in range(1, k):
        y = y + y_assign[j]

    def psum(t, group):
        if group is None:
            return t
        return ReduceSum.apply(t.to(torch.float32), group).to(compute_dtype)

    if cfg.n_shared_experts:
        sh = p["shared"]
        model_group = mesh.group("model")
        # a d_ff split over 'model' leaves each rank a partial of the FFN
        partial = model_group is not None and (
            sh["gate_proj"]["kernel"].shape[-1] != cfg.d_ff_expert * cfg.n_shared_experts)
        xs = EnterReplicas.apply(x, model_group) if partial else x
        ysh = _shared_ffn(sh, xs.reshape(N, D).to(compute_dtype), f, compute_dtype)
        if partial and repl_axes == ("model",):
            y = psum(y + ysh, model_group)  # one sum over 'model' for both
        elif partial:
            y = psum(y, repl_group) + psum(ysh, model_group)
        else:
            y = psum(y, repl_group) + ysh
    else:
        y = psum(y, repl_group)

    if with_aux:
        n = mesh_axis_size(mesh, *dp, *repl_axes)
        dp_group = mesh.group(dp) if mesh_axis_size(mesh, *dp) > 1 else None

        def mean(v):
            # the rows' ranks each take their own loss and average the grads
            # after: the grad of a sum over them sums over them too; the
            # copies run one loss, whose grad of a sum is already whole
            if dp_group is not None:
                v = ReduceSum.apply(EnterReplicas.apply(v, dp_group), dp_group)
            if repl_group is not None:
                v = ReduceSum.apply(v, repl_group)
            return v / n

        aux = {kk: mean(v) for kk, v in aux.items()}
    return y.reshape(Bl, T, D), aux
