"""Collectives over a mesh's process groups, and gradient compression (the
port's counterpart of ``repro/distributed/collectives.py``).

The helpers take a process group (``Mesh.group(axes)``; None, a group of
one rank, makes each the identity) and return new tensors.  How a tensor
reaches the wire is decided by the group's backend, explicitly: an NCCL
group takes CUDA tensors as they are; a gloo group (ranks sharing one card,
or the CPU) gets a host copy, in pinned memory for a CUDA tensor, and bf16
travels as fp32 (exact both ways).  ``all_reduce`` sums in the dtype it is
given, so a caller that wants one rounding sums fp32 and casts once.

``compressed_psum_int8`` performs a data-parallel gradient all-reduce with
int8 payloads + error feedback:

    x'    = x + err                         (carry last round's residual)
    s     = pmax(|x'|) / 127                (shared scale — one all_reduce(MAX))
    q     = round(x'/s)  ∈ int8
    y     = psum(q)·s / n_shards            (the mean gradient; all_reduce(SUM))
    err'  = x' − q·s                        (residual for next round)

Bytes on the wire drop 4× vs fp32; error feedback keeps the *accumulated*
quantization error bounded.  As in JAX, the trainer does not call it: it is
a library function.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.nn.tree import flatten_with_paths, tree_map, tree_map_with_path

_OPS = {"sum": "SUM", "max": "MAX"}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(group) -> bool:
    """Whether tensors cross ``group`` through host memory (gloo)."""
    return dist.get_backend(group) != "nccl"


def _to_wire(x: torch.Tensor, staged: bool) -> torch.Tensor:
    if not staged:
        return x.contiguous()
    wire_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    if x.is_cuda:
        host = torch.empty(x.shape, dtype=wire_dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.to(wire_dtype).contiguous()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(device=like.device, dtype=like.dtype, non_blocking=False)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of ``x`` over ``group``, on every member."""
    if group_size(group) == 1:
        return x
    staged = _staged(group)
    w = _to_wire(x, staged)
    if w is x:
        w = x.clone()
    dist.all_reduce(w, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return _from_wire(w, x)


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    staged = _staged(group)
    w = _to_wire(x, staged)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return _from_wire(torch.cat(parts, dim=dim), x)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...): chunk i goes to group rank i; returns the chunks received,
    chunk j from group rank j (``jax.lax.all_to_all`` tiled on axis 0)."""
    if group_size(group) == 1:
        return x
    staged = _staged(group)
    w = _to_wire(x, staged)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _from_wire(out, x)


class AllToAll(torch.autograd.Function):
    """``all_to_all`` whose backward is the reverse all-to-all: the grad of
    a received chunk goes back to the rank that sent it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all(grad.contiguous(), ctx.group), None


class ReduceSum(torch.autograd.Function):
    """``all_reduce`` sum of partials, backward the identity: every member
    runs the same program after it, so each member's grad of the sum is
    already the whole grad of its own partial."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class EnterReplicas(torch.autograd.Function):
    """The identity, whose backward sums the grad over ``group``: for a
    tensor the members hold as copies and use in disjoint parts (the
    ownership partition of expert parallelism), whose grads are partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


# ---------------------------------------------------------------------------
# int8 compressed gradient all-reduce with error feedback
# ---------------------------------------------------------------------------
class CompressionState(NamedTuple):
    err: Any  # residual tree, fp32, same structure as grads


def init_compression_state(grads_like: Any) -> CompressionState:
    return CompressionState(err=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _compress_one(x: torch.Tensor, err: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(torch.float32) + err
    amax = all_reduce(torch.max(torch.abs(xf)), group, op="max")
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    total = all_reduce(q, group) * scale
    n = all_reduce(torch.ones((), dtype=torch.float32, device=x.device), group)
    mean = total / n
    new_err = xf - q * scale
    return mean, new_err


def compressed_psum_int8(grads: Any, state: CompressionState, group: Optional[Any]
                         ) -> Tuple[Any, CompressionState]:
    """All-reduce-mean a gradient tree over ``group`` with int8 compression
    + error feedback.  ``group`` is JAX's ``axis_name``: a mesh's group over
    the data axis (``Mesh.group("data")``)."""
    errs = dict(flatten_with_paths(state.err))
    out = {}

    def one(path, g):
        out[path] = _compress_one(g, errs[path], group)
        return out[path][0]

    means = tree_map_with_path(one, grads)
    return means, CompressionState(err=tree_map_with_path(lambda p, _: out[p][1], grads))
