"""Collectives over a mesh's process groups, and gradient compression (the
port's counterpart of ``repro/distributed/collectives.py``).

The helpers take a process group (``Mesh.group(axes)``; None, a group of
one rank, makes each the identity) and return new tensors.  How a tensor
reaches the wire is decided by the group's backend, explicitly: an NCCL
group takes CUDA tensors as they are; a gloo group (ranks sharing one card,
or the CPU) gets a host copy, in pinned memory for a CUDA tensor, and bf16
travels as fp32 (exact both ways).  ``all_reduce`` sums in the dtype it is
given, so a caller that wants one rounding sums fp32 and casts once.

Autograd forms: ``AllToAll`` (backward the reverse all-to-all),
``ReduceSum`` (Megatron's g: the sum, backward the identity),
``EnterReplicas`` (Megatron's f: the identity, backward the sum),
``SumShared`` (the sum, backward the sum: partials whose sum each member
then uses in a program of its own),
``AllGather`` (backward this member's slice of the grad) and
``GatherShards`` (FSDP's join of a parameter's shards, backward the
reduce-scatter sum).  ``stats`` counts every collective this process runs
(calls and the bytes of the tensor given, by kind) and, while ``timing`` is
on, the seconds each took from a synchronized device to its result back on
the device (staging included).  Inside ``recorded()`` each call also
appends a ``Record``: its kind, the bytes of its RESULT (an all-gather's
is g times the tensor given, a reduce-scatter's 1/g of it), the group
size g and whether the group lies in one 8-GPU node; ``launch/comm_cost.py``
turns them into wire bytes.  A group of torch's ``fake`` backend (the dry
run's: ``launch/dryrun.py``) takes tensors as they are, as NCCL does.

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

import collections
import contextlib
import time
from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.nn.tree import flatten_with_paths, tree_map, tree_map_with_path

_OPS = {"sum": "SUM", "max": "MAX"}


stats = {"calls": collections.Counter(), "bytes": collections.Counter(),
         "seconds": collections.Counter()}
timing = False  # also time every collective (a device synchronize before each)
NODE_GPUS = 8  # ranks of one host joined by NVLink (an HGX H100 node)


class Record(NamedTuple):
    kind: str  # 'all_reduce' | 'all_gather' | 'reduce_scatter' | 'all_to_all'
    result_bytes: int
    group: int  # g, the group's size
    in_node: bool  # every member in one NODE_GPUS-rank node


_records: Optional[List[Record]] = None


def reset_stats() -> None:
    for c in stats.values():
        c.clear()


@contextlib.contextmanager
def recorded():
    """Collect a ``Record`` of every collective run inside (on any thread:
    the autograd engine's too); yields the list."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


def _in_node(group) -> bool:
    ranks = dist.get_process_group_ranks(group)
    return max(ranks) // NODE_GPUS == min(ranks) // NODE_GPUS


@contextlib.contextmanager
def _counted(kind: str, x: torch.Tensor, group=None, result_bytes: Optional[int] = None):
    nbytes = x.numel() * x.element_size()
    stats["calls"][kind] += 1
    stats["bytes"][kind] += nbytes
    if _records is not None:
        _records.append(Record(kind, nbytes if result_bytes is None else result_bytes,
                               group_size(group), _in_node(group)))
    if not timing:
        yield
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t = time.perf_counter()
    yield
    stats["seconds"][kind] += time.perf_counter() - t


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(group) -> bool:
    """Whether tensors cross ``group`` through host memory (gloo)."""
    return dist.get_backend(group) not in ("nccl", "fake")


def _to_wire(x: torch.Tensor, staged: bool) -> torch.Tensor:
    if not staged:
        return x.contiguous()
    wire_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    if x.is_cuda:
        host = torch.empty(x.shape, dtype=wire_dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.to(wire_dtype).contiguous()


def _like(w: torch.Tensor) -> torch.Tensor:
    """A receive buffer like ``w``, pinned when ``w`` is (a staged CUDA
    tensor's: the copy back to the card then runs at the pinned rate)."""
    return torch.empty(w.shape, dtype=w.dtype, device=w.device,
                       pin_memory=w.device.type == "cpu" and w.is_pinned())


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(device=like.device, dtype=like.dtype, non_blocking=False)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of ``x`` over ``group``, on every member."""
    if group_size(group) == 1:
        return x
    with _counted("all_reduce", x, group):
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
    with _counted("all_gather", x, group, n * x.numel() * x.element_size()):
        staged = _staged(group)
        w = _to_wire(x, staged)
        parts = [_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        if staged and x.is_cuda:  # each part back from pinned memory, joined on the card
            return torch.cat([_from_wire(p, x) for p in parts], dim=dim)
        return _from_wire(torch.cat(parts, dim=dim), x)


def reduce_scatter(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The sum of the members' ``x`` over ``group``, cut along ``dim`` into
    group-size parts: this member's part (group-rank order), in x's dtype."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    with _counted("reduce_scatter", x, group, x.numel() * x.element_size() // n):
        staged = _staged(group)
        # cut (and made contiguous) where x lives, each part staged whole
        parts = [_to_wire(p.contiguous(), staged) for p in x.chunk(n, dim=dim)]
        out = _like(parts[0])
        dist.reduce_scatter(out, parts, group=group)
        return _from_wire(out, x)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...): chunk i goes to group rank i; returns the chunks received,
    chunk j from group rank j (``jax.lax.all_to_all`` tiled on axis 0)."""
    if group_size(group) == 1:
        return x
    with _counted("all_to_all", x, group):
        staged = _staged(group)
        w = _to_wire(x, staged)
        out = _like(w)
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


class AllGather(torch.autograd.Function):
    """``all_gather`` whose backward returns this member's slice of the grad:
    for a gathered tensor every member uses whole in the same program after
    it (vocab-parallel logits), whose grad is the same on every member."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.part = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        i = dist.get_rank(ctx.group) if group_size(ctx.group) > 1 else 0
        return grad.narrow(ctx.dim, i * ctx.part, ctx.part), None, None


class GatherShards(torch.autograd.Function):
    """``all_gather`` of a parameter's shards over the FSDP axes, whose
    backward is the reduce-scatter sum of the grad: each member computed
    its grad of the whole parameter from its own rows of the batch, and
    keeps the sum over the members of its own shard's part (in fp32,
    rounded once to the grad's dtype)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        out = reduce_scatter(grad.to(torch.float32).contiguous(), ctx.group, ctx.dim)
        return out.to(grad.dtype), None, None


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


class SumShared(torch.autograd.Function):
    """``all_reduce`` sum whose backward is the ``all_reduce`` sum of the
    grad: for partials whose sum every member then uses in a program of its
    own (mamba2's gated norm over d_inner split by heads: each member
    normalizes its own channels by the shared sum of squares), so each
    member's grad of the sum covers its own program only.  ``ReduceSum``'s
    identity backward would drop the other members' parts."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


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
