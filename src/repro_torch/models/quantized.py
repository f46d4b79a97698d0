"""Quantized execution on ``Packed`` SYMOG serving artifacts (mirrors
``repro/models/quantized.py``).

A leaf is servable-packed iff it is a ``Packed``; its matmul call site
dispatches on the pinned packed backend (``kernels.dispatch``):

  'kernel' — ``kernels.fixedpoint_matmul`` (``fixedpoint_matmul_experts``
             for a per-expert MoE stack): the CUDA kernel for CUDA tensors
             (its plain version for CPU tensors);
  'unpack' — dequantize-then-matmul in torch; exact, so bit-identical to
             serving the ``quantize_tree`` float params.

Consumers that are not a plain right-matmul (embedding gather, tied
read-out) dequantize on the fly through ``as_dense`` / ``packed_take``.
"""
from __future__ import annotations

import math
from typing import Any, List

import torch

from repro_torch.core.packing import Packed, unpack, unpack_int, values_per_byte
from repro_torch.core.quantizer import delta_from_f
from repro_torch.kernels.dispatch import resolve_packed_backend
from repro_torch.kernels.fixedpoint_matmul.ops import fixedpoint_matmul, fixedpoint_matmul_experts
from repro_torch.nn.tree import is_packed, tree_leaves, tree_map

__all__ = [
    "is_packed",
    "tree_has_packed",
    "as_dense",
    "unpack_params",
    "scan_ready",
    "unstack_layers",
    "packed_dense_apply",
    "packed_expert_einsum",
    "packed_take",
]


def tree_has_packed(tree: Any) -> bool:
    return any(is_packed(leaf) for leaf in tree_leaves(tree))


def as_dense(leaf: Any, dtype=None) -> torch.Tensor:
    """Dequantize a Packed leaf (exact); cast a float leaf."""
    if is_packed(leaf):
        return unpack(leaf, dtype or torch.float32)
    return leaf if dtype is None else leaf.to(dtype)


def unpack_params(tree: Any, dtype=None) -> Any:
    """Densify every Packed leaf of a param tree."""
    return tree_map(lambda leaf: as_dense(leaf, dtype) if is_packed(leaf) else leaf, tree)


def scan_ready(tree: Any, count: int) -> Any:
    """Give a stacked group's Packed leaves a per-layer exponent: a scalar f
    (one Δ for the whole stack) is broadcast to (count,), so slicing layer i
    of every leaf works for Packed leaves too."""

    def fix(leaf):
        if is_packed(leaf) and leaf.f.ndim == 0:
            return Packed(data=leaf.data, n_bits=leaf.n_bits, f=leaf.f.expand(count))
        return leaf

    return tree_map(fix, tree)


def unstack_layers(tree: Any, count: int) -> List[Any]:
    """The ``count`` layers of a ``scan_ready`` stacked subtree — the
    Python-loop counterpart of ``lax.scan`` slicing the leading axis.  Each
    leaf is cut ONCE with ``torch.unbind`` (views, no copies), whose backward
    stacks the per-layer gradients once; indexing ``leaf[i]`` per layer would
    instead add a zero gradient the size of the whole stack for every layer."""

    def cut(leaf):
        if is_packed(leaf):
            return [Packed(data=d, n_bits=leaf.n_bits, f=f)
                    for d, f in zip(leaf.data.unbind(0), leaf.f.unbind(0))]
        return leaf.unbind(0)

    cuts = tree_map(cut, tree)
    return [tree_map(lambda parts, i=i: parts[i], cuts) for i in range(count)]


def packed_dense_apply(p, x, *, n_in: int = 1, compute_dtype=None) -> torch.Tensor:
    """``dense_apply`` for a dict whose 'kernel' is Packed: contract the last
    ``n_in`` dims of x with the first n_in dims of the kernel.  Packing runs
    along the kernel's last axis, so flattening the out dims keeps byte
    groups aligned: the words reshape to (K, N/per) with no repack."""
    pk: Packed = p["kernel"]
    bias = p.get("bias")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if resolve_packed_backend(x.device) == "unpack":
        y = torch.tensordot(x, unpack(pk, x.dtype), dims=n_in)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return y
    if pk.f.ndim != 0:
        raise NotImplementedError(
            "the fixedpoint_matmul kernel takes one exponent per call; slice stacked "
            "layers first (unstack_layers); per-expert MoE stacks go through "
            "packed_expert_einsum"
        )
    in_dims, out_dims = pk.shape[:n_in], pk.shape[n_in:]
    K, N = math.prod(in_dims), math.prod(out_dims)
    per = values_per_byte(pk.n_bits)
    lead = x.shape[: x.ndim - n_in]
    y = fixedpoint_matmul(
        x.reshape(*lead, K), pk.data.reshape(K, N // per), pk.f,
        None if bias is None else bias.reshape(N), n_bits=pk.n_bits, n_out=N,
    )
    return y.reshape(*lead, *out_dims)


def packed_expert_einsum(x, pk: Packed, *, compute_dtype=None, rows=None,
                         max_active=None) -> torch.Tensor:
    """einsum('ECK,EKN->ECN') against a per-expert Packed stack (gate/up
    (E, D, F) and down (E, F, D): the contraction is always over the middle
    axis, packing over the last).  ``pk.f`` holds one exponent per expert.
    ``rows`` / ``max_active``: see ``fixedpoint_matmul_experts`` (the
    'unpack' backend computes every expert and ignores them)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if resolve_packed_backend(x.device) == "unpack":
        return torch.bmm(x, unpack(pk, x.dtype))
    return fixedpoint_matmul_experts(x, pk.data, pk.f, n_bits=pk.n_bits, n_out=pk.shape[-1],
                                     rows=rows, max_active=max_active)


def packed_take(pk: Packed, ids: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """Embedding lookup from a Packed (vocab, d) table: gather the packed rows,
    then dequantize only those (O(tokens·d) unpack work)."""
    dtype = dtype or torch.float32
    if pk.f.ndim != 0:
        return unpack(pk, dtype)[ids]
    rows = pk.data[ids]
    m = unpack_int(rows, pk.n_bits, pk.shape[-1]).to(dtype)
    return m * delta_from_f(pk.f).to(dtype)
