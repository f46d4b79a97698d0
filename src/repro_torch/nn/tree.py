"""Nested-dict parameter trees.

Params are nested dicts of tensors (``Packed`` leaves included) with the
JAX package's keys; a path string like ``"layers0/sub0/attn/q_proj/kernel"``
feeds SYMOG's quantizable-parameter predicate exactly as in JAX.  Dicts are
walked in sorted-key order, the order ``jax.tree_util`` flattens them in.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from repro_torch.core.packing import Packed


def is_packed(leaf: Any) -> bool:
    return isinstance(leaf, Packed)


def _walk(tree: Any, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out.append((prefix, tree))


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in sorted-key order; ``Packed`` counts as one leaf."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any, _prefix: str = "") -> Any:
    """Like ``tree_map`` but ``fn`` receives (path, leaf, *rest_leaves)."""
    if isinstance(tree, dict):
        return {
            k: tree_map_with_path(
                fn, v, *[r[k] for r in rest], _prefix=f"{_prefix}/{k}" if _prefix else str(k)
            )
            for k, v in tree.items()
        }
    return fn(_prefix, tree, *rest)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_to(tree: Any, device) -> Any:
    """Move every tensor (and ``Packed``) leaf to ``device``."""
    return tree_map(lambda x: x.to(device) if isinstance(x, (torch.Tensor, Packed)) else x, tree)


def tree_bytes(tree: Any) -> int:
    """Resident bytes; a ``Packed`` leaf counts its int8 words and exponent."""
    total = 0
    for leaf in tree_leaves(tree):
        parts = (leaf.data, leaf.f) if is_packed(leaf) else (leaf,)
        for t in parts:
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total
