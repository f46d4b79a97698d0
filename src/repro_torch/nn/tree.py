"""Nested-dict parameter trees.

Params are nested dicts of tensors (``Packed`` leaves included) with the
JAX package's keys; a path string like ``"layers0/sub0/attn/q_proj/kernel"``
feeds SYMOG's quantizable-parameter predicate exactly as in JAX.  Dicts are
walked in sorted-key order, the order ``jax.tree_util`` flattens them in.

``tree_paths``, ``path_str``, ``tree_size`` and ``tree_select`` are the JAX
package's helpers of the same names.  This module imports nothing of
``repro_torch.core`` at its top: ``core`` builds on it, so ``Packed`` is
imported at the end, once every function here exists.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch


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


def path_str(path: Tuple[Any, ...]) -> str:
    """Render a tuple of keys (str or int) as a '/'-joined string."""
    return "/".join(str(p) for p in path)


def tree_paths(tree: Any) -> List[str]:
    """All leaf paths of a tree, as strings (a ``Packed`` leaf is one path
    here; JAX lists its two pytree children)."""
    return [p for p, _ in flatten_with_paths(tree)]


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves, as JAX counts them: a
    ``Packed`` leaf counts its int8 words and its exponents (its two pytree
    children there), a leaf without a shape counts 1."""
    total = 0
    for leaf in tree_leaves(tree):
        for t in ((leaf.data, leaf.f) if is_packed(leaf) else (leaf,)):
            total += math.prod(t.shape) if hasattr(t, "shape") else 1
    return total


def tree_select(tree: Any, predicate: Callable[[str, Any], bool]) -> Dict[str, Any]:
    """{path: leaf} for the leaves where ``predicate(path, leaf)`` is True."""
    return {p: v for p, v in flatten_with_paths(tree) if predicate(p, v)}


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


from repro_torch.core.packing import Packed  # noqa: E402 — see the module docstring
