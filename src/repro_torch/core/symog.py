"""SYMOG over parameter trees — the parts the serving artifact needs
(paper Alg. 1 lines 2–5 and 21–23): the per-leaf Δ search, hard
post-quantization and packing.  The training-side regularizer gradient and
clipping come with the training slice.

A scan-stacked (L, D, F) leaf gets ONE scalar f, as in the JAX package;
MoE expert stacks (path matching ``per_expert_pattern``, rank ≥ 3) get one
f per expert over every leading dim.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.packing import pack
from repro_torch.core.quantizer import delta_from_f, quantize
from repro_torch.core.stepsize import F_MAX, F_MIN, optimal_f
from repro_torch.nn.tree import flatten_with_paths, tree_map_with_path

DEFAULT_EXCLUDES: Tuple[str, ...] = (
    "norm",
    "scale",
    "router",
    "pos_embed",
    "a_log",
    "dt_bias",
    "rg_lru/a_param",
    "bias",
    "ssm_d",
)


def default_quant_filter(path: str, leaf: Any) -> bool:
    """Paper quantizes all weight matrices; norms/bias/router stay float."""
    if getattr(leaf, "ndim", 0) < 2:
        return False
    low = path.lower()
    return not any(pat in low for pat in DEFAULT_EXCLUDES)


@dataclasses.dataclass(frozen=True)
class SymogConfig:
    n_bits: int = 2
    lambda0: float = 10.0
    alpha: float = 9.0
    total_steps: int = 1000
    clip: bool = True
    f_min: int = F_MIN
    f_max: int = F_MAX
    per_expert_pattern: str = r"experts/"
    quant_filter: Callable[[str, Any], bool] = default_quant_filter


@dataclasses.dataclass
class SymogState:
    """Per-leaf integer exponents f (Δ_l = 2^{-f_l}) + static quantize mask."""

    f: Any
    mask: Dict[str, bool]


def _delta_for(w: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Δ = 2^{-f}, broadcast per-expert f over trailing weight dims."""
    d = delta_from_f(f, device=w.device)
    while d.ndim < w.ndim:
        d = d[..., None]
    return d


def symog_init(params: Any, cfg: SymogConfig) -> SymogState:
    """Alg. 1 lines 2–5: per-layer (or per-expert) integer grid search for Δ."""
    mask = {p: bool(cfg.quant_filter(p, v)) for p, v in flatten_with_paths(params)}

    def per_leaf(path: str, w):
        if not mask[path]:
            return torch.zeros((), dtype=torch.int32, device=w.device)
        if re.search(cfg.per_expert_pattern, path) and w.ndim >= 3:
            lead = w.shape[:-2]
            w2 = w.reshape((-1,) + tuple(w.shape[-2:]))
            fs = [optimal_f(e, cfg.n_bits, cfg.f_min, cfg.f_max)[0] for e in w2]
            return torch.stack(fs).reshape(lead).to(torch.int32)
        f, _ = optimal_f(w, cfg.n_bits, cfg.f_min, cfg.f_max)
        return f.to(torch.int32)

    return SymogState(f=tree_map_with_path(per_leaf, params), mask=mask)


def quantize_tree(params: Any, state: SymogState, cfg: SymogConfig) -> Any:
    """Alg. 1 lines 21–23: every quantizable value becomes exactly m·2^{-f}."""

    def per_leaf(path, w, f):
        if not state.mask[path]:
            return w
        return quantize(w, _delta_for(w, f), cfg.n_bits)

    return tree_map_with_path(per_leaf, params, state.f)


def pack_tree(params: Any, state: SymogState, cfg: SymogConfig) -> Any:
    """Serving artifact: quantizable leaves → ``Packed``; the rest passes through."""

    def per_leaf(path, w, f):
        if not state.mask[path]:
            return w
        return pack(w, f, cfg.n_bits)

    return tree_map_with_path(per_leaf, params, state.f)
