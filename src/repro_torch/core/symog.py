"""SYMOG over parameter trees (paper Alg. 1; mirrors ``repro/core/symog.py``):
the per-leaf Δ search (lines 2–5), the λ schedule, the regularizer and its
gradient (line 15), weight clipping (line 17), hard post-quantization and
packing (lines 21–23), and the mode / quantization-error diagnostics.

A scan-stacked (L, D, F) leaf gets ONE scalar f, as in the JAX package;
MoE expert stacks (path matching ``per_expert_pattern``, rank ≥ 3) get one
f per expert over every leading dim.

Sharded training: ``symog_init`` runs on the whole leaves, before they are
cut (``train.sharding``), so every f is the JAX package's.  The functions
that read whole-leaf quantities take ``shards`` (a ``train.sharding``
layout: ``numel(path)``, the whole leaf's count M_l, and
``sum_over_shards({path: partial})``, each leaf's partial summed over the
ranks its shards span, a replicated leaf counted once) and are then exact
on this rank's shards.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import metrics as _metrics
from repro_torch.core.packing import pack
from repro_torch.core.quantizer import clip_to_range, delta_from_f, quantize
from repro_torch.core.regularizer import layer_reg_grad, layer_reg_value
from repro_torch.core.stepsize import F_MAX, F_MIN, optimal_f
from repro_torch.nn.tree import flatten_with_paths, tree_leaves, tree_map_with_path

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


def symog_init(params: Any, cfg: SymogConfig, *, shapes_only: bool = False) -> SymogState:
    """Alg. 1 lines 2–5: per-layer (or per-expert) integer grid search for Δ.

    ``shapes_only``: skip the search and give every f as zeros of its shape
    and dtype (the counterpart of ``jax.eval_shape`` over ``symog_init``,
    for ``launch/dryrun.py``, which reads f's shape only: a search per
    expert under ``FakeTensorMode`` takes ~40 ms, deepseek-v3 has 45,312)."""
    mask = {p: bool(cfg.quant_filter(p, v)) for p, v in flatten_with_paths(params)}

    def per_leaf(path: str, w):
        if not mask[path]:
            return torch.zeros((), dtype=torch.int32, device=w.device)
        if re.search(cfg.per_expert_pattern, path) and w.ndim >= 3:
            lead = w.shape[:-2]
            if shapes_only:
                return torch.zeros(lead, dtype=torch.int32, device=w.device)
            w2 = w.reshape((-1,) + tuple(w.shape[-2:]))
            fs = [optimal_f(e, cfg.n_bits, cfg.f_min, cfg.f_max)[0] for e in w2]
            return torch.stack(fs).reshape(lead).to(torch.int32)
        if shapes_only:
            return torch.zeros((), dtype=torch.int32, device=w.device)
        f, _ = optimal_f(w, cfg.n_bits, cfg.f_min, cfg.f_max)
        return f.to(torch.int32)

    return SymogState(f=tree_map_with_path(per_leaf, params), mask=mask)


def lambda_at(cfg: SymogConfig, step: int) -> float:
    """λ(s) = λ_0·exp(α·s/total) — Alg. 1 line 8 in step units, in fp32."""
    frac = torch.tensor(step, dtype=torch.float32) / max(cfg.total_steps, 1)
    lam0 = torch.tensor(cfg.lambda0, dtype=torch.float32)
    return float(lam0 * torch.exp(torch.tensor(cfg.alpha, dtype=torch.float32) * frac))


def _m_l(shards, path):
    return None if shards is None else shards.numel(path)


def reg_value(params: Any, state: SymogState, cfg: SymogConfig, shards=None) -> torch.Tensor:
    """R(Θ) over quantizable leaves (paper Eq. 3)."""

    def per_leaf(path, w, f):
        if not state.mask[path]:
            return torch.zeros((), dtype=torch.float32, device=w.device)
        return layer_reg_value(w, _delta_for(w, f), cfg.n_bits, _m_l(shards, path))

    parts = tree_map_with_path(per_leaf, params, state.f)
    if shards is not None:
        return shards.sum_over_shards(dict(flatten_with_paths(parts)))
    return sum(tree_leaves(parts))


def reg_grad(params: Any, state: SymogState, cfg: SymogConfig, shards=None) -> Any:
    """∂R/∂Θ (paper Eq. 4); zeros for non-quantizable leaves."""

    def per_leaf(path, w, f):
        if not state.mask[path]:
            return torch.zeros_like(w)
        return layer_reg_grad(w, _delta_for(w, f).to(w.dtype), cfg.n_bits, _m_l(shards, path))

    return tree_map_with_path(per_leaf, params, state.f)


def clip_tree(params: Any, state: SymogState, cfg: SymogConfig) -> Any:
    """Paper §3.4 / Alg. 1 line 17 — post-update weight clipping."""
    if not cfg.clip:
        return params

    def per_leaf(path, w, f):
        if not state.mask[path]:
            return w
        return clip_to_range(w, _delta_for(w, f), cfg.n_bits)

    return tree_map_with_path(per_leaf, params, state.f)


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


def mode_tree(params: Any, state: SymogState, cfg: SymogConfig) -> Any:
    """int8 mode assignment per quantizable leaf (Figure 4 bookkeeping)."""

    def per_leaf(path, w, f):
        if not state.mask[path]:
            return torch.zeros((1,), dtype=torch.int8, device=w.device)
        return _metrics.mode_assignment(w, _delta_for(w, f), cfg.n_bits)

    return tree_map_with_path(per_leaf, params, state.f)


def quant_error_metrics(params: Any, state: SymogState, cfg: SymogConfig,
                        shards=None) -> Dict[str, Any]:
    """Aggregate relative quantization error + R(Θ) for logging (over the
    shards' whole leaves with ``shards``)."""
    f_by_path = dict(flatten_with_paths(state.f))
    dev = tree_leaves(params)[0].device
    sq_err, sq_w = {}, {}
    for path, w in flatten_with_paths(params):
        if not state.mask.get(path, False):
            continue
        wf = w.to(torch.float32)
        err = wf - quantize(wf, _delta_for(wf, f_by_path[path]), cfg.n_bits)
        sq_err[path] = torch.sum(err * err)
        sq_w[path] = torch.sum(wf * wf)
    if shards is not None:
        e, s = shards.sum_over_shards(sq_err), shards.sum_over_shards(sq_w)
    else:
        e = s = torch.zeros((), device=dev)
        for path in sq_err:
            e, s = e + sq_err[path], s + sq_w[path]
    return {
        "rel_quant_error": torch.sqrt(e) / (torch.sqrt(s) + 1e-12),
        "reg_value": reg_value(params, state, cfg, shards),
    }
