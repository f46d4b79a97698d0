"""The SYMOG multimodal Gaussian prior (paper §3.2; mirrors
``repro/core/regularizer.py``).

    R(Θ) = Σ_l (1/M_l) Σ_i (w_{l,i} - Q_N(w_{l,i}; Δ_l))²

    ∂R/∂w_{l,i} = (2/M_l)(w_{l,i} - Q_N(w_{l,i}; Δ_l))        (Eq. 4)

M_l counts the whole leaf, the scan-stacked layer axis included.  The
quantizer's derivative is taken as identically zero, so the gradient is the
scaled quantization error.  Given a shard of a leaf (tensor- or FSDP-split
training), the caller passes the whole leaf's ``m_l``; the value's sum over
the shards is then the leaf's.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.quantizer import quant_error
from repro_torch.nn.tree import tree_leaves, tree_map


def layer_reg_value(w: torch.Tensor, delta, n_bits: int, m_l=None) -> torch.Tensor:
    """(1/M_l)·Σ (w - Q(w))² for one layer (M_l: ``m_l``, else w's count)."""
    m_l = float(math.prod(w.shape) if m_l is None else m_l)
    err = quant_error(w.to(torch.float32), delta, n_bits)
    return torch.sum(torch.square(err)) / m_l


def layer_reg_grad(w: torch.Tensor, delta, n_bits: int, m_l=None) -> torch.Tensor:
    """(2/M_l)·(w - Q(w)) for one layer (Eq. 4; M_l as ``layer_reg_value``)."""
    m_l = float(math.prod(w.shape) if m_l is None else m_l)
    return (2.0 / m_l) * quant_error(w, delta, n_bits)


def tree_reg_value(quantizable: Any, deltas: Any, n_bits: int) -> torch.Tensor:
    """R(Θ) summed over all quantizable leaves (mask handled upstream)."""
    vals = tree_leaves(tree_map(lambda w, d: layer_reg_value(w, d, n_bits), quantizable, deltas))
    return sum(vals) if vals else torch.zeros(())


def tree_reg_grad(quantizable: Any, deltas: Any, n_bits: int) -> Any:
    """∂R/∂Θ per leaf (Eq. 4), same structure as ``quantizable``."""
    return tree_map(lambda w, d: layer_reg_grad(w, d, n_bits), quantizable, deltas)
