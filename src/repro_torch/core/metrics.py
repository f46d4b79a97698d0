"""SYMOG training diagnostics (paper §4.4, Figures 3 & 4; mirrors
``repro/core/metrics.py``).

- mode assignment: the integer mantissa each weight currently rounds to;
- switch rate: fraction of weights whose mode changed since the last snapshot;
- mode stats: per-mode count / mean / std (the mixture's shape);
- relative quantization error: ||w - Q(w)|| / ||w||.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.quantizer import quantize, quantize_int
from repro_torch.nn.tree import tree_map


def mode_assignment(w: torch.Tensor, delta, n_bits: int) -> torch.Tensor:
    """int8 mantissa per weight — the weight's current fixed-point mode."""
    return quantize_int(w, delta, n_bits).to(torch.int8)


def switch_rate(prev_modes: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """Fraction of weights in a layer that changed mode (Figure 4)."""
    return torch.mean((prev_modes != modes).to(torch.float32))


def mode_stats(w: torch.Tensor, delta, n_bits: int) -> Dict[str, torch.Tensor]:
    """Per-mode count, centre and std of the mixture (Figure 3), indexed by
    mode m + qmax (2·qmax + 1 entries)."""
    q = 2 ** (n_bits - 1) - 1
    n_modes = 2 * q + 1
    m = quantize_int(w, delta, n_bits).to(torch.int64).reshape(-1) + q
    wf = w.to(torch.float32).reshape(-1)
    zeros = torch.zeros((n_modes,), dtype=torch.float32, device=w.device)
    counts = zeros.index_add(0, m, torch.ones_like(wf))
    sums = zeros.index_add(0, m, wf)
    sqs = zeros.index_add(0, m, wf * wf)
    mean = sums / torch.clamp(counts, min=1.0)
    var = torch.clamp(sqs / torch.clamp(counts, min=1.0) - mean**2, min=0.0)
    d = torch.as_tensor(delta, dtype=torch.float32, device=w.device).reshape(-1)[0]
    return {
        "count": counts,
        "mean": mean,
        "std": torch.sqrt(var),
        "centers": (torch.arange(n_modes, dtype=torch.float32, device=w.device) - q) * d,
    }


def relative_quant_error(w: torch.Tensor, delta, n_bits: int) -> torch.Tensor:
    wf = w.to(torch.float32)
    err = wf - quantize(wf, delta, n_bits)
    return torch.linalg.vector_norm(err) / (torch.linalg.vector_norm(wf) + 1e-12)


def tree_switch_rates(prev: Any, cur: Any) -> Any:
    return tree_map(switch_rate, prev, cur)
