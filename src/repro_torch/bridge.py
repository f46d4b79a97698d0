"""Bridge a JAX parameter tree into the port, through numpy.

``params_from_numpy`` takes the JAX tree with numpy leaves
(``jax.tree_util.tree_map(np.asarray, params)``) — nested dicts whose
``Packed`` leaves are duck-typed by ``.data``, ``.n_bits`` and ``.f`` — and
returns the port's tree on ``device``: same keys, same stacked layer axes,
same ``Packed.f`` shapes (a scan-stacked leaf keeps its scalar f).  It
imports neither jax nor the JAX package.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.packing import Packed


def _tensor(a, device) -> torch.Tensor:
    # np.array copies into a writable C-ordered array and, unlike
    # np.ascontiguousarray, keeps 0-d arrays 0-d (a stacked leaf's scalar f)
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("data", "n_bits", "f")) and not isinstance(
        tree, (np.ndarray, torch.Tensor)
    ):
        return Packed(
            data=_tensor(tree.data, device).to(torch.int8),
            n_bits=int(tree.n_bits),
            f=_tensor(tree.f, device).to(torch.int32),
        )
    return _tensor(tree, device)
