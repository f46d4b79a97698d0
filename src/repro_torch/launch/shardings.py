"""Spec assembly for the launchers (the counterpart of
``repro/launch/shardings.py``): batch specs, cache specs and whole
TrainState spec trees built from the profile rules.  Each returns a tree
of specs (tuples of ``PartitionSpec`` entries) where JAX returns
``NamedSharding``s; ``nn.sharding.shard_tree`` / ``slice_for`` place them.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.models.config import ModelConfig
from repro_torch.nn.sharding import AbstractMesh, make_rules, pspec_tree_for_params
from repro_torch.nn.tree import tree_map_with_path


def _batch_axes(mesh: AbstractMesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _div(dim: int, mesh: AbstractMesh, axes) -> bool:
    size = math.prod(mesh.shape[a] for a in axes) if axes else 1
    return size > 1 and dim % size == 0


def data_shardings(specs: Any, mesh: AbstractMesh) -> Any:
    """Batch leaves: dim0 over (pod, data) when divisible, rest replicated."""
    axes = _batch_axes(mesh)

    def one(path, s):
        if len(s.shape) >= 1 and _div(s.shape[0], mesh, axes):
            return (axes,) + (None,) * (len(s.shape) - 1)
        return ()

    return tree_map_with_path(one, specs)


def cache_shardings(caches: Any, cfg: ModelConfig, mesh: AbstractMesh) -> Any:
    """KV/state caches: batch over (pod,data); the head/channel dim over
    ``model`` when divisible — MQA/MLA caches (kv_heads=1 / rank dims) fall
    back to sharding the *sequence* dim over ``model``.  Handles the
    stacked (L, B, ...) leading dim of scanned layer groups."""
    baxes = _batch_axes(mesh)
    msize = mesh.shape.get("model", 1)

    def try_model(spec, shape, dims):
        if "model" not in mesh.axis_names or msize <= 1:
            return
        for d in dims:
            if d < len(shape) and spec[d] is None and shape[d] % msize == 0:
                spec[d] = "model"
                return

    def one(path, s):
        shape = tuple(s.shape)
        stacked = bool(re.search(r"(^|/)(layers|units|blocks)\d*/", path)) and len(shape) >= 2
        off = 1 if stacked else 0
        spec = [None] * len(shape)
        bdim = off
        if len(shape) > bdim and _div(shape[bdim], mesh, baxes):
            spec[bdim] = baxes
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("k", "v", "cross_k", "cross_v"):
            try_model(spec, shape, (off + 2, off + 1))  # kv-heads, else seq
        elif leaf in ("c_kv", "k_rope"):
            try_model(spec, shape, (off + 1,))  # seq (rank dim is contracted)
        elif leaf == "h":
            try_model(spec, shape, (off + 1,))  # ssd heads / rglru channels
        elif leaf == "conv":
            try_model(spec, shape, (off + 2,))  # channels
        return tuple(spec)

    return tree_map_with_path(one, caches)


def state_shardings(state_struct: Any, mesh: AbstractMesh, profile: str) -> Any:
    """Spec tree for a whole TrainState (params + opt + symog)."""
    return pspec_tree_for_params(make_rules(mesh, profile), state_struct)


def param_shardings(params_struct: Any, cfg: ModelConfig, mesh: AbstractMesh) -> Any:
    return pspec_tree_for_params(make_rules(mesh, cfg.sharding_profile), params_struct)

