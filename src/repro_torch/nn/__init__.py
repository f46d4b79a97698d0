"""Functional NN toolkit of the port (mirrors ``repro/nn``): nested-dict
param trees, dtype policies and initializers; the sharding rules and the
mesh are ``nn.sharding``."""
from repro_torch.nn.dtypes import DEFAULT_POLICY, FP32_POLICY, DTypePolicy
from repro_torch.nn.initializers import (
    he_normal,
    lecun_normal,
    normal_init,
    ones_init,
    scaled_normal,
    truncated_normal_stddev,
    zeros_init,
)
from repro_torch.nn.tree import (
    flatten_with_paths,
    is_packed,
    path_str,
    tree_bytes,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_paths,
    tree_select,
    tree_size,
    tree_to,
)

__all__ = [
    "DEFAULT_POLICY",
    "DTypePolicy",
    "FP32_POLICY",
    "flatten_with_paths",
    "he_normal",
    "is_packed",
    "lecun_normal",
    "normal_init",
    "ones_init",
    "path_str",
    "scaled_normal",
    "tree_bytes",
    "tree_leaves",
    "tree_map",
    "tree_map_with_path",
    "tree_paths",
    "tree_select",
    "tree_size",
    "tree_to",
    "truncated_normal_stddev",
    "zeros_init",
]
