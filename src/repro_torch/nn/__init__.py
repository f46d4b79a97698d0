from repro_torch.nn.tree import (
    flatten_with_paths,
    is_packed,
    tree_bytes,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_to,
)

__all__ = [
    "flatten_with_paths",
    "is_packed",
    "tree_bytes",
    "tree_leaves",
    "tree_map",
    "tree_map_with_path",
    "tree_to",
]
