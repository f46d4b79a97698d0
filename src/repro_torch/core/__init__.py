"""SYMOG core (the parts the serving artifact needs): quantizer, Δ=2^-f
search, packing and the tree-level init / quantize / pack."""
from repro_torch.core.packing import (
    Packed,
    pack,
    pack_int,
    unpack,
    unpack_int,
    values_per_byte,
)
from repro_torch.core.quantizer import (
    clip_range,
    clip_to_range,
    delta_from_f,
    qmax_int,
    quant_error,
    quantize,
    quantize_int,
)
from repro_torch.core.stepsize import F_MAX, F_MIN, optimal_f, sse_for_f
from repro_torch.core.symog import (
    DEFAULT_EXCLUDES,
    SymogConfig,
    SymogState,
    default_quant_filter,
    pack_tree,
    quantize_tree,
    symog_init,
)

__all__ = [
    "DEFAULT_EXCLUDES",
    "F_MAX",
    "F_MIN",
    "Packed",
    "SymogConfig",
    "SymogState",
    "clip_range",
    "clip_to_range",
    "default_quant_filter",
    "delta_from_f",
    "optimal_f",
    "pack",
    "pack_int",
    "pack_tree",
    "qmax_int",
    "quant_error",
    "quantize",
    "quantize_int",
    "quantize_tree",
    "sse_for_f",
    "symog_init",
    "unpack",
    "unpack_int",
    "values_per_byte",
]
