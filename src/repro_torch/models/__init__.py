from repro_torch.models.config import GLOBAL_WINDOW, ModelConfig
from repro_torch.models.lm import (
    DecoderLM,
    ForwardOut,
    GroupSpec,
    decode_lm,
    forward_lm,
    init_caches,
    init_lm,
    prefill_lm,
    scan_groups,
)
from repro_torch.models.quantized import (
    as_dense,
    is_packed,
    packed_dense_apply,
    packed_take,
    scan_ready,
    tree_has_packed,
    unpack_params,
)

__all__ = [
    "GLOBAL_WINDOW",
    "DecoderLM",
    "ForwardOut",
    "GroupSpec",
    "ModelConfig",
    "as_dense",
    "decode_lm",
    "forward_lm",
    "init_caches",
    "init_lm",
    "is_packed",
    "packed_dense_apply",
    "packed_take",
    "prefill_lm",
    "scan_groups",
    "scan_ready",
    "tree_has_packed",
    "unpack_params",
]
