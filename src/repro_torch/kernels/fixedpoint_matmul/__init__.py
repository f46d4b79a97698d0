from repro_torch.kernels.fixedpoint_matmul.ops import (
    fixedpoint_matmul,
    fixedpoint_matmul_experts,
    pack_weight,
)

__all__ = ["fixedpoint_matmul", "fixedpoint_matmul_experts", "pack_weight"]
