from repro_torch.kernels.fixedpoint_matmul.ops import fixedpoint_matmul, pack_weight

__all__ = ["fixedpoint_matmul", "pack_weight"]
