"""Mixed-precision dtype policy (mirrors ``repro/nn/dtypes.py``).

Params are kept in ``param_dtype`` (fp32 by default: SYMOG's regularizer
gradient is a small quantization error that would drown in bf16 rounding),
compute runs in ``compute_dtype`` (bf16 on the card), and reductions and
logits in ``accum_dtype`` (fp32).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype) if x.dtype != self.compute_dtype else x

    def cast_accum(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.accum_dtype) if x.dtype != self.accum_dtype else x


DEFAULT_POLICY = DTypePolicy()
# CPU-test policy: everything fp32 (bf16 matmuls on the CPU are slow and lossy).
FP32_POLICY = DTypePolicy(compute_dtype=torch.float32)
