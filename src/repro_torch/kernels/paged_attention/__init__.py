from repro_torch.kernels.paged_attention.ops import paged_attention

__all__ = ["paged_attention"]
