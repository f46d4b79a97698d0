from repro_torch.kernels.paged_attention.ops import paged_attention, paged_attention_mla

__all__ = ["paged_attention", "paged_attention_mla"]
