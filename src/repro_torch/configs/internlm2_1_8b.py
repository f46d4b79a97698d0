"""internlm2-1.8b [dense, GQA] — arXiv:2403.17297.

24 layers, d=2048, 16 heads (kv=8), gated-silu d_ff=8192, vocab=92544,
RoPE base 1e6 (internlm2 long-context base).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="decoder",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    rope_base=1e6,
)

REDUCED = ModelConfig(
    name="internlm2-1.8b-reduced",
    family="decoder",
    n_layers=3,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    head_dim=8,
    d_ff=64,
    vocab_size=256,
    rope_base=1e6,
    remat=False,
)
