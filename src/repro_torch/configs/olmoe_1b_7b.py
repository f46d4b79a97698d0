"""olmoe-1b-7b [MoE: 64 experts, top-8] — arXiv:2409.02060.

16 layers, d=2048, 16 MHA heads (kv=16), 64 experts (top-8, d_ff_e=1024),
vocab=50304, qk-norm, untied head.  1B active / 7B total.  SYMOG gives one
Δ per expert (64 step sizes per layer and projection).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="decoder",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=2048,  # unused (all layers MoE)
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    d_ff_expert=1024,
    router="softmax",
    qk_norm=True,
    tie_lm_head=False,
)

REDUCED = ModelConfig(
    name="olmoe-1b-7b-reduced",
    family="decoder",
    n_layers=3,
    d_model=32,
    n_heads=4,
    n_kv_heads=4,
    head_dim=8,
    d_ff=64,
    vocab_size=256,
    n_experts=8,
    top_k=2,
    d_ff_expert=16,
    router="softmax",
    qk_norm=True,
    tie_lm_head=False,
    capacity_factor=8.0,  # dropless at smoke-test scale (exactness checks)
)
