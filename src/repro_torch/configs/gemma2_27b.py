"""gemma2-27b [dense, local+global alternating, logit softcap] — arXiv:2408.00118.

46 layers in LG pattern (window 4096), d=4608, 32 heads (kv=16,
head_dim 128), gated-gelu d_ff=36864, vocab=256000.  Attention softcap 50,
final logit softcap 30, post-norms, query scale (d/H)^-0.5 = 144^-0.5.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="decoder",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    act="gelu",
    layer_pattern="LG",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    embed_scale=True,
    query_scale=144.0 ** -0.5,
    sharding_profile="fsdp_tp",
)

REDUCED = ModelConfig(
    name="gemma2-27b-reduced",
    family="decoder",
    n_layers=4,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    head_dim=8,
    d_ff=64,
    vocab_size=512,
    act="gelu",
    layer_pattern="LG",
    window=8,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    embed_scale=True,
    remat=False,
)
