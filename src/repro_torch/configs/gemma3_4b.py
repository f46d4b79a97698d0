"""gemma3-4b [dense, 5:1 local:global, 128k] — hf:google/gemma-3-4b-pt.

34 layers in LLLLLG pattern (window 1024), d=2560, 8 heads (kv=4,
head_dim 256), gated-gelu d_ff=10240, vocab=262144.  qk-norm, post-norms,
dual RoPE bases (10k local / 1M global).  The 262k-row embedding is the
single largest SYMOG win (2-bit ⇒ 16× smaller than fp32).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="decoder",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    act="gelu",
    layer_pattern="LLLLLG",
    window=1024,
    rope_base=1e6,
    rope_base_local=10000.0,
    qk_norm=True,
    post_norm=True,
    embed_scale=True,
)

REDUCED = ModelConfig(
    name="gemma3-4b-reduced",
    family="decoder",
    n_layers=6,
    d_model=32,
    n_heads=4,
    n_kv_heads=2,
    head_dim=8,
    d_ff=64,
    vocab_size=512,
    act="gelu",
    layer_pattern="LLLLLG",
    window=8,
    rope_base=1e6,
    rope_base_local=10000.0,
    qk_norm=True,
    post_norm=True,
    embed_scale=True,
)
