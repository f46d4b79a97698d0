"""granite-34b [dense, MQA, code] — arXiv:2405.04324.

88 layers, d=6144, 48 heads (kv=1, MQA), d_ff=24576 (non-gated GELU — the
GPT-BigCode-style MLP; a gated d_ff=24576 would be 47B params, not 34B),
vocab=49152, an untied head.  RoPE per the "llama-arch" note.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="decoder",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_gated=False,
    act="gelu",
    tie_lm_head=False,
    sharding_profile="fsdp_tp",
)

REDUCED = ModelConfig(
    name="granite-34b-reduced",
    family="decoder",
    n_layers=4,
    d_model=32,
    n_heads=4,
    n_kv_heads=1,
    head_dim=8,
    d_ff=64,
    vocab_size=256,
    tie_lm_head=False,
    remat=False,
)
