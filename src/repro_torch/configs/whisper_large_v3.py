"""whisper-large-v3 [audio, enc-dec] — arXiv:2212.04356.

32 encoder + 32 decoder layers, d=1280, 20 MHA heads (head_dim 64),
non-gated GELU d_ff=5120, biased projections, layer norms, vocab=51866.
The conv / mel frontend is a stub: each request carries precomputed frame
embeddings (1, 1500, 1280).  The decoder's positions are sinusoidal, as in
the JAX package (whisper's own are learned, sized 448).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_encoder_layers=32,
    encoder_len=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    mlp_gated=False,
    act="gelu",
    attn_bias=True,
    use_rope=False,
    norm="layernorm",
    tie_lm_head=True,
)

REDUCED = ModelConfig(
    name="whisper-large-v3-reduced",
    family="encdec",
    n_layers=2,
    n_encoder_layers=2,
    encoder_len=12,
    d_model=32,
    n_heads=4,
    n_kv_heads=4,
    head_dim=8,
    d_ff=64,
    vocab_size=256,
    mlp_gated=False,
    act="gelu",
    attn_bias=True,
    use_rope=False,
    norm="layernorm",
    remat=False,
)
