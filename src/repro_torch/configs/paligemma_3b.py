"""paligemma-3b [vlm: SigLIP + gemma-2b backbone] — arXiv:2407.07726.

LM backbone: 18 layers, d=2048, 8 heads (kv=1 MQA, head_dim 256),
gated-gelu d_ff=16384, vocab=257216.  The SigLIP tower is a stub: each
request carries 256 precomputed patch embeddings at d_model; attention is
prefix-LM (bidirectional over the image prefix, causal over the text).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="gelu",
    prefix_len=256,
    embed_scale=True,
)

REDUCED = ModelConfig(
    name="paligemma-3b-reduced",
    family="vlm",
    n_layers=3,
    d_model=32,
    n_heads=4,
    n_kv_heads=1,
    head_dim=8,
    d_ff=64,
    vocab_size=512,
    act="gelu",
    prefix_len=8,
    embed_scale=True,
    remat=False,
)
