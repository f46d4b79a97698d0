"""recurrentgemma-2b [hybrid: RG-LRU + local attention, 2:1] — arXiv:2402.19427.

26 layers in (R, R, local-attn) units, d=2560, lru width 2560, 10 MQA heads
(kv=1, head_dim 256), gated-gelu d_ff=7680, vocab=256000, window 2048.
The recurrent state is O(1) a slot; the local layers attend a 2048-token
window.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    act="gelu",
    layer_pattern="RRL",
    window=2048,
    d_rnn=2560,
    rnn_heads=10,
    embed_scale=True,
)

REDUCED = ModelConfig(
    name="recurrentgemma-2b-reduced",
    family="hybrid",
    n_layers=5,  # RRL + RR tail: one scanned unit and an unrolled tail
    d_model=32,
    n_heads=2,
    n_kv_heads=1,
    head_dim=16,
    d_ff=64,
    vocab_size=256,
    act="gelu",
    layer_pattern="RRL",
    window=8,
    d_rnn=32,
    rnn_heads=2,
    embed_scale=True,
    remat=False,
)
