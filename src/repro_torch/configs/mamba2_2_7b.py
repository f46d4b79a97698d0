"""mamba2-2.7b [SSM: SSD / state-space duality] — arXiv:2405.21060.

64 layers, d=2560, d_inner=5120 (expand 2), 80 heads × P=64, N=128 state,
conv width 4, vocab=50280.  Attention-free: each slot's decode state is
O(1) in the sequence length.  SSD chunk = 128 (the chunked scan of
``models/ssd.py``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    vocab_size=50280,
    d_inner=5120,
    ssm_heads=80,
    ssm_head_dim=64,
    ssm_state=128,
    conv_width=4,
    ssd_chunk=128,
    supports_long=True,
)

REDUCED = ModelConfig(
    name="mamba2-2.7b-reduced",
    family="ssm",
    n_layers=3,
    d_model=32,
    vocab_size=256,
    d_inner=64,
    ssm_heads=4,
    ssm_head_dim=16,
    ssm_state=8,
    conv_width=4,
    ssd_chunk=8,
    remat=False,
    supports_long=True,
)
