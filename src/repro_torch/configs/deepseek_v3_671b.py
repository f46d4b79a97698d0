"""deepseek-v3-671b [MoE: MLA, 1 shared + 256 routed top-8, MTP] —
arXiv:2412.19437.

61 layers (3 leading dense d_ff=18432, then MoE d_ff_e=2048 ×256 experts
top-8 + 1 shared), d=7168, 128 MLA heads (q_lora 1536, kv_lora 512,
qk 128nope+64rope, v 128), vocab=129280, sigmoid router, MTP depth 1.
SYMOG gives one Δ per expert (256 step sizes per layer and projection).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="decoder",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # the 3 dense layers
    vocab_size=129280,
    n_experts=256,
    top_k=8,
    d_ff_expert=2048,
    n_shared_experts=1,
    n_dense_layers=3,
    router="sigmoid",
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    use_mtp=True,
    tie_lm_head=False,
    moe_impl="ep",
    ep_axes=("data", "model"),  # 256 experts over 256 ranks: one a rank
    sharding_profile="fsdp_tp",
)

REDUCED = ModelConfig(
    name="deepseek-v3-671b-reduced",
    family="decoder",
    n_layers=4,
    d_model=32,
    n_heads=4,
    n_kv_heads=4,
    head_dim=8,
    d_ff=96,
    vocab_size=256,
    n_experts=8,
    top_k=2,
    d_ff_expert=16,
    n_shared_experts=1,
    n_dense_layers=1,
    router="sigmoid",
    use_mla=True,
    q_lora_rank=24,
    kv_lora_rank=16,
    qk_nope_dim=8,
    qk_rope_dim=4,
    v_head_dim=8,
    use_mtp=True,
    tie_lm_head=False,
    capacity_factor=8.0,  # dropless at smoke-test scale (exactness checks)
    remat=False,
)
