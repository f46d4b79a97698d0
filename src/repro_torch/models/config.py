"""Unified architecture config (a copy of ``repro/models/config.py``: the
port imports nothing of the JAX package), cut to the fields the port
reads.  The port serves the decoder family's attention+MLP kind ('A'), an
MoE model's leading dense layers ('D', deepseek-v3) and attention+MoE kind
('E', olmoe and deepseek-v3: one SYMOG Δ per expert), with GQA or MLA
attention (``use_mla``, deepseek-v3), from a bf16 pool or a SYMOG-quantized
int8/int4 KV pool (``kv_cache_dtype``).  Fields
of the other families come back with the slice that ports them.
``layer_kinds`` derives the per-layer block kind: 'A' attention+MLP, 'D'
an MoE model's leading dense layers, 'E' attention+MoE, 'R' RG-LRU block
(not ported).
Attention local/global heterogeneity (gemma2/3) is NOT a separate kind — it
is per-layer scanned scalars (window, rope base), so the whole stack stays a
single scan in JAX (a Python loop over the stacked layer axis here).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

GLOBAL_WINDOW = 2**30  # sentinel: effectively unbounded window


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'decoder' | 'encdec' | 'hybrid' | 'vlm' | 'ssm'
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    # mlp
    mlp_gated: bool = True
    act: str = "silu"
    # attention
    rope_base: float = 10000.0
    rope_base_local: float = 0.0  # gemma3: local layers use a different base
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 0  # local window size; 0 = all-global
    layer_pattern: str = "G"  # cycled unit, chars: G global-attn, L local-attn, R recurrent
    attn_bias: bool = False
    use_rope: bool = True  # whisper: sinusoidal/learned absolute positions
    query_scale: Optional[float] = None
    embed_scale: bool = False  # gemma: embeddings × sqrt(d_model)
    tie_lm_head: bool = True
    norm: str = "rmsnorm"
    post_norm: bool = False  # gemma2/3: post-sublayer norms
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0  # deepseek: leading dense-FFN layers (kind 'D')
    router: str = "softmax"
    capacity_factor: float = 1.25
    # mla (deepseek): low-rank q and compressed kv (rank r = kv_lora_rank);
    # the paged pools hold c_kv (r) and k_rope (qk_rope_dim) per token
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # mtp (deepseek): the multi-token-prediction module is built by
    # ``init_lm`` so that trees match JAX's; only the training loss reads it
    use_mtp: bool = False
    mtp_weight: float = 0.3
    # 'bf16' | 'int8_fp' | 'int4_fp'.  Dense caches use the global Δ=2^-5
    # int8 grid for int8_fp (int4_fp keeps the compute dtype there); paged
    # pools store int8/packed-int4 mantissas with a per-(block, KV head)
    # power-of-two scale.  All-attention decoders admit to a quantized pool
    # through the tail prefill, MoE decoders through the bucketed prefill
    # plus a quantizing block scatter.
    kv_cache_dtype: str = "bf16"

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> List[str]:
        """Per-layer block kind for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            c = self.layer_pattern[i % len(self.layer_pattern)]
            if c == "R":
                kinds.append("R")
            elif self.moe:
                kinds.append("D" if i < self.n_dense_layers else "E")
            else:
                kinds.append("A")
        return kinds

    def layer_windows(self) -> List[int]:
        """Per-layer attention window (GLOBAL_WINDOW for global layers)."""
        out = []
        for i in range(self.n_layers):
            c = self.layer_pattern[i % len(self.layer_pattern)]
            out.append(self.window if c == "L" and self.window else GLOBAL_WINDOW)
        return out

    def layer_rope_bases(self) -> List[float]:
        out = []
        for i in range(self.n_layers):
            c = self.layer_pattern[i % len(self.layer_pattern)]
            local = c == "L" and self.rope_base_local > 0
            out.append(self.rope_base_local if local else self.rope_base)
        return out
