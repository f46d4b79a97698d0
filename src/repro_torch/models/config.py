"""Unified architecture config (a copy of ``repro/models/config.py``: the
port imports nothing of the JAX package), cut to the fields the port
reads.  The port serves the decoder family's attention+MLP kind ('A'), an
MoE model's leading dense layers ('D', deepseek-v3) and attention+MoE kind
('E', olmoe and deepseek-v3: one SYMOG Δ per expert), with GQA or MLA
attention (``use_mla``, deepseek-v3), from a bf16 pool or a SYMOG-quantized
int8/int4 KV pool (``kv_cache_dtype``); and the recurrent families'
mamba2 SSD block ('M', family ``ssm``) and RG-LRU block + MLP ('R',
recurrentgemma's ``hybrid`` family beside local attention); whisper's
encoder-decoder (family ``encdec``: an encoder of bidirectional 'A' layers
and decoder 'A' layers with cross-attention) and paligemma's image-prefix
decoder (family ``vlm``: 'A' layers under a prefix-LM mask).
``layer_kinds`` derives the per-layer block kind: 'A' attention+MLP, 'D'
an MoE model's leading dense layers, 'E' attention+MoE, 'M' mamba2 SSD,
'R' RG-LRU block.
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
    # 'dispatch': the capacity dispatch of models/moe.py on every rank;
    # 'ep': expert-parallel all-to-all routing (models/moe_ep.py) when a
    # mesh's ``ep_axes`` multiply past 1 (the dispatch otherwise)
    moe_impl: str = "dispatch"
    # mesh axes the expert dim shards over; 2-D ('data', 'model') puts the
    # fewest experts on a rank
    ep_axes: tuple = ("model",)
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
    # ssm (mamba2)
    d_inner: int = 0
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 128
    # hybrid (recurrentgemma)
    d_rnn: int = 0
    rnn_heads: int = 0
    # encdec (whisper): the encoder's depth and its frame count (the stub
    # frontend feeds (B, encoder_len, d_model) frame embeddings)
    n_encoder_layers: int = 0
    encoder_len: int = 1500
    # vlm (paligemma): image-prefix length (patch embeddings at d_model)
    prefix_len: int = 0
    frontend_dim: int = 0  # stub embedding dim == d_model
    # training: recompute each layer's forward in the backward
    # (``torch.utils.checkpoint``)
    remat: bool = True
    # nn/sharding.py profile the param leaves shard by on a mesh
    sharding_profile: str = "dp_tp"
    # capability flags
    supports_long: bool = False  # sub-quadratic decode at 500k (the long_500k cell)

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> List[str]:
        """Per-layer block kind for the decoder stack."""
        if self.family == "ssm":
            return ["M"] * self.n_layers
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

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        D, V = self.d_model, self.vocab_size
        total = V * D  # embedding
        if not self.tie_lm_head:
            total += V * D
        kinds = self.layer_kinds()
        for k in kinds:
            if k == "M":
                R, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                total += D * (2 * R + 2 * N + H) + self.conv_width * (R + 2 * N)
                total += R * D + 3 * H + R
                continue
            if k == "R":
                R, H = self.d_rnn, self.rnn_heads
                dh = R // H
                total += 2 * D * R + self.conv_width * R + 2 * H * dh * dh + R * D
                total += 2 * D * self.d_ff + self.d_ff * D  # its MLP (gated)
                continue
            # attention
            if self.use_mla:
                total += D * self.q_lora_rank
                total += self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                total += D * self.kv_lora_rank + D * self.qk_rope_dim
                total += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                total += self.n_heads * self.v_head_dim * D
            else:
                hd = self.head_dim
                total += D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                total += self.n_heads * hd * D
            # ffn
            if k == "E":
                total += D * self.n_experts  # router
                total += self.n_experts * (3 * D * self.d_ff_expert)
                total += self.n_shared_experts * 3 * D * self.d_ff_expert
            elif k == "D" and self.moe:
                total += (3 if self.mlp_gated else 2) * D * self.d_ff
            else:
                total += (3 if self.mlp_gated else 2) * D * self.d_ff
        if self.family == "encdec":
            # encoder layers: attn + plain mlp
            hd = self.head_dim
            per = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
            per += 2 * D * self.d_ff
            # decoder cross-attn adds another attention per decoder layer
            total += self.n_encoder_layers * per
            per_dec = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
            total += self.n_layers * per_dec
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        kinds = self.layer_kinds()
        n_moe = sum(1 for k in kinds if k == "E")
        inactive = n_moe * (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff_expert
        return full - inactive
