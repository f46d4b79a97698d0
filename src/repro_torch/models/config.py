"""Unified architecture config (a copy of ``repro/models/config.py``: the
port imports nothing of the JAX package), cut to the fields the port
reads.  The port serves the decoder family's attention+MLP kind ('A');
``n_experts``, ``use_mla`` and ``kv_cache_dtype`` are kept so that it can
reject what it does not serve yet.  Fields of the other families come back
with the slice that ports them.  ``layer_kinds`` derives the per-layer block
kind: 'A' attention+MLP, 'E' attention+MoE, 'R' RG-LRU block.
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
    # moe / mla: read only so that the port rejects those families
    n_experts: int = 0
    use_mla: bool = False
    # 'bf16' | 'int8_fp' | 'int4_fp' in the JAX package; the port serves
    # bf16 pools and rejects the fixed-point ones (ROADMAP).
    kv_cache_dtype: str = "bf16"

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> List[str]:
        """Per-layer block kind for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            c = self.layer_pattern[i % len(self.layer_pattern)]
            kinds.append("R" if c == "R" else "E" if self.moe else "A")
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
