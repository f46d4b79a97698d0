"""LM assembly for the decoder family (mirrors ``repro/models/lm.py``):
embeddings → layer groups → head, plus prefill, decode and the training
loss, and the tail prefill over the paged pool (``prefill_prefix_lm``).
Dense decoders (internlm2, gemma2, gemma3, granite) serve and train; MoE decoders
(olmoe; deepseek-v3 with MLA attention and leading dense layers) serve, and
their training (aux/z losses, per-expert SYMOG update, deepseek's MTP loss)
is not ported yet.

Consecutive layers of one kind form a group whose params carry a stacked
leading layer axis (``GroupSpec``/``scan_groups``, the JAX scan layout), so
a bridged JAX tree is used as is.  Where JAX runs ``lax.scan`` over that
axis, the port runs a Python loop over layer views.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import (
    block_apply,
    block_cache_init,
    block_decode,
    block_init,
    block_prefill_paged,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    embed_apply,
    embed_init,
    embed_logits,
    layernorm_apply,
    layernorm_init,
    rmsnorm_apply,
    rmsnorm_init,
    rope_table,
    softcap as softcap_fn,
)
from repro_torch.models.attention import decode_positions, paged_token_index
from repro_torch.models.quantized import scan_ready, unstack_layers
from repro_torch.nn.tree import tree_map

# cache leaves that live in the paged block pool under the scheduler: the
# per-token attention streams, standard k/v and MLA's compressed c_kv/k_rope
PAGED_CACHE_LEAVES = frozenset({"k", "v", "c_kv", "k_rope"})
_PAGED_KINDS = frozenset({"A", "D", "E"})


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    name: str
    unit: Tuple[str, ...]  # kinds applied per step
    count: int  # stacked length (1 => unstacked)
    offset: int  # first layer index

    @property
    def stacked(self) -> bool:
        return self.count > 1

    @property
    def paged(self) -> Tuple[bool, ...]:
        return tuple(k in _PAGED_KINDS for k in self.unit)


def scan_groups(cfg: ModelConfig) -> List[GroupSpec]:
    """Runs of identical layer kinds -> groups (cyclic patterns are not part
    of this slice's decoder family)."""
    kinds = cfg.layer_kinds()
    runs: List[Tuple[str, int]] = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    if len(runs) > 2:
        raise NotImplementedError("cyclic layer patterns (hybrid family) are not ported yet")
    groups, off = [], 0
    for i, (k, c) in enumerate(runs):
        groups.append(GroupSpec(f"layers{i}", (k,), c, off))
        off += c
    return groups


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    caches: Any  # None unless prefill
    hidden: Optional[torch.Tensor]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 12)"
        )


def _norm_init(cfg, dtype, device):
    if cfg.norm == "rmsnorm":
        return rmsnorm_init(cfg.d_model, dtype, device)
    return layernorm_init(cfg.d_model, dtype, device)


def _norm_apply(cfg, p, x):
    return rmsnorm_apply(p, x) if cfg.norm == "rmsnorm" else layernorm_apply(p, x)


def init_lm(seed, cfg: ModelConfig, dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random params from ``seed`` (an int, or a ``torch.Generator`` on the
    target device).  Runs on the card unless ``device`` says otherwise.
    Values differ from the JAX package's for the same seed (``jax.random``
    vs ``torch.Generator``); parity tests bridge JAX params instead."""
    _check_family(cfg)
    if isinstance(seed, torch.Generator):
        gen = seed
        dev = resolve_device(device if device is not None else gen.device)
        if gen.device != dev:
            raise ValueError(f"generator on {gen.device}, params requested on {dev}")
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    params: Dict[str, Any] = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype)}
    for g in scan_groups(cfg):
        lead = (g.count,) if g.stacked else ()
        params[g.name] = {
            f"sub{j}": block_init(gen, cfg, kind, dtype, lead) for j, kind in enumerate(g.unit)
        }
    params["final_norm"] = _norm_init(cfg, dtype, dev)
    if not cfg.tie_lm_head:
        params["lm_head"] = dense_init(gen, (cfg.d_model,), (cfg.vocab_size,),
                                       stddev=1.0 / math.sqrt(cfg.d_model), dtype=dtype)
    if cfg.use_mtp:  # the JAX tree's MTP module; only its training loss reads it
        params["mtp"] = {
            "norm_h": _norm_init(cfg, dtype, dev),
            "norm_e": _norm_init(cfg, dtype, dev),
            "proj": dense_init(gen, (2 * cfg.d_model,), (cfg.d_model,),
                               stddev=1.0 / math.sqrt(2 * cfg.d_model), dtype=dtype),
            "block": block_init(gen, cfg, "E" if cfg.moe else "A", dtype),
            "final_norm": _norm_init(cfg, dtype, dev),
        }
    return params


def _group_layers(gp, spec: GroupSpec):
    """(layer index, layer params) over a group: views of the stacked axis."""
    if not spec.stacked:
        yield spec.offset, gp
        return
    for i, p_l in enumerate(unstack_layers(scan_ready(gp, spec.count), spec.count)):
        yield spec.offset + i, p_l


def _head(params, cfg: ModelConfig, x):
    h = _norm_apply(cfg, params["final_norm"], x)
    if cfg.tie_lm_head:
        logits = embed_logits(params["embed"], h)
    else:
        logits = dense_apply(params["lm_head"], h.to(torch.float32))
    if cfg.final_softcap > 0:
        logits = softcap_fn(logits, cfg.final_softcap)
    return logits, h


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor) -> Dict[float, Any]:
    """One ``rope_table`` per distinct layer rope base: the positions are the
    same for every layer of a forward or decode step.  MLA ropes only the
    qk_rope_dim part of its queries and its shared key."""
    if not cfg.use_rope:
        return {}
    width = cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
    return {b: rope_table(positions, b, width) for b in set(cfg.layer_rope_bases())}


def _embed_tokens(params, cfg: ModelConfig, tokens, compute_dtype):
    x = embed_apply(params["embed"], tokens, compute_dtype=compute_dtype)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def forward_lm(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
               compute_dtype=torch.bfloat16, prefill_len: int = 0, last_only: bool = False,
               seq_len: Optional[int] = None) -> ForwardOut:
    """Full-sequence forward.  ``prefill_len`` > 0 also returns the caches
    padded to that length; ``seq_len`` marks the real length of a
    right-padded (bucketed) prompt, so ``last_only`` reads its last REAL
    position."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    wins, bases = cfg.layer_windows(), cfg.layer_rope_bases()
    tables = _rope_tables(cfg, positions)
    caches: Dict[str, Any] = {}
    for g in scan_groups(cfg):
        per_layer = []
        for li, p_l in _group_layers(params[g.name], g):
            x, c = block_apply(p_l["sub0"], x, cfg=cfg, kind=g.unit[0], positions=positions,
                               window=wins[li], rope_base=bases[li],
                               compute_dtype=compute_dtype, cache_len=prefill_len,
                               rope_table=tables.get(bases[li]), seq_len=seq_len)
            per_layer.append(c)
        if prefill_len:
            sub = per_layer[0] if not g.stacked else {
                name: torch.stack([c[name] for c in per_layer]) for name in per_layer[0]
            }
            caches[g.name] = {"sub0": sub}
    if last_only:
        x = x[:, -1:] if seq_len is None else x[:, seq_len - 1 : seq_len]
    logits, hidden = _head(params, cfg, x)
    return ForwardOut(logits=logits, caches=caches if prefill_len else None, hidden=hidden)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None):
    """Zero dense caches for every layer; ``device="meta"`` gives their
    shapes and dtypes without memory (the port's ``jax.eval_shape``)."""
    _check_family(cfg)
    if dtype is None:
        dtype = torch.int8 if cfg.kv_cache_dtype == "int8_fp" else torch.bfloat16
    return {
        g.name: {"sub0": block_cache_init(batch, max_len, cfg, g.unit[0], dtype, device,
                                          (g.count,) if g.stacked else ())}
        for g in scan_groups(cfg)
    }


def decode_lm(params, caches, tokens, pos, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
              active: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None):
    """One decode step.  tokens (B,1); ``pos`` an int (uniform batch) or a
    (B,) int32 tensor (per-request positions).  ``block_tables`` (B,
    max_blocks) switches k/v to the paged pools; ``active`` (B,) bool then
    zeroes inactive rows at the embedding, an evicted row's zeroed table
    row sends its writes to the trash block, and MoE layers run dropless
    (capacity = batch rows), as in the JAX package.  (The JAX package also reverts
    inactive rows' writes into dense caches; the port's scheduler pages every
    cache, so ``active`` is taken with ``block_tables`` only.)  Caches are
    updated in place.  Returns (logits (B,1,V), caches)."""
    _check_family(cfg)
    if active is not None and block_tables is None:
        raise ValueError("active rows are gated through block_tables (paged caches) only")
    B = tokens.shape[0]
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    if active is not None:
        x = x * active.to(x.dtype).reshape(B, 1, 1)
    wins, bases = cfg.layer_windows(), cfg.layer_rope_bases()
    positions, _ = decode_positions(pos, B, x.device)
    tables = _rope_tables(cfg, positions)
    for g in scan_groups(cfg):
        gc = caches[g.name]["sub0"]
        paged = block_tables is not None and g.paged[0]
        index = None
        if paged:  # every layer of the group writes the same pool slot
            leaf = next(gc[n] for n in gc if n in PAGED_CACHE_LEAVES)
            block = leaf.shape[2 if g.stacked else 1]
            index = paged_token_index(block_tables, positions[:, 0], block)
        for li, p_l in _group_layers(params[g.name], g):
            c_l = {n: (leaf[li - g.offset] if g.stacked else leaf) for n, leaf in gc.items()}
            x, _ = block_decode(p_l["sub0"], x, c_l, pos, cfg=cfg, kind=g.unit[0],
                                window=wins[li], rope_base=bases[li],
                                compute_dtype=compute_dtype,
                                block_tables=block_tables if paged else None,
                                rope_table=tables.get(bases[li]), cache_index=index,
                                dropless_moe=active is not None)
    logits, _ = _head(params, cfg, x)
    return logits, caches


def prefill_lm(params, batch, cfg: ModelConfig, *, max_len: int, compute_dtype=torch.bfloat16,
               last_only: bool = True, seq_len: Optional[int] = None):
    """Process the prompt; returns (last-position logits, caches to max_len)."""
    out = forward_lm(params, batch, cfg, compute_dtype=compute_dtype, prefill_len=max_len,
                     last_only=last_only, seq_len=seq_len)
    return out.logits, out.caches


def prefill_prefix_lm(params, batch, caches, bt_row, start: int, cfg: ModelConfig, *,
                      seq_len: int, compute_dtype=torch.bfloat16):
    """Tail prefill of one request over the paged pool: only the uncached
    suffix of a prompt whose first ``start`` tokens already sit in the pool
    blocks named by ``bt_row`` (max_blocks,) int32.

    ``batch['tokens']`` is the (1, bucket) right-padded tail and ``seq_len``
    its real length.  Every layer writes the tail's k/v into the pool at
    global positions ``start + i`` before it attends, so each query reads
    real KV across its causal horizon.  The JAX package unrolls the layers
    over a flattened pool with a ``+ i·n_phys`` row shift; here layer i
    addresses its slice of the stacked pool directly, which writes the same
    bits.  Returns the logits (1, 1, V) at the last REAL tail position
    (never the (1, T, V) logits) and the pool, updated in place.

    Only the fully-paged tier: all-attention decoders.  MoE capacity
    competition couples a token's output to the whole prompt, and MLA's
    compressed cache has no tail form here, so both raise, as in JAX."""
    if cfg.family != "decoder" or cfg.moe or cfg.use_mla:
        raise NotImplementedError(
            "tail prefill supports only fully-paged all-attention decoders "
            f"(got family={cfg.family!r}, moe={cfg.moe}, mla={cfg.use_mla})"
        )
    tokens = batch["tokens"]
    T = tokens.shape[1]
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    positions = (int(start) + torch.arange(T, dtype=torch.int32, device=x.device))[None]
    wins, bases = cfg.layer_windows(), cfg.layer_rope_bases()
    tables = _rope_tables(cfg, positions)
    for g in scan_groups(cfg):
        gc = caches[g.name]["sub0"]
        for li, p_l in _group_layers(params[g.name], g):
            c_l = {n: (leaf[li - g.offset] if g.stacked else leaf) for n, leaf in gc.items()}
            x, _ = block_prefill_paged(p_l["sub0"], x, c_l, bt_row, positions, cfg=cfg,
                                       seq_len=seq_len, window=wins[li], rope_base=bases[li],
                                       compute_dtype=compute_dtype,
                                       rope_table=tables.get(bases[li]))
    logits, _ = _head(params, cfg, x[:, seq_len - 1: seq_len])
    return logits, caches


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood in fp32 (``mask`` weights it)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].to(torch.int64)).squeeze(-1)
    if mask is None:
        return -torch.mean(ll)
    mask = mask.to(torch.float32)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def lm_train_loss(params, batch, cfg: ModelConfig, *, compute_dtype=torch.bfloat16):
    """(loss, metrics) of a dense decoder.  The MoE aux losses and the MTP
    loss come with MoE training: an MoE or MTP config raises."""
    if cfg.moe or cfg.use_mtp:
        raise NotImplementedError(
            "training MoE decoders (aux/z losses, per-expert SYMOG update, the MTP loss) is "
            "not ported yet (ROADMAP Queue 1 item 12)"
        )
    out = forward_lm(params, batch, cfg, compute_dtype=compute_dtype)
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    ce = cross_entropy(out.logits[:, :-1], tokens[:, 1:], None if mask is None else mask[:, 1:])
    return ce, {"ce": ce, "loss": ce}


class DecoderLM(torch.nn.Module):
    """``nn.Module`` holding the port's parameter tree (JAX keys, stacked
    layer axes).  ``.to(device)`` / ``.cuda()`` move every leaf, ``Packed``
    words and exponents included; the forward functions take the tree."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.params = params

    def _apply(self, fn, recurse=True):
        from repro_torch.core.packing import Packed

        def move(leaf):
            if isinstance(leaf, Packed):
                return Packed(fn(leaf.data), leaf.n_bits, fn(leaf.f))
            return fn(leaf) if isinstance(leaf, torch.Tensor) else leaf

        self.params = tree_map(move, self.params)
        return self

    def forward(self, tokens: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
        return forward_lm(self.params, {"tokens": tokens}, self.cfg,
                          compute_dtype=compute_dtype).logits

    def prefill(self, batch, *, max_len: int, compute_dtype=torch.bfloat16, **kw):
        return prefill_lm(self.params, batch, self.cfg, max_len=max_len,
                          compute_dtype=compute_dtype, **kw)

    def decode(self, caches, tokens, pos, *, compute_dtype=torch.bfloat16, **kw):
        return decode_lm(self.params, caches, tokens, pos, self.cfg,
                         compute_dtype=compute_dtype, **kw)
