"""LM assembly (mirrors ``repro/models/lm.py``): embeddings → layer groups
→ head, plus prefill, decode and the training loss, the tail prefill over
the paged pool (``prefill_prefix_lm``) and the speculative verify
(``decode_verify_lm``).
Dense decoders (internlm2, gemma2, gemma3, granite) and MoE decoders (olmoe;
deepseek-v3 with MLA attention and leading dense layers) serve and train;
MoE training adds the load-balancing and z losses summed over layers and,
for deepseek-v3, the multi-token-prediction loss (``_mtp_loss``).  The
training forward recomputes each layer in the backward when ``cfg.remat``
(``torch.utils.checkpoint``; JAX's ``jax.checkpoint`` over the scan body),
whisper's encoder layers too.
The recurrent families serve and train: mamba2 (family ``ssm``, SSD blocks)
and recurrentgemma (family ``hybrid``, RG-LRU blocks and local attention);
so do whisper (family ``encdec``: a bidirectional encoder over the batch's
frames, sinusoidal positions, decoder layers with cross-attention whose
k/v stay resident a slot when serving) and paligemma (family ``vlm``: the
batch's patch embeddings prefix the text under a prefix-LM mask).

Consecutive layers of one kind form a group whose params carry a stacked
leading layer axis (``GroupSpec``/``scan_groups``, the JAX scan layout), so
a bridged JAX tree is used as is; a cyclic pattern (recurrentgemma's RRL)
stacks whole units, one ``sub{j}`` per kind of the unit, and unrolls the
remainder as a ``tail`` group.  Where JAX runs ``lax.scan`` over that
axis, the port runs a Python loop over unit views.

Attention caches page into the serving pool; recurrent / SSD states,
conv windows, ring buffers and whisper's cross-kv stay resident per row
(``GroupSpec.paged``, ``PAGED_CACHE_LEAVES``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.blocks import (
    block_apply,
    block_cache_init,
    block_decode,
    block_init,
    block_prefill_paged,
    block_verify_paged,
    zero_aux,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    embed_apply,
    embed_init,
    embed_logits,
    gather_vocab,
    layernorm_apply,
    layernorm_init,
    rmsnorm_apply,
    rmsnorm_init,
    rope_table,
    sinusoidal_angles,
    sinusoidal_pos,
    softcap as softcap_fn,
)
from repro_torch.models.attention import decode_positions, paged_token_index, verify_token_index
from repro_torch.models.quantized import scan_ready, unstack_layers
from repro_torch.nn.tree import tree_map

# cache leaves that live in the paged block pool under the scheduler: the
# per-token attention streams, standard k/v and MLA's compressed c_kv/k_rope
PAGED_CACHE_LEAVES = frozenset({"k", "v", "c_kv", "k_rope"})
# whisper's per-layer encoder k/v: written once at admission, read by every
# decode step, resident a slot (never paged, never gated by ``active``)
CROSS_CACHE_LEAVES = ("cross_k", "cross_v")
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
    """Runs of identical layer kinds -> groups; a cyclic pattern (more than
    two runs) -> a ``units`` group stacking whole pattern units plus an
    unrolled ``tail`` group of the remainder layers."""
    kinds = cfg.layer_kinds()
    runs: List[Tuple[str, int]] = []
    for k in kinds:
        if runs and runs[-1][0] == k:
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    if len(runs) <= 2:
        groups, off = [], 0
        for i, (k, c) in enumerate(runs):
            groups.append(GroupSpec(f"layers{i}", (k,), c, off))
            off += c
        return groups
    u = len(cfg.layer_pattern)
    full, rem = divmod(cfg.n_layers, u)
    groups = [GroupSpec("units", tuple(kinds[:u]), full, 0)]
    if rem:
        groups.append(GroupSpec("tail", tuple(kinds[full * u:]), 1, full * u))
    return groups


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    caches: Any  # None unless prefill
    hidden: Optional[torch.Tensor]
    aux: Optional[Dict[str, torch.Tensor]] = None  # MoE losses summed over layers (training)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("decoder", "ssm", "hybrid", "encdec", "vlm"):
        raise NotImplementedError(f"unknown family {cfg.family!r}")


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """Whisper's encoder: the decoder's width, ``n_encoder_layers`` global
    'A' layers, run bidirectionally and without cross-attention."""
    return dataclasses.replace(cfg, n_layers=cfg.n_encoder_layers, layer_pattern="G")


def image_prefix_len(cfg: ModelConfig) -> int:
    """Positions paligemma's image prefix takes ahead of every row's text
    (family ``vlm``), else 0: a serve's positions, buckets and blocks
    start after it."""
    return cfg.prefix_len if cfg.family == "vlm" else 0


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
    cross = cfg.family == "encdec"

    def groups(gcfg, with_cross):
        return {g.name: {f"sub{j}": block_init(gen, gcfg, kind, dtype,
                                                (g.count,) if g.stacked else (), cross=with_cross)
                         for j, kind in enumerate(g.unit)}
                for g in scan_groups(gcfg)}

    if cross:
        params["encoder"] = groups(_enc_cfg(cfg), False)
        params["enc_final_norm"] = _norm_init(cfg, dtype, dev)
    params.update(groups(cfg, cross))
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
    """(unit index, index of the unit's first layer, unit params) over a
    group: views of the stacked axis.  Sub j of unit i is layer
    ``spec.offset + i·len(spec.unit) + j``."""
    if not spec.stacked:
        yield 0, spec.offset, gp
        return
    u = len(spec.unit)
    for i, p_u in enumerate(unstack_layers(scan_ready(gp, spec.count), spec.count)):
        yield i, spec.offset + i * u, p_u


def _unit_cache(gc, spec: GroupSpec, i: int):
    """Unit i's view of one sub's cache leaves (its slice of a stacked
    group's leading axis)."""
    return {n: (leaf[i] if spec.stacked else leaf) for n, leaf in gc.items()}


def _stack_caches(per_unit, spec: GroupSpec):
    """One sub's prefill caches, unit by unit -> the group's layout."""
    if not spec.stacked:
        return per_unit[0]
    return {name: torch.stack([c[name] for c in per_unit]) for name in per_unit[0]}


def _head(params, cfg: ModelConfig, x):
    h = _norm_apply(cfg, params["final_norm"], x)
    if cfg.tie_lm_head:
        logits = embed_logits(params["embed"], h)
    else:
        logits = dense_apply(params["lm_head"], h.to(torch.float32))
    logits = gather_vocab(logits)  # vocab-parallel: every rank gets the whole row
    if cfg.final_softcap > 0:
        logits = softcap_fn(logits, cfg.final_softcap)
    return logits, h


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor) -> Dict[float, Any]:
    """One ``rope_table`` per distinct layer rope base: the positions are the
    same for every layer of a forward or decode step.  MLA ropes only the
    qk_rope_dim part of its queries and its shared key."""
    if not cfg.use_rope or not any(k in _PAGED_KINDS for k in cfg.layer_kinds()):
        return {}
    width = cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
    return {b: rope_table(positions, b, width) for b in set(cfg.layer_rope_bases())}


def _embed_tokens(params, cfg: ModelConfig, tokens, compute_dtype):
    x = embed_apply(params["embed"], tokens, compute_dtype=compute_dtype)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _run_layers(params, cfg: ModelConfig, x, positions, *, compute_dtype, causal: bool = True,
                prefix_len: int = 0, enc_out=None, cache_len: int = 0, seq_len=None,
                with_aux: bool = False, remat: bool = False):
    """Every group of ``params`` (a stack of ``cfg``'s layers) over x.
    Returns (x, aux summed over layers or None, {group: caches} when
    ``cache_len``)."""
    wins, bases = cfg.layer_windows(), cfg.layer_rope_bases()
    tables = _rope_tables(cfg, positions)
    aux = zero_aux(x.device) if with_aux else None
    caches: Dict[str, Any] = {}
    for g in scan_groups(cfg):
        per_sub = [[] for _ in g.unit]
        for _, li0, p_u in _group_layers(params[g.name], g):
            for j, kind in enumerate(g.unit):
                li = li0 + j
                layer = functools.partial(
                    block_apply, p_u[f"sub{j}"], cfg=cfg, kind=kind, positions=positions,
                    window=wins[li], rope_base=bases[li], causal=causal, prefix_len=prefix_len,
                    compute_dtype=compute_dtype, enc_out=enc_out, cache_len=cache_len,
                    rope_table=tables.get(bases[li]), seq_len=seq_len, with_aux=with_aux)
                if remat:
                    x, a, c = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False)
                else:
                    x, a, c = layer(x)
                if with_aux:
                    aux = {k: aux[k] + a[k] for k in aux}
                per_sub[j].append(c)
        if cache_len:
            caches[g.name] = {f"sub{j}": _stack_caches(c, g) for j, c in enumerate(per_sub)}
    return x, aux, caches


def _run_encoder(params, cfg: ModelConfig, frames, compute_dtype, remat: bool = False):
    """Whisper's encoder over the frame embeddings (B, S, D): sinusoidal
    positions added in the compute dtype, bidirectional layers, the final
    norm.  ``remat`` recomputes each layer in the backward, as the decoder's
    (JAX's encoder runs under the same config's ``jax.checkpoint``).  The
    serving path runs it once an admission (JAX's prefill runs it twice:
    the same values)."""
    B, S, D = frames.shape
    x = frames.to(compute_dtype) + sinusoidal_pos(S, D, compute_dtype, frames.device)[None]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, _, _ = _run_layers(params["encoder"], _enc_cfg(cfg), x, pos, compute_dtype=compute_dtype,
                          causal=False, remat=remat)
    return _norm_apply(cfg, params["enc_final_norm"], x)


def forward_lm(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
               compute_dtype=torch.bfloat16, prefill_len: int = 0, last_only: bool = False,
               seq_len: Optional[int] = None, with_aux: bool = False) -> ForwardOut:
    """Full-sequence forward.  ``prefill_len`` > 0 also returns the caches
    padded to that length; ``seq_len`` marks the real length of a
    right-padded (bucketed) prompt, so ``last_only`` reads its last REAL
    position.  ``with_aux`` (training) fills ``aux`` with the MoE losses
    summed over layers, as JAX's scan sums them.  With ``cfg.remat`` and
    autograd on, each layer's activations are recomputed in the backward
    instead of kept (the values and grads are the same bits).

    whisper (``encdec``) reads ``batch['frames']`` (B, encoder_len, D): the
    encoder runs first, the tokens get sinusoidal positions, and every
    decoder layer cross-attends the encoder output (a prefill also caches
    each layer's cross-kv, bf16).  paligemma (``vlm``) reads
    ``batch['patches']`` (B, prefix_len, D): the unscaled patches come
    before the scaled token embeddings, positions run over both, attention
    is prefix-LM, and the prefix is dropped before the head; a prefill's
    caches hold the prefix's k/v ahead of the text's."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    enc_out, prefix_len = None, 0
    remat = cfg.remat and torch.is_grad_enabled() and not prefill_len
    if cfg.family == "encdec":
        enc_out = _run_encoder(params, cfg, batch["frames"], compute_dtype, remat=remat)
        x = x + sinusoidal_pos(T, cfg.d_model, compute_dtype, x.device)[None]
    elif cfg.family == "vlm":
        patches = batch["patches"].to(compute_dtype)
        prefix_len = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None].expand(
        B, x.shape[1])
    # the block-level valid length counts the (always real) image prefix
    x, aux, caches = _run_layers(
        params, cfg, x, positions, compute_dtype=compute_dtype, prefix_len=prefix_len,
        enc_out=enc_out, cache_len=prefill_len,
        seq_len=None if seq_len is None else seq_len + prefix_len, with_aux=with_aux,
        remat=remat)
    x = x[:, prefix_len:]
    if last_only:
        x = x[:, -1:] if seq_len is None else x[:, seq_len - 1 : seq_len]
    logits, hidden = _head(params, cfg, x)
    return ForwardOut(logits=logits, caches=caches if prefill_len else None, hidden=hidden,
                      aux=aux)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None, *,
                prefill: bool = False):
    """Zero decode caches for every layer, as the JAX package's: attention
    caches of ``dtype`` (int8 under ``int8_fp``, else bf16 by default), the
    SSD conv window in bf16 and the RG-LRU's in fp32, recurrent / SSD states
    in fp32; a hybrid model's local-attention layers get ring buffers of
    the window when it is shorter than ``max_len``; whisper's decoder
    layers get ``cross_k`` / ``cross_v`` (batch, encoder_len, K, hd) in the
    attention caches' dtype.

    ``prefill``: shaped and typed like ``prefill_lm(..., max_len)``'s caches
    at compute dtype ``dtype`` instead: attention caches of max_len entries
    in ``dtype`` (KV_F int8 under ``int8_fp``), conv windows in ``dtype``,
    no ring buffers, cross-kv in bf16 (JAX's prefill casts it so).  The
    serving pools take their layout from these, as JAX's take theirs from
    ``eval_shape`` of the prefill.  ``device="meta"`` gives shapes and
    dtypes without memory."""
    _check_family(cfg)
    int8 = cfg.kv_cache_dtype == "int8_fp"
    if prefill:
        kv, conv, cross = (torch.int8 if int8 else dtype), {"M": dtype, "R": dtype}, torch.bfloat16
    else:
        kv = dtype if dtype is not None else (torch.int8 if int8 else torch.bfloat16)
        conv, cross = {"M": torch.bfloat16, "R": torch.float32}, kv
    ring = cfg.family == "hybrid" and not prefill
    caches = {}
    for g in scan_groups(cfg):
        lead = (g.count,) if g.stacked else ()
        caches[g.name] = {}
        for j, kind in enumerate(g.unit):
            c = block_cache_init(batch, max_len, cfg, kind, conv.get(kind, kv), device, lead,
                                 ring=ring)
            if cfg.family == "encdec":
                shape = lead + (batch, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
                c.update({n: torch.zeros(shape, dtype=cross, device=device)
                          for n in CROSS_CACHE_LEAVES})
            caches[g.name][f"sub{j}"] = c
    return caches


def _write_back(cache, new, active: Optional[torch.Tensor]) -> None:
    """Copy a block's new resident state into its cache views, keeping an
    inactive row's old entries (``active`` None: every row)."""
    for name, old in cache.items():
        v = new[name]
        if v is old:
            continue
        if active is not None:
            v = torch.where(active.reshape((-1,) + (1,) * (v.ndim - 1)), v, old)
        old.copy_(v)


def decode_lm(params, caches, tokens, pos, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
              active: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None):
    """One decode step.  tokens (B,1); ``pos`` an int (uniform batch) or a
    (B,) int32 tensor (per-request positions).  ``block_tables`` (B,
    max_blocks) switches the attention caches (``GroupSpec.paged``, not a
    ring buffer) to the paged pools; an evicted row's zeroed table row sends
    its writes there to the trash block.  ``active`` (B,) bool zeroes
    inactive rows at the embedding, keeps every resident cache of an
    inactive row as it was (recurrent / SSD states, conv windows, dense and
    ring k/v: an evicted slot stays numerically frozen), and runs MoE
    layers dropless (capacity = batch rows), as in the JAX package.

    Caches are updated in place: paged and dense attention writes as they
    happen, resident recurrent states from the block's new tensors through
    ``torch.where(active, new, old)`` (a resident attention cache under
    ``active`` is written into a copy first).  Returns (logits (B,1,V),
    caches)."""
    _check_family(cfg)
    B = tokens.shape[0]
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    if active is not None:
        x = x * active.to(x.dtype).reshape(B, 1, 1)
    wins, bases = cfg.layer_windows(), cfg.layer_rope_bases()
    positions, _ = decode_positions(pos, B, x.device)
    if cfg.family == "encdec":  # each row's absolute sinusoidal position
        x = x + sinusoidal_angles(positions, cfg.d_model, reciprocal=True).to(compute_dtype)
    tables = _rope_tables(cfg, positions)
    for g in scan_groups(cfg):
        subs = [caches[g.name][f"sub{j}"] for j in range(len(g.unit))]
        paged = [block_tables is not None and g.paged[j] and "kv_pos" not in gc
                 for j, gc in enumerate(subs)]
        index = None
        if any(paged):  # every paged layer of the group writes the same pool slot
            gc = subs[paged.index(True)]
            leaf = next(gc[n] for n in gc if n in PAGED_CACHE_LEAVES)
            index = paged_token_index(block_tables, positions[:, 0],
                                      leaf.shape[2 if g.stacked else 1])
        for i, li0, p_u in _group_layers(params[g.name], g):
            for j, kind in enumerate(g.unit):
                li = li0 + j
                c_l = _unit_cache(subs[j], g, i)
                # the cross-kv is read, never written: kept out of the gating
                enc_kv = None
                if "cross_k" in c_l:
                    enc_kv = tuple(c_l.pop(n) for n in CROSS_CACHE_LEAVES)
                c_in = c_l
                if not paged[j] and active is not None and kind in _PAGED_KINDS:
                    c_in = {n: t.clone() for n, t in c_l.items()}
                x, new = block_decode(p_u[f"sub{j}"], x, c_in, pos, cfg=cfg, kind=kind,
                                      window=wins[li], rope_base=bases[li],
                                      compute_dtype=compute_dtype, enc_kv=enc_kv,
                                      block_tables=block_tables if paged[j] else None,
                                      rope_table=tables.get(bases[li]),
                                      cache_index=index if paged[j] else None,
                                      dropless_moe=active is not None)
                if not paged[j]:
                    _write_back(c_l, new, active)
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
        for i, li, p_l in _group_layers(params[g.name], g):
            c_l = _unit_cache(gc, g, i)
            x, _ = block_prefill_paged(p_l["sub0"], x, c_l, bt_row, positions, cfg=cfg,
                                       seq_len=seq_len, window=wins[li], rope_base=bases[li],
                                       compute_dtype=compute_dtype,
                                       rope_table=tables.get(bases[li]))
    logits, _ = _head(params, cfg, x[:, seq_len - 1: seq_len])
    return logits, caches


def decode_verify_lm(params, caches, tokens, pos, cfg: ModelConfig, *, block_tables,
                     compute_dtype=torch.bfloat16, active: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None):
    """Speculative verify: score T = k + 1 tokens a row in one pass over the
    paged pool.

    ``tokens`` (B, T) is [last committed token, drafts d_1..d_k] per row and
    ``pos`` (B,) each row's next write position, so token (b, t) lives at
    ``pos[b] + t``.  Every layer writes the T entries into the pool before
    it attends, so the logits (B, T, V) are what T sequential ``decode_lm``
    steps give: logits[:, t] scores the token after tokens[:, t].  A
    rejection rolls back by position bookkeeping alone.  ``valid`` (B, T)
    sends writes past ``max_len`` (and inactive rows') to the trash block;
    logits there are garbage the caller ignores.  Layer i addresses its
    slice of the stacked pool, as ``prefill_prefix_lm`` does; the pool is
    updated in place.

    Only the fully-paged tier: all-attention or MLA decoders.  MoE capacity
    competition couples the k + 1 tokens, so MoE raises, as in JAX."""
    if cfg.family != "decoder" or cfg.moe:
        raise NotImplementedError(
            "speculative verify supports only fully-paged attention/MLA decoders "
            f"(got family={cfg.family!r}, moe={cfg.moe})"
        )
    B, T = tokens.shape
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    pos = pos.to(torch.int32)
    positions = pos[:, None] + torch.arange(T, dtype=torch.int32, device=x.device)[None]
    if valid is None:
        valid = torch.ones((B, T), dtype=torch.bool, device=x.device)
    if active is not None:
        valid = valid & active[:, None]
        x = x * active.to(x.dtype).reshape(B, 1, 1)
    wins, bases = cfg.layer_windows(), cfg.layer_rope_bases()
    tables = _rope_tables(cfg, positions)
    for g in scan_groups(cfg):
        gc = caches[g.name]["sub0"]
        # every layer of the group writes the same pool slots
        first = next(gc[n] for n in gc if n in PAGED_CACHE_LEAVES)
        index = verify_token_index(block_tables, positions, first.shape[2 if g.stacked else 1],
                                   valid)
        for i, li, p_l in _group_layers(params[g.name], g):
            c_l = _unit_cache(gc, g, i)
            x, _ = block_verify_paged(p_l["sub0"], x, c_l, block_tables, positions, cfg=cfg,
                                      valid=valid, window=wins[li], rope_base=bases[li],
                                      compute_dtype=compute_dtype,
                                      rope_table=tables.get(bases[li]), cache_index=index)
    logits, _ = _head(params, cfg, x)
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


def _mtp_loss(params, cfg: ModelConfig, hidden, tokens, compute_dtype):
    """DeepSeek-V3 multi-token prediction (JAX ``_mtp_loss``): one extra
    block, fed the final hidden state at i and the embedding of token i+1,
    predicts token i+2 through the shared head.  Its MoE losses are not
    added, as in JAX."""
    mtp = params["mtp"]
    B, T = tokens.shape
    h = _norm_apply(cfg, mtp["norm_h"], hidden[:, : T - 1])
    e = _embed_tokens(params, cfg, tokens[:, 1:], compute_dtype)
    e = _norm_apply(cfg, mtp["norm_e"], e)
    x = torch.cat([h, e], dim=-1).to(compute_dtype)
    # no compute dtype for the projection: JAX's dot promotes bf16 x fp32 to fp32
    x = dense_apply(mtp["proj"], x.to(torch.promote_types(x.dtype, mtp["proj"]["kernel"].dtype)))
    pos = torch.arange(T - 1, dtype=torch.int32, device=x.device)[None].expand(B, T - 1)
    x, _, _ = block_apply(mtp["block"], x, cfg=cfg, kind="E" if cfg.moe else "A", positions=pos,
                          window=None, rope_base=cfg.rope_base, compute_dtype=compute_dtype)
    hN = _norm_apply(cfg, mtp["final_norm"], x)
    if cfg.tie_lm_head:
        logits = embed_logits(params["embed"], hN)
    else:
        logits = dense_apply(params["lm_head"], hN.to(torch.float32))
    # logits[:, i] (built from token i+1 and h_i) predicts token i+2
    return cross_entropy(logits[:, : T - 2], tokens[:, 2:])


def lm_train_loss(params, batch, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                  moe_aux_coef: float = 0.01, moe_z_coef: float = 1e-3):
    """(loss, metrics) of any LM, JAX's ``lm_train_loss``: next-token
    cross entropy, plus on an MoE config the layers' summed load-balancing
    and z losses (``moe_aux_coef``, ``moe_z_coef``), plus ``mtp_weight`` x the
    MTP cross entropy when ``cfg.use_mtp``.  Metric keys: ``ce``,
    ``moe_aux_loss`` and ``moe_z_loss`` (MoE), ``mtp_ce`` (MTP), ``loss``.
    Every family trains: whisper (``encdec``) reads the batch's ``frames``
    and paligemma (``vlm``) its ``patches``, as ``forward_lm`` does; the
    cross entropy is over the text positions (the image prefix is dropped
    before the head)."""
    out = forward_lm(params, batch, cfg, compute_dtype=compute_dtype, with_aux=cfg.moe)
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    ce = cross_entropy(out.logits[:, :-1], tokens[:, 1:], None if mask is None else mask[:, 1:])
    loss = ce
    metrics = {"ce": ce}
    if cfg.moe:
        loss = loss + moe_aux_coef * out.aux["moe_aux_loss"] + moe_z_coef * out.aux["moe_z_loss"]
        metrics.update(out.aux)
    if cfg.use_mtp:
        mtp = _mtp_loss(params, cfg, out.hidden, tokens, compute_dtype)
        loss = loss + cfg.mtp_weight * mtp
        metrics["mtp_ce"] = mtp
    metrics["loss"] = loss
    return loss, metrics


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
