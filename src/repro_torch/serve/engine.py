"""Batched serving over the port's decoder LM (mirrors
``repro/serve/engine.py``).

The engine serves float, ``quantize_tree`` and ``pack_tree`` params through
the same forward code, for dense GQA decoders (internlm2) and MoE decoders
(olmoe; deepseek-v3 with MLA attention).  Packed leaves stay packed on the
device: every packed dense layer runs the CUDA ``fixedpoint_matmul`` kernel,
every packed expert stack its experts form, and paged decode runs the CUDA
``paged_attention`` kernel, or ``paged_attention_mla`` for MLA (float pools,
or SYMOG-quantized int8/int4 pools with ``kv_cache_dtype``
``int8_fp``/``int4_fp``, MoE decoders only so far).  On the CPU these
resolve to their plain versions (dequantize-then-matmul, gather+softmax),
which are exact for packed weights, so CPU token streams equal
``quantize_tree``'s.

Both backends are pinned at construction (``kernels.dispatch``) and the
globals are restored around every call, as in the JAX package.  Caches and
the KV pool are updated in place (the JAX package donates them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.attention import (
    KV_QMAX,
    block_scale_exp,
    cache_read,
    pack_int4,
    quantize_fixed,
    word_bits,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (
    PAGED_CACHE_LEAVES,
    DecoderLM,
    decode_lm,
    init_caches,
    prefill_lm,
    scan_groups,
)
from repro_torch.models.quantized import tree_has_packed
from repro_torch.nn.tree import tree_bytes, tree_to


def _as_blocks(src, axis: int, p_blocks: int, block: int):
    """A batch-of-one prefill leaf (batch axis at ``axis``, a max_len axis
    after it) cut to the bucket's ``p_blocks`` blocks of ``block`` tokens."""
    src = src.squeeze(axis)
    need = p_blocks * block
    t = src.shape[axis]
    if need > t:
        pad = [0, 0] * (src.ndim - axis - 1) + [0, need - t]
        src = torch.nn.functional.pad(src, pad)
    elif need < t:
        src = src.narrow(axis, 0, need)
    return src.reshape(src.shape[:axis] + (p_blocks, block) + src.shape[axis + 1:])


def _scatter_blocks(pool, src, bt_row, axis: int, p_blocks: int):
    """Write a batch-of-one prefill cache into the paged pool, in place.

    pool (n_blocks, block, feat...) — one more leading layer axis when
    ``axis`` is 1 (stacked group).  Only the bucket's first ``p_blocks``
    table entries are written; entries past the allocated prefix are 0, so
    the padded tail lands in the trash block."""
    src = _as_blocks(src, axis, p_blocks, pool.shape[axis + 1])
    ids = bt_row[:p_blocks].to(torch.int64)
    if axis == 0:
        pool[ids] = src.to(pool.dtype)
    else:
        pool[:, ids] = src.to(pool.dtype)
    return pool


def _scatter_blocks_quant(pool, exp_leaf, src, bt_row, axis: int, p_blocks: int):
    """Quantizing variant of ``_scatter_blocks`` for per-block SYMOG pools,
    in place: dequantize the prefill leaf (float, or KV_F int8), calibrate
    each written block's exponent from its FIRST token, quantize every
    token under its block's scale, and scatter the int8 / packed-int4
    mantissas plus the exponent rows."""
    src = _as_blocks(cache_read(src, torch.float32), axis, p_blocks, pool.shape[axis + 1])
    bits = word_bits(pool, src.shape[-1])
    qmax = KV_QMAX[bits]
    e = block_scale_exp(src.select(axis + 1, 0), qmax)
    q = quantize_fixed(src, e.unsqueeze(axis + 1), qmax)
    if bits == 4:
        q = pack_int4(q)
    ids = bt_row[:p_blocks].to(torch.int64)
    if axis == 0:
        pool[ids] = q
        exp_leaf[ids] = e
    else:
        pool[:, ids] = q
        exp_leaf[:, ids] = e
    return pool, exp_leaf


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


class SchedulerFns:
    """The continuous-batching steps of one engine (greedy decoding).

    ``decode_step`` is the shared ragged decode dispatch over the slot
    table; ``admit_step(bucket, block_size)`` returns the fused bucketed
    prefill + block scatter + first-token step for one power-of-two prompt
    bucket (memoized; ``admit_compiles`` counts distinct buckets built)."""

    def __init__(self, engine: "ServeEngine"):
        self._eng = engine
        self._groups = scan_groups(engine.cfg)
        self._admits: Dict[Any, Callable] = {}
        self.admit_compiles = 0

    def decode_step(self, params, caches, tokens, pos, active, block_tables):
        """tokens (S,) — the previous step's output fed back on the device;
        pos advances on the device for active rows only."""
        eng = self._eng
        logits, caches = decode_lm(params, caches, tokens[:, None], pos, eng.cfg,
                                   compute_dtype=eng.compute_dtype, active=active,
                                   block_tables=block_tables)
        return _greedy(logits[:, -1, :]), pos + active.to(torch.int32), caches

    def admit_step(self, bucket: int, block_size: int):
        key = (int(bucket), int(block_size))
        if key not in self._admits:
            self._admits[key] = self._build_admit(*key)
            self.admit_compiles += 1
        return self._admits[key]

    def _build_admit(self, bucket: int, block_size: int):
        eng, groups = self._eng, self._groups
        p_blocks = -(-bucket // block_size)

        def _admit(params, batch, length: int, caches, bt_row, slot: int):
            # bucketed prefill: tokens (1, bucket) right-padded, ``length``
            # the real prompt length; sample at the last REAL position and
            # write only the bucket's blocks (padded tail -> trash block)
            logits, one = prefill_lm(params, batch, eng.cfg, max_len=eng.max_len,
                                     compute_dtype=eng.compute_dtype, seq_len=length)
            for g in groups:
                axis = 1 if g.stacked else 0
                dst, src = caches[g.name]["sub0"], one[g.name]["sub0"]
                for name, leaf in src.items():
                    if g.paged[0] and name in PAGED_CACHE_LEAVES:
                        sname = name + "_scale"
                        if sname in dst:
                            _scatter_blocks_quant(dst[name], dst[sname], leaf, bt_row, axis,
                                                  p_blocks)
                        else:
                            _scatter_blocks(dst[name], leaf, bt_row, axis, p_blocks)
                    else:
                        dst[name].narrow(axis, slot, 1).copy_(leaf)
            return _greedy(logits[:, -1, :])[0], caches

        return _admit


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    params: Any
    max_len: int
    compute_dtype: Any = torch.bfloat16
    device: Any = None  # None: the card (raises without one); "cpu" on request

    def __post_init__(self):
        kv = self.cfg.kv_cache_dtype
        if kv not in ("bf16", "int8_fp", "int4_fp"):
            raise ValueError(f"kv_cache_dtype must be bf16, int8_fp or int4_fp, got {kv!r}")
        if kv != "bf16" and not self.cfg.moe:
            # the JAX package admits every request to a quantized pool of an
            # all-attention decoder through the tail-prefill trace, which the
            # port has not yet; MoE decoders admit through the bucketed
            # prefill plus a quantizing block scatter, which it has
            raise NotImplementedError(
                f"kv_cache_dtype {kv!r} on an all-attention decoder: its admission runs "
                "the tail-prefill trace, not ported yet (ROADMAP Queue 1 item 9); the port "
                "serves quantized KV pools for MoE decoders"
            )
        self.device = resolve_device(self.device)
        self.model = DecoderLM(self.cfg, tree_to(self.params, self.device))
        self.params = self.model.params
        self.packed = tree_has_packed(self.params)
        # pin both backends now; construct a new engine to switch
        self.backend = dispatch.resolve_packed_backend(self.device)
        self.attn_backend = dispatch.resolve_attention_backend(self.device)
        self._fns: Optional[SchedulerFns] = None

    @classmethod
    def from_symog(cls, cfg: ModelConfig, params, symog_state, symog_cfg, *, max_len: int,
                   compute_dtype=torch.bfloat16, device=None) -> "ServeEngine":
        """Pack a SYMOG-trained float tree and serve the Packed artifact."""
        from repro_torch.core.symog import pack_tree

        dev = resolve_device(device)
        tree = pack_tree(tree_to(params, dev), symog_state, symog_cfg)
        return cls(cfg, tree, max_len=max_len, compute_dtype=compute_dtype, device=dev)

    def _with_backend(self, fn, *args, **kw):
        prev_p, prev_a = dispatch.get_packed_backend(), dispatch.get_attention_backend()
        dispatch.set_packed_backend(self.backend)
        dispatch.set_attention_backend(self.attn_backend)
        try:
            with torch.no_grad():
                return fn(*args, **kw)
        finally:
            dispatch.set_packed_backend(prev_p)
            dispatch.set_attention_backend(prev_a)

    @property
    def kv_quant_bits(self) -> int:
        """Wordlength of the per-block SYMOG paged KV pool: 8 (int8_fp) or
        4 (int4_fp), 0 for a float pool."""
        return {"int8_fp": 8, "int4_fp": 4}.get(self.cfg.kv_cache_dtype, 0)

    def weight_bytes(self) -> int:
        """Resident param bytes (Packed leaves count their int8 words)."""
        return tree_bytes(self.params)

    def prefill_cache_specs(self):
        """Meta tensors shaped like one request's prefill caches — the
        scheduler derives the paged pool layout from them."""
        return init_caches(self.cfg, 1, self.max_len, self.compute_dtype, device="meta")

    def scheduler_fns(self) -> SchedulerFns:
        if self._fns is None:
            self._fns = SchedulerFns(self)
        return self._fns

    def _tokens(self, batch):
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                .to(self.device) for k, v in batch.items()}

    def prefill(self, batch: Dict[str, Any]):
        return self._with_backend(prefill_lm, self.params, self._tokens(batch), self.cfg,
                                  max_len=self.max_len, compute_dtype=self.compute_dtype)

    def decode(self, caches, tokens, pos):
        return self._with_backend(decode_lm, self.params, caches, tokens, pos, self.cfg,
                                  compute_dtype=self.compute_dtype)

    def serve(self, requests: Sequence[Any], config=None, *, return_scheduler: bool = False):
        """Continuous-batching serve of ``requests`` (scheduler.Request) under
        ``config`` (a ServeConfig).  Completions come in submission order."""
        from repro_torch.serve.scheduler import serve_requests

        comps, sched = serve_requests(self, requests, config)
        return (comps, sched) if return_scheduler else comps

    def generate(self, batch: Dict[str, Any], steps: int) -> torch.Tensor:
        """Greedy continuation of a batched prompt through ``serve`` (one
        request per row on B slots); returns (B, steps)."""
        from repro_torch.serve.config import ServeConfig
        from repro_torch.serve.scheduler import Request

        tokens = np.asarray(batch["tokens"].cpu() if isinstance(batch["tokens"], torch.Tensor)
                            else batch["tokens"])
        reqs = [Request(tokens=row, max_new_tokens=steps) for row in tokens]
        comps = self.serve(reqs, ServeConfig(n_slots=tokens.shape[0]))
        if any(len(c.tokens) != steps for c in comps):
            raise ValueError(f"max_len={self.max_len} too small for {steps} steps")
        return torch.as_tensor(np.stack([np.asarray(c.tokens, np.int32) for c in comps]))

    def generate_static(self, batch: Dict[str, Any], steps: int) -> torch.Tensor:
        """The static loop: one uniform-position batch with dense per-row
        caches, every row decoded for exactly ``steps`` tokens — the oracle
        the scheduler's token streams are held to."""
        batch = self._tokens(batch)
        T = batch["tokens"].shape[1]
        logits, caches = self.prefill(batch)
        cur = _greedy(logits[:, -1:])
        out = [cur]
        for i in range(steps - 1):
            logits, caches = self.decode(caches, cur, T + i)
            cur = _greedy(logits[:, -1:])
            out.append(cur)
        return torch.cat(out, dim=1).cpu()
