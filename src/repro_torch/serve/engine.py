"""Batched serving over the port's decoder LM (mirrors
``repro/serve/engine.py``).

The engine serves float, ``quantize_tree`` and ``pack_tree`` params through
the same forward code, for dense decoders (internlm2, gemma2, gemma3,
granite), MoE decoders (olmoe; deepseek-v3 with MLA attention), the
recurrent families (mamba2; recurrentgemma, whose local-attention layers
page while its RG-LRU states stay resident a slot), whisper (its decoder's
self-attention pages, its cross-kv stays resident a slot) and paligemma
(the image prefix pages ahead of the text).  A request of the last two
carries its frames or patches in ``Request.extras``.  Packed
leaves stay packed on the device: every packed dense layer runs the CUDA
``fixedpoint_matmul`` kernel, every packed expert stack its experts form,
and paged attention runs the CUDA ``paged_attention`` kernel (decode, and
the tail-prefill admission of all-attention decoders), or
``paged_attention_mla`` for MLA, over float pools or SYMOG-quantized
int8/int4 pools (``kv_cache_dtype`` ``int8_fp``/``int4_fp``).  On the CPU
these resolve to their plain versions (dequantize-then-matmul,
gather+softmax), which are exact for packed weights, so CPU token streams
equal ``quantize_tree``'s.

Decoding is greedy (``temperature <= 0``: argmax) or sampled: temperature
and top-k through ``filter_logits``, then a Gumbel-max draw whose uniforms
are a counter-based hash of (base seed, stream id, vocab index)
(``sample_uniform``), so a draw depends on no generator state, batch order
or slot count.

Both backends are pinned at construction (``kernels.dispatch``) and set
around every call on the calling thread (the dispatch backends are
thread-local, so engines stepping on other threads never see them), as in
the JAX package.  Caches and
the KV pool are updated in place (the JAX package donates them).

On a mesh (``mesh=``, or constructed under ``with mesh:``; pinned like the
backends) every rank runs the same engine and scheduler (SPMD): the host
bookkeeping (block tables, slot state, ``_scale`` exponents) is the same on
every rank, each rank holds its shard of the params and of the paged pool,
and the model code runs on the local config (``serve.sharding``): a
decoder's attention, MLP, embedding and head split over the ``model`` axis
where they divide, MoE layers expert-parallel under ``moe_impl='ep'``.  The
``data`` axis replicates.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, Dict, Sequence

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
from repro_torch.models.layers import set_tp
from repro_torch.models.lm import (
    PAGED_CACHE_LEAVES,
    DecoderLM,
    decode_lm,
    image_prefix_len,
    init_caches,
    prefill_lm,
    prefill_prefix_lm,
    scan_groups,
)
from repro_torch.models.quantized import tree_has_packed
from repro_torch.nn.sharding import current_mesh, make_rules, mesh_axis_size, shard_tree
from repro_torch.nn.tree import flatten_with_paths, is_packed, tree_bytes, tree_to


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


def filter_logits(logits: torch.Tensor, temperature, top_k: int) -> torch.Tensor:
    """The sampling distribution's logit transform: temperature scaling plus
    top-k masking to -inf.  ONE definition for every sampler (speculative
    rejection sampling must target exactly the distribution vanilla serve()
    draws from), as in the JAX package."""
    scaled = logits / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, -math.inf), scaled)
    return scaled


# splitmix64 (Steele, Lea, Flood 2014): its increment and multipliers as
# signed int64, the type torch's integer ops wrap in
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 words (products wrap mod 2^64)."""
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def sample_uniform(seed: int, streams: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) fp32 uniforms in (0, 1): entry (b, v) is a pure function of
    (``seed``, ``streams[b]``, v), a splitmix64 stream keyed by the row's
    stream id under the base seed.  Integer ops only up to the last
    conversion, so it is one function on every device, runs where
    ``streams`` lies and keeps no state: a row's draw cannot depend on the
    batch it rides in."""
    seed_key = int(_mix64(torch.tensor(seed, dtype=torch.int64)))  # on the host: no sync
    key = _mix64(streams.to(torch.int64) * _GOLDEN ^ seed_key)
    v = torch.arange(1, n + 1, dtype=torch.int64, device=streams.device)
    h = _mix64(key[:, None] + v[None, :] * _GOLDEN)
    # the top 23 bits k as (2k + 1)·2^-24: exact in fp32, never 0 or 1
    return (_srl(h, 41) * 2 + 1).to(torch.float32) * 2.0**-24


def sample_tokens(logits: torch.Tensor, streams: torch.Tensor, seed: int, temperature,
                  top_k: int) -> torch.Tensor:
    """One token per row of ``logits`` (B, V) from softmax(filter_logits):
    the Gumbel-max draw argmax(filtered + g), g = -log(-log(u)) with u from
    ``sample_uniform(seed, streams, V)``; masked entries stay -inf."""
    scaled = filter_logits(logits.to(torch.float32), temperature, top_k)
    u = sample_uniform(seed, streams, scaled.shape[-1])
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


class SchedulerFns:
    """The continuous-batching steps of one engine for one (greedy, top_k)
    sampling config (owned by the engine's ``scheduler_fns`` memo).

    ``decode_step`` is the shared ragged decode dispatch over the slot
    table; ``admit_step(bucket, block_size)`` returns the fused bucketed
    prefill + block scatter + first-token step for one power-of-two prompt
    bucket, ``admit_prefix_step(bucket, block_size)`` the tail-prefill
    admission (``prefill_prefix_lm``: the tail's k/v written into the pool
    layer by layer, attention over the pool itself) for one tail bucket.
    Both are memoized; ``admit_compiles`` counts the distinct steps built,
    ``prefix_compiles`` the tail-prefill ones among them.  The port has no
    jit cache: ``decode_cache_size()`` counts the distinct argument
    signatures (slot count, table width, pool shapes) the decode step has
    run with, the entries JAX's jit cache of the decode step would hold.

    ``cow_copy(caches, src, dst)`` clones one physical pool row for the
    prefix cache's copy-on-write.

    Every step samples through ``_sample``: argmax when greedy, else
    ``sample_tokens`` on stream ids keyed by (request, step), so slot
    placement, arrival order and preemption replay cannot change a draw."""

    def __init__(self, engine: "ServeEngine", *, greedy: bool, top_k: int):
        self._eng = engine
        self._groups = scan_groups(engine.cfg)
        self._greedy = bool(greedy)
        self._top_k = int(top_k)
        self._admits: Dict[Any, Callable] = {}
        self._admits_prefix: Dict[Any, Callable] = {}
        self.admit_compiles = 0
        self.prefix_compiles = 0
        self._decode_sigs: set = set()

    def decode_cache_size(self) -> int:
        """Distinct decode-step signatures run so far (the scheduler's
        ``decode_trace_compiles`` reads the change over a serve)."""
        return len(self._decode_sigs)

    def _sample(self, logits, streams, seed: int, temperature):
        """logits (B, V); ``streams()`` gives the (B,) stream ids, made only
        for a sampled draw (greedy steps launch nothing for them)."""
        if self._greedy:
            return _greedy(logits)
        return sample_tokens(logits, streams(), seed, temperature, self._top_k)

    def decode_step(self, params, caches, tokens, pos, active, seed0, block_tables, seed,
                    temperature):
        """tokens (S,) — the previous step's output fed back on the device;
        pos advances on the device for active rows only, and each row's
        stream id is ``seed0 + pos`` (seed0 written at activation), so the
        host uploads nothing per step."""
        eng = self._eng
        self._decode_sigs.add((tuple(tokens.shape), tuple(block_tables.shape), tuple(
            (name, tuple(leaf.shape)) for g in caches.values() for sub in g.values()
            for name, leaf in sub.items())))
        logits, caches = decode_lm(params, caches, tokens[:, None], pos, eng.cfg,
                                   compute_dtype=eng.compute_dtype, active=active,
                                   block_tables=block_tables)
        nxt = self._sample(logits[:, -1, :], lambda: seed0.to(torch.int64) + pos.to(torch.int64),
                           seed, temperature)
        return nxt, pos + active.to(torch.int32), caches

    def admit_step(self, bucket: int, block_size: int):
        key = (int(bucket), int(block_size))
        if key not in self._admits:
            self._admits[key] = self._build_admit(*key)
            self.admit_compiles += 1
        return self._admits[key]

    def admit_prefix_step(self, bucket: int, block_size: int):
        """The tail-prefill admission for one (tail bucket, block size)."""
        key = (int(bucket), int(block_size))
        if key not in self._admits_prefix:
            self._admits_prefix[key] = self._build_admit_prefix(*key)
            self.admit_compiles += 1
            self.prefix_compiles += 1
        return self._admits_prefix[key]

    def cow_copy(self, caches, src: int, dst: int):
        """Copy-on-write block clone, in place: physical pool row ``src``
        copied to ``dst`` in every paged leaf and its ``_scale`` exponent
        sibling, at every layer (axis 1 of a stacked group).  The prefix
        cache calls it when a hit ends inside a cached block: the request
        appends into its private copy while the source keeps serving the
        cache.  A quantized block keeps the source's exponent, set once at
        the block's first write.  Row 0 is the trash block and is never a
        target."""
        if dst == 0 or src == 0:
            raise ValueError(f"copy-on-write touches the trash block: src {src}, dst {dst}")
        for g in self._groups:
            for j, paged in enumerate(g.paged):
                if not paged:
                    continue
                for name, leaf in caches[g.name][f"sub{j}"].items():
                    if name.removesuffix("_scale") in PAGED_CACHE_LEAVES:
                        leaf.select(1 if g.stacked else 0, dst).copy_(
                            leaf.select(1 if g.stacked else 0, src))
        return caches

    def _first_token(self, logits, stream: int, seed: int, temperature):
        return self._sample(logits[:, -1, :], lambda: torch.full(
            (1,), stream, dtype=torch.int64, device=logits.device), seed, temperature)[0]

    def _build_admit_prefix(self, bucket: int, block_size: int):
        eng = self._eng

        def _admit(params, batch, length: int, start: int, caches, bt_row, stream: int,
                   seed: int, temperature):
            # tokens (1, bucket): the right-padded uncached tail, ``length``
            # real tokens after ``start`` cached ones; the tail's KV lands
            # in the pool inside the prefill, so no block scatter follows
            logits, caches = prefill_prefix_lm(params, batch, caches, bt_row, start, eng.cfg,
                                               seq_len=length, compute_dtype=eng.compute_dtype)
            return self._first_token(logits, stream, seed, temperature), caches

        return _admit

    def _build_admit(self, bucket: int, block_size: int):
        eng, groups = self._eng, self._groups
        p_blocks = -(-(image_prefix_len(eng.cfg) + bucket) // block_size)

        def _admit(params, batch, length: int, caches, bt_row, slot: int, stream: int,
                   seed: int, temperature):
            # bucketed prefill: tokens (1, bucket) right-padded, ``length``
            # the real prompt length; sample at the last REAL position and
            # write only the blocks of the prefix and the bucket (padded tail
            # -> trash block).  Resident leaves (recurrent / SSD state, conv
            # windows, whisper's cross-kv) are copied whole into the slot's row
            logits, one = prefill_lm(params, batch, eng.cfg, max_len=eng.max_len,
                                     compute_dtype=eng.compute_dtype, seq_len=length)
            for g in groups:
                axis = 1 if g.stacked else 0
                for j, paged in enumerate(g.paged):
                    dst, src = caches[g.name][f"sub{j}"], one[g.name][f"sub{j}"]
                    for name, leaf in src.items():
                        if paged and name in PAGED_CACHE_LEAVES:
                            sname = name + "_scale"
                            if sname in dst:
                                _scatter_blocks_quant(dst[name], dst[sname], leaf, bt_row, axis,
                                                      p_blocks)
                            else:
                                _scatter_blocks(dst[name], leaf, bt_row, axis, p_blocks)
                        else:
                            dst[name].narrow(axis, slot, 1).copy_(leaf)
            return self._first_token(logits, stream, seed, temperature), caches

        return _admit


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    params: Any
    max_len: int
    compute_dtype: Any = torch.bfloat16
    device: Any = None  # None: the card (raises without one); "cpu" on request
    # a nn.sharding.Mesh: None (and a 1-rank mesh) serves exactly as before
    mesh: Any = None
    sharding_profile: str = ""  # defaults to cfg.sharding_profile

    def __post_init__(self):
        kv = self.cfg.kv_cache_dtype
        if kv not in ("bf16", "int8_fp", "int4_fp"):
            raise ValueError(f"kv_cache_dtype must be bf16, int8_fp or int4_fp, got {kv!r}")
        self.device = resolve_device(self.device)
        if self.mesh is None:
            self.mesh = current_mesh()  # constructing under `with mesh:` pins it
        self.global_cfg = self.cfg
        self.rules = self.tp = None
        if self.mesh is not None:
            from repro_torch.serve.sharding import local_config, make_tp_plan, serve_spec_fn

            self.rules = make_rules(self.mesh, self.sharding_profile or self.cfg.sharding_profile)
            self.tp = make_tp_plan(self.cfg, self.params, self.mesh, self.rules)
            self.params = shard_tree(self.rules, self.mesh, self.params,
                                     serve_spec_fn(self.cfg, self.tp))
            self.cfg = local_config(self.cfg, self.tp)
        self.model = DecoderLM(self.cfg, tree_to(self.params, self.device))
        self.params = self.model.params
        self.packed = tree_has_packed(self.params)
        # pin both backends now; construct a new engine to switch
        self.backend = dispatch.resolve_packed_backend(self.device)
        self.attn_backend = dispatch.resolve_attention_backend(self.device)
        self._sched_fns: Dict[Any, Any] = {}
        self._fingerprint = None

    @classmethod
    def from_symog(cls, cfg: ModelConfig, params, symog_state, symog_cfg, *, max_len: int,
                   compute_dtype=torch.bfloat16, device=None, mesh=None,
                   sharding_profile: str = "") -> "ServeEngine":
        """Pack a SYMOG-trained float tree and serve the Packed artifact."""
        from repro_torch.core.symog import pack_tree

        dev = resolve_device(device)
        tree = pack_tree(tree_to(params, dev), symog_state, symog_cfg)
        return cls(cfg, tree, max_len=max_len, compute_dtype=compute_dtype, device=dev,
                   mesh=mesh, sharding_profile=sharding_profile)

    def _with_backend(self, fn, *args, **kw):
        prev_p, prev_a = dispatch.get_packed_backend(), dispatch.get_attention_backend()
        dispatch.set_packed_backend(self.backend)
        dispatch.set_attention_backend(self.attn_backend)
        prev_tp = set_tp(self.tp)
        try:
            with torch.no_grad():
                if self.mesh is None:
                    return fn(*args, **kw)
                # the mesh is part of the pinned environment: MoE layers
                # read it to route expert-parallel
                with self.mesh:
                    return fn(*args, **kw)
        finally:
            set_tp(prev_tp)
            dispatch.set_packed_backend(prev_p)
            dispatch.set_attention_backend(prev_a)

    def model_shards(self) -> int:
        """Size of the mesh's ``model`` axis (1 off a mesh): the tensor / KV
        head / expert parallel degree the pool's byte count is over."""
        return mesh_axis_size(self.mesh, "model")

    @property
    def kv_quant_bits(self) -> int:
        """Wordlength of the per-block SYMOG paged KV pool: 8 (int8_fp) or
        4 (int4_fp) for a decoder-family engine, 0 for a float pool and for
        every other family.  Those keep the JAX package's rule: their
        attention caches are KV_F int8 (one global Δ = 2^-5) under int8_fp,
        scattered into the pool as they are, and in the compute dtype under
        int4_fp."""
        if self.cfg.family != "decoder":
            return 0
        return {"int8_fp": 8, "int4_fp": 4}.get(self.cfg.kv_cache_dtype, 0)

    def weight_bytes(self) -> int:
        """Resident param bytes (Packed leaves count their int8 words)."""
        return tree_bytes(self.params)

    def prefill_cache_specs(self):
        """Meta tensors shaped and typed like one request's prefill caches:
        the scheduler derives the paged pool and resident slot-row layouts
        from them."""
        return init_caches(self.cfg, 1, self.max_len, self.compute_dtype, device="meta",
                           prefill=True)

    def scheduler_fns(self, *, greedy: bool, top_k: int) -> SchedulerFns:
        """Memoized SchedulerFns per (greedy, top_k), the sampling knobs
        that change a step (top_k is moot when greedy); temperature and the
        base seed are arguments."""
        top_k = 0 if greedy else int(top_k)
        key = (bool(greedy), top_k)
        if key not in self._sched_fns:
            self._sched_fns[key] = SchedulerFns(self, greedy=greedy, top_k=top_k)
        return self._sched_fns[key]

    def speculative_fns(self, *, greedy: bool, top_k: int):
        """Memoized draft / verify steps (``serve.speculative.SpeculativeFns``)
        per (greedy, top_k), as ``scheduler_fns``: they use this TARGET
        engine's config only, and the draft's params ride in as arguments."""
        from repro_torch.serve.speculative import SpeculativeFns

        top_k = 0 if greedy else int(top_k)
        key = ("spec", bool(greedy), top_k)
        if key not in self._sched_fns:
            self._sched_fns[key] = SpeculativeFns(self, greedy=greedy, top_k=top_k)
        return self._sched_fns[key]

    def params_fingerprint(self) -> str:
        """Within-process identity of the served artifact, namespacing the
        prefix cache: ``quantize_tree`` and ``pack_tree`` params give other
        KV bytes from the same tokens, so their blocks must never
        cross-share.  Hashes the tree structure (paths, which leaves are
        ``Packed``), each leaf's shape and dtype, and the tree's object
        identity: conservative, as in the JAX package (two equal trees
        fingerprint apart; a false split costs hits, a false merge would
        corrupt streams)."""
        if self._fingerprint is None:
            import hashlib

            h = hashlib.sha1()
            h.update(f"packed={self.packed} id={id(self.params)}".encode())
            for path, leaf in flatten_with_paths(self.params):
                if is_packed(leaf):
                    desc = f"P{leaf.n_bits}{tuple(leaf.data.shape)}/{leaf.data.dtype}"
                else:
                    desc = f"{tuple(getattr(leaf, 'shape', ()))}/{getattr(leaf, 'dtype', '')}"
                h.update(f"{path}:{desc};".encode())
            self._fingerprint = h.hexdigest()[:16]
        return self._fingerprint

    def capabilities(self):
        """The port's structural serving capabilities, with reasons
        (``serve.config.capabilities``)."""
        from repro_torch.serve.config import capabilities

        return capabilities(self)

    def _tokens(self, batch):
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                .to(self.device) for k, v in batch.items()}

    def prefill(self, batch: Dict[str, Any]):
        return self._with_backend(prefill_lm, self.params, self._tokens(batch), self.cfg,
                                  max_len=self.max_len, compute_dtype=self.compute_dtype)

    def decode(self, caches, tokens, pos):
        return self._with_backend(decode_lm, self.params, caches, tokens, pos, self.cfg,
                                  compute_dtype=self.compute_dtype)

    def serve(self, requests: Sequence[Any], config=None, *, return_scheduler: bool = False,
              **legacy):
        """Continuous-batching serve of ``requests`` (scheduler.Request) under
        ``config`` (a ServeConfig; ``config.speculative`` runs the draft /
        verify scheduler).  Completions come in submission order.

        The keyword form ``serve(reqs, n_slots=..., ...)`` still works but
        warns with a ``DeprecationWarning``, as in the JAX package."""
        from repro_torch.serve.config import ServeConfig
        from repro_torch.serve.scheduler import serve_requests

        if legacy:
            if config is not None:
                raise TypeError("pass either a ServeConfig or legacy keyword args, not both")
            warnings.warn(
                "serve(requests, n_slots=..., ...) is deprecated; pass "
                "serve(requests, serve.ServeConfig(...))",
                DeprecationWarning,
                stacklevel=2,
            )
            config = ServeConfig(**legacy)
        comps, sched = serve_requests(self, requests, config)
        return (comps, sched) if return_scheduler else comps

    def serve_async(self, config=None):
        """An ``AsyncServeEngine`` over this engine: submit, stream and
        cancel from asyncio coroutines while a drive loop steps the
        scheduler in a worker thread.  Use as an async context manager."""
        from repro_torch.serve.async_engine import AsyncServeEngine

        return AsyncServeEngine(self, config)

    def generate(self, batch: Dict[str, Any], steps: int) -> torch.Tensor:
        """Greedy continuation of a batched prompt through ``serve`` (one
        request per row on B slots, each with its row of the batch's extras);
        returns (B, steps)."""
        from repro_torch.serve.config import ServeConfig
        from repro_torch.serve.scheduler import Request

        def host(v):
            return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)

        tokens = host(batch["tokens"])
        extras = {k: host(v) for k, v in batch.items() if k != "tokens"}
        reqs = [Request(tokens=row, max_new_tokens=steps,
                        extras={k: v[b: b + 1] for k, v in extras.items()} or None)
                for b, row in enumerate(tokens)]
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
        offset = image_prefix_len(self.cfg)
        logits, caches = self.prefill(batch)
        cur = _greedy(logits[:, -1:])
        out = [cur]
        for i in range(steps - 1):
            logits, caches = self.decode(caches, cur, offset + T + i)
            cur = _greedy(logits[:, -1:])
            out.append(cur)
        return torch.cat(out, dim=1).cpu()


def greedy_generate(cfg: ModelConfig, params, batch, steps: int, max_len: int,
                    compute_dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Greedy continuation of a batched prompt (``ServeEngine.generate``)."""
    return ServeEngine(cfg, params, max_len, compute_dtype, device).generate(batch, steps)
