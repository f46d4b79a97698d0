"""Continuous-batching request scheduler over ``ServeEngine`` with a paged
KV-cache block pool (mirrors the core of ``repro/serve/scheduler.py``).

  * a request queue with optional arrival times (decode-step units);
    admission takes the first due request of the highest
    ``Request.priority`` (FIFO among equal priorities; a not-yet-due head
    never blocks due requests behind it);
  * a slot table of ``n_slots`` rows sharing one decode dispatch; each row
    has its own position, so the batch is ragged;
  * a block pool: k/v live in shared ``(n_blocks+1, block, K, hd)`` pools
    (MLA's c_kv / k_rope in ``(n_blocks+1, block, r)`` / ``(..., rope)``
    pools; one more leading layer axis per stacked group); row b resolves
    position t through a device ``(S, max_blocks)`` block table.  Physical
    row 0 is the trash block: zeroed table rows (free slots) write there;
  * admission: prompts are right-padded to power-of-two buckets and one
    fused prefill + block scatter + first-token step runs per request.
    On a quantized pool of the fully-paged tier (all-attention decoders)
    the admission is the tail-prefill step with start 0 instead: each
    layer writes the prompt's k/v into the pool and attends the pool
    itself, as the JAX package's scheduler does;
  * growth (``_grow_tables``) allocates a row's next block as its position
    crosses a boundary; pool exhaustion preempts the lowest-priority live
    request (the youngest among ties), which restarts from scratch — greedy
    decoding is deterministic and sampled streams are keyed by (request
    index, step), so the replay is token-exact;
  * eviction on eos or length returns the blocks and zeroes the table row;
  * cancellation (``cancel(idx)``): a queued request is dropped; a live
    one is torn down at once — its blocks return to the pool through the
    same ``_release`` as eviction, its zeroed table row sends any write to
    the trash block, and its partial output becomes a
    ``finish_reason='cancelled'`` Completion.  Surviving rows are untouched;
  * streaming: per-token callbacks (``ServeConfig.on_token``, or per
    request through ``submit``) fire as tokens are committed, in stream
    order; a preempted request's replay is deduplicated against what was
    already streamed (replays are token-exact, so the count suffices);
  * prefix cache (``prefix_cache=True``, fully-paged tier only): admission
    matches the prompt against a radix index of cached prompt blocks
    (``serve/prefixcache.py``), pins the matched blocks into the new table,
    copies a partially matched boundary block on write (``cow_copy``) and
    prefills only the uncached tail with the tail-prefill step from the
    matched offset.  Cached-but-idle blocks are reclaimed (LRU, inside
    ``BlockPool.alloc``) before any live request is preempted;
  * chunked prefill (``prefill_chunk`` > 0, fully-paged tier only): a
    prompt tail longer than the chunk is prefilled one tail-prefill chunk
    per step, beside the live decode, from ``start`` = the tokens done.  A
    prefilling slot holds its blocks but keeps its DEVICE table row zeroed
    until its final chunk (the shared decode step writes through any
    populated row); each chunk addresses the pool through a host-built
    row.  The final chunk samples the first token with the (request, 0)
    stream a one-shot admission uses, so streams do not change.

With ``kv_cache_dtype`` int8_fp/int4_fp the pools hold
SYMOG-quantized int8 / packed-int4 mantissas with one int32 exponent per
(physical block, KV head) in a ``<name>_scale`` sibling leaf (per physical
block for MLA's head-less c_kv / k_rope).

Telemetry: every scheduler owns a ``MetricsRegistry`` (``stats`` is a
view over its ``serve_*`` counters; latency histograms and occupancy
gauges beside them, with the JAX package's names), a span tracer when
``telemetry.trace`` is on, a step-time monitor, an ``events`` log and a
per-request ``Completion.timeline``.  The registry reads host numbers only
and adds no device sync.  The ``decode`` span closes over the step's one
host sync; the ``admit`` and ``chunk`` spans close without one (unless
``time_admissions``), so on the card they measure host dispatch.

Slot state (tokens, positions, stream offsets, active flags, block tables)
lives on the device; the host downloads only the sampled tokens, once per
step (and an admission's first token).
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.fault import StepTimeMonitor
from repro_torch.models.lm import PAGED_CACHE_LEAVES, scan_groups
from repro_torch.obs import (NULL_TRACER, MetricsRegistry, RingLog, StatsView, StepTracer,
                              log_buckets)
from repro_torch.obs.profiling import make_profile_window
from repro_torch.serve.blockpool import BlockPool
from repro_torch.serve.config import ServeConfig, _tier_reasons
from repro_torch.serve.prefixcache import PrefixCache


@dataclasses.dataclass
class Request:
    """One generation request.  ``tokens`` is the (T,) prompt."""

    tokens: Any
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never emitted
    arrival: int = 0  # earliest decode step at which admission may happen
    priority: int = 0  # higher admits first among due requests; preempted last


@dataclasses.dataclass
class Completion:
    index: int  # submission order
    tokens: List[int]  # generated ids (incl. the eos token if emitted)
    prompt_len: int
    finish_reason: str  # 'eos' | 'length' | 'cancelled'
    slot: int
    arrival: int
    admitted_step: int  # last admission (preempted requests restart)
    finished_step: int
    first_token_step: int = -1  # == admitted_step one-shot; a chunked prompt's final chunk
    spec_steps: int = 0  # speculative draft / verify rounds this request rode
    spec_tokens: int = 0  # tokens those rounds committed (accepted + bonus)
    # lifecycle timeline: ordered (event, step) records — submit / admit /
    # chunk / token / preempt / finish / cancel.  'token' entries mark
    # delivery: a preemption replay delivers nothing again, so their count
    # is exactly len(tokens)
    timeline: List[Tuple[str, int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Slot:
    index: int
    eos_id: int
    budget: int
    prompt: np.ndarray
    req: Request
    out: List[int]
    admitted_step: int
    pos: int  # host mirror of the device position (next cache write)
    blocks: List[int]  # logical block ids, in table order
    first_token_step: int = -1
    # chunked prefill: while ``prefilling`` the device table row stays
    # zeroed and chunks address the pool through the host-built ``row``
    prefilling: bool = False
    done: int = 0  # prompt tokens whose KV is resident (the next chunk's start)
    row: Optional[np.ndarray] = None  # host physical-id table row
    admit_wall: float = 0.0  # summed chunk wall time (time_admissions)
    hit: int = 0  # prefix-cache matched tokens at admission

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


def fully_paged_tier(engine) -> bool:
    """True iff EVERY cache leaf of every group pages into the block pool:
    all-attention decoders (no MoE capacity coupling, no MLA).  The
    precondition of the tail-prefill admission; ``engine.capabilities()``
    gives the reasons when it fails."""
    return not _tier_reasons(engine)


def prefix_cache_eligible(engine) -> bool:
    """Would ``prefix_cache=True`` share on this engine?  The flag is
    accepted everywhere but inert off the fully-paged tier
    (``engine.capabilities()`` says why)."""
    return bool(engine.capabilities()["prefix_cache"])


def _sample_seed(req_index: int, step: int) -> int:
    """Stream id of the ``step``-th token of request ``req_index``: keyed by
    request identity, not slot, so placement and preemption restarts cannot
    change a draw.  Decode recomputes it on the device as ``seed0 + pos``
    (seed0 written at activation), so it stays affine in ``step``.  The
    index wraps at 2048 to stay inside int32, as in the JAX package."""
    return (req_index % 2048) * 1_000_003 + step


def latency_stats(completions: Sequence[Completion]) -> Dict[str, Dict[str, float]]:
    """Per-request latency percentiles in decode-step units, cancelled
    requests left out: queue_steps (admitted - arrival), ttft_steps (first
    token - arrival + 1: a chunked prompt's first token comes at its final
    chunk), tokens_per_step (tokens over the steps the slot was occupied)
    and, for speculative serves, accepted_per_step (tokens committed per
    draft / verify round; vanilla decode is 1)."""
    completions = [c for c in completions if c.finish_reason != "cancelled"]
    if not completions:
        return {}
    queue = np.asarray([c.admitted_step - c.arrival for c in completions], np.float64)
    first = np.asarray([c.first_token_step if c.first_token_step >= 0 else c.admitted_step
                        for c in completions], np.float64)
    ttft = first - np.asarray([c.arrival for c in completions], np.float64) + 1.0
    tps = np.asarray([len(c.tokens) / max(1, c.finished_step - c.admitted_step + 1)
                      for c in completions], np.float64)

    def pct(a):
        return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
                "mean": float(np.mean(a))}

    out = {"queue_steps": pct(queue), "ttft_steps": pct(ttft), "tokens_per_step": pct(tps)}
    spec = [c.spec_tokens / c.spec_steps for c in completions if c.spec_steps > 0]
    if spec:
        out["accepted_per_step"] = pct(np.asarray(spec, np.float64))
    return out


class Scheduler:
    """Continuous-batching loop over a ``ServeEngine`` (see module docstring).

    Built from one ``ServeConfig``: ``Scheduler(engine, config)``.  The
    legacy keyword form ``Scheduler(engine, n_slots, temperature=...)``
    still works but warns with a ``DeprecationWarning``, as in the JAX
    package.  ``n_blocks`` defaults to n_slots x ceil(max_len/block) (never
    preempts) and must hold at least one max_len request."""

    def __init__(self, engine, config: Optional[ServeConfig] = None, **legacy):
        if isinstance(config, int):  # legacy positional n_slots
            legacy["n_slots"] = config
            config = None
        if legacy:
            if config is not None:
                raise TypeError("pass either a ServeConfig or legacy keyword args, not both")
            warnings.warn(
                "Scheduler(engine, n_slots, **kwargs) is deprecated; pass "
                "Scheduler(engine, serve.ServeConfig(...))",
                DeprecationWarning,
                stacklevel=2,
            )
            config = ServeConfig(**legacy)
        config = (config or ServeConfig()).resolve(engine)
        self.config = config
        self.eng = engine
        self.cfg = engine.cfg
        self.n_slots = S = int(config.n_slots)
        self.temperature = float(config.temperature)
        self.top_k = int(config.top_k)
        self._seed = int(config.seed)
        self._temp = max(self.temperature, 1e-6)
        self._groups = scan_groups(self.cfg)
        self._fns = engine.scheduler_fns(greedy=self.temperature <= 0.0, top_k=self.top_k)
        # telemetry: the registry is always on; span tracing and the
        # profiler window are opt-in.  Made first, so every part built
        # below (prefix cache, pool gauges, stats view) reports into it
        tele = config.telemetry
        self.registry = MetricsRegistry()
        self.tracer = StepTracer(tele.trace_capacity) if tele.trace else NULL_TRACER
        self._profile = make_profile_window(tele.profile_dir, tele.profile_steps,
                                            cuda=engine.device.type == "cuda")
        self.monitor = StepTimeMonitor()
        self._straggler_warned = False
        caps = engine.capabilities()
        # quantized pools of the fully-paged tier: every admission runs the
        # tail-prefill step (start 0), so its first token comes from
        # attention over the quantized pool, as every later step's does
        self._quant_admit = bool(engine.kv_quant_bits) and bool(caps["fully_paged"])
        self._compiles0 = self._fns.admit_compiles
        self.block_size = blk = int(config.block_size)
        self.max_blocks = -(-engine.max_len // blk)
        self.n_blocks = int(config.n_blocks) or S * self.max_blocks
        if self.n_blocks < self.max_blocks:
            raise ValueError(
                f"n_blocks={self.n_blocks} cannot hold one max_len={engine.max_len} "
                f"request ({self.max_blocks} blocks of {blk})"
            )
        self.pool = BlockPool(self.n_blocks, blk)
        # the prefix cache and chunked prefill ride the tail-prefill step:
        # fully-paged tier only; elsewhere the knobs are accepted and inert
        self.prefix: Optional[PrefixCache] = None
        if config.prefix_cache and caps["prefix_cache"]:
            self.prefix = PrefixCache(self.pool, blk, engine.params_fingerprint(),
                                      registry=self.registry)
            self.pool.set_reclaimer(self.prefix.reclaim)
        self.chunk = int(config.prefill_chunk) if caps["chunked_prefill"] else 0
        self._time_admissions = bool(config.time_admissions)
        # events / admit_times / the span tracer share trace_capacity and its
        # oldest-first drop rule (RingLog)
        self.admit_times: List[Tuple[int, float, int]] = RingLog(
            tele.trace_capacity)  # (request, seconds, hit tokens)
        dev = engine.device
        # physical block ids = logical + 1; row 0 is the trash block
        self._block_tables = torch.zeros((S, self.max_blocks), dtype=torch.int32, device=dev)
        self.caches = self._init_caches()
        self._tokens = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((S,), dtype=torch.bool, device=dev)
        self._seed0 = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._slots: List[Optional[_Slot]] = [None] * S
        self._n_live = 0
        self._queue: collections.deque = collections.deque()
        self._n_submitted = 0
        self._completions: Dict[int, Completion] = {}
        self._on_token: Dict[int, Callable[[int, int], None]] = {}
        self._on_finish: Dict[int, Callable[[Completion], None]] = {}
        self._streamed: Dict[int, int] = {}  # request -> tokens already streamed
        self.step_count = 0
        self._buckets_used: set = set()
        # stats is a thin view over the registry's serve_* counters
        self.stats = StatsView(self.registry, "serve_")
        for key in (
            "decode_steps", "idle_steps", "prefill_only_steps", "prefills",
            "prefill_chunks", "chunked_admissions", "admissions", "evictions",
            "preemptions", "cancellations", "tokens_emitted", "admission_traces",
            "admission_trace_compiles", "chunk_trace_compiles", "decode_trace_compiles",
            "peak_live_slots", "prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "prefix_cow_copies", "prefix_evicted_blocks",
        ):
            self.stats[key] = 0
        # the port has no jit caches: the compile counters read the engine's
        # memo of decode signatures and tail-prefill steps built
        self._decode_cache0 = self._fns.decode_cache_size()
        self._prefix_compiles0 = self._fns.prefix_compiles
        reg = self.registry
        self._h_queue = reg.histogram(
            "serve_queue_wait_steps",
            "steps a finished request waited for a slot (restart wait included)",
            log_buckets(1, 4096),
        )
        self._h_ttft = reg.histogram(
            "serve_ttft_steps",
            "arrival to first sampled token, in decode steps",
            log_buckets(1, 4096),
        )
        self._h_itl = reg.histogram(
            "serve_itl_seconds",
            "wall time per committed token (per-row view of decode-step time)",
            log_buckets(1e-5, 32.0, 4.0),
        )
        self._h_accept = reg.histogram(
            "serve_accepted_per_step",
            "tokens committed per (row, speculative round); vanilla decode is 1",
            log_buckets(1, 16),
        )
        self._g_live = reg.gauge("serve_live_slots", "occupied decode slots")
        self._g_queue = reg.gauge("serve_queue_depth", "requests waiting for admission")
        self._g_pool_live = reg.gauge("serve_pool_live_blocks", "pool blocks held by live requests")
        self._g_pool_free = reg.gauge("serve_pool_free_blocks", "immediately allocatable blocks")
        self._g_pool_cached = reg.gauge(
            "serve_pool_cached_free_blocks", "cached-free tier (prefix blocks reclaimable by LRU)"
        )
        self._g_ewma = reg.gauge("serve_step_time_ewma_seconds", "EWMA decode-step wall time")
        self._g_straggler = reg.gauge(
            "serve_straggler_fraction", "fraction of decode steps flagged slow by the monitor"
        )
        self._timelines: Dict[int, List[Tuple[str, int]]] = {}
        self.events: List[Tuple[int, str, int, int]] = RingLog(
            tele.trace_capacity)  # (step, kind, request, slot); oldest dropped past capacity
        # read once here: the pool's size never changes and a gauge must not sync
        reg.gauge("serve_pool_bytes", "resident KV pool bytes (all devices)").set(
            self.cache_bytes())
        reg.gauge(
            "serve_pool_bytes_per_device",
            "per-device resident paged-pool bytes (head-sharded data leaves divided; §12)",
        ).set(self.paged_pool_bytes())
        self._sync_gauges()

    # ------------------------------------------------------------------
    # cache pool
    # ------------------------------------------------------------------
    def _init_caches(self):
        """Zero pools with the prefill caches' dtypes, one sub at a time:
        paged leaves become shared (n_blocks+1, block, ...) pools (+1 for the
        trash block); any other leaf (recurrent / SSD state, conv window)
        keeps a per-slot row with the batch axis widened to n_slots.  Zeros
        keep the trash block finite: the kernel multiplies masked p = 0 by v,
        so a NaN there would poison every row.

        With ``engine.kv_quant_bits`` the paged data pools hold int8 words
        (last dim halved at 4 bits: two lanes per word), and each gains a
        zeroed int32 ``<name>_scale`` sibling of one exponent per
        (physical block, KV head), per physical block for MLA's c_kv / k_rope."""
        specs = self.eng.prefill_cache_specs()
        S, blk, n_phys = self.n_slots, self.block_size, self.n_blocks + 1
        qbits = self.eng.kv_quant_bits
        dev = self.eng.device
        pool = {}
        for g in self._groups:
            axis = 1 if g.stacked else 0
            pool[g.name] = {}
            for j, paged in enumerate(g.paged):
                sub = pool[g.name][f"sub{j}"] = {}
                for name, spec in specs[g.name][f"sub{j}"].items():
                    shape, dt = tuple(spec.shape), spec.dtype
                    if paged and name in PAGED_CACHE_LEAVES:
                        feat = shape[axis + 2:]
                        if qbits:
                            if qbits == 4:
                                feat = feat[:-1] + (feat[-1] // 2,)
                            sub[name] = torch.zeros(shape[:axis] + (n_phys, blk) + feat,
                                                    dtype=torch.int8, device=dev)
                            sub[name + "_scale"] = torch.zeros(
                                shape[:axis] + (n_phys,) + feat[:-1], dtype=torch.int32,
                                device=dev)
                            continue
                        shape = shape[:axis] + (n_phys, blk) + feat
                    else:
                        shape = shape[:axis] + (S,) + shape[axis + 1:]
                    sub[name] = torch.zeros(shape, dtype=dt, device=dev)
        return pool

    def cache_bytes(self) -> int:
        """Resident KV bytes of the pool (exponent leaves included)."""
        return sum(leaf.numel() * leaf.element_size()
                   for g in self.caches.values() for sub in g.values() for leaf in sub.values())

    def paged_pool_bytes(self) -> int:
        """Bytes of the paged leaves and their exponents alone: the whole
        pool lives on one card, so this is the JAX package's per-device
        pool size off a mesh."""
        return sum(leaf.numel() * leaf.element_size()
                   for g in self._groups for j, paged in enumerate(g.paged) if paged
                   for name, leaf in self.caches[g.name][f"sub{j}"].items()
                   if name.removesuffix("_scale") in PAGED_CACHE_LEAVES)

    # ------------------------------------------------------------------
    # queue / admission
    # ------------------------------------------------------------------
    def submit(self, req: Request, *, on_token: Optional[Callable[[int, int], None]] = None,
               on_finish: Optional[Callable[[Completion], None]] = None) -> int:
        """Enqueue a request; returns its index (completion order key).

        ``on_token(index, token)`` streams each committed token (overrides
        ``ServeConfig.on_token``); ``on_finish(completion)`` fires once,
        after the last token, for any finish reason, cancellation included.
        Preemption replays are deduplicated: every token streams once."""
        prompt = np.asarray(req.tokens, np.int32).reshape(-1)
        budget = min(int(req.max_new_tokens), self.eng.max_len - prompt.shape[0] + 1)
        if budget < 1:
            raise ValueError(f"prompt of length {prompt.shape[0]} leaves no room for "
                             f"generation under max_len={self.eng.max_len}")
        idx = self._n_submitted
        self._n_submitted += 1
        cb = on_token if on_token is not None else self.config.on_token
        if cb is not None:
            self._on_token[idx] = cb
        if on_finish is not None:
            self._on_finish[idx] = on_finish
        self._timelines[idx] = [("submit", self.step_count)]
        self._queue.append((idx, prompt, budget, req))
        return idx

    def cancel(self, idx: int) -> bool:
        """Cancel request ``idx``: a queued request is dropped; a live one is
        torn down now — its blocks return to the pool (the zeroed table row
        sends any write to the trash block, so surviving rows never notice)
        and its partial output becomes a ``finish_reason='cancelled'``
        Completion.  Returns False when the request is unknown or already
        finished."""
        for i, item in enumerate(self._queue):
            if item[0] == idx:
                del self._queue[i]
                self._timeline(idx, "cancel")
                self.tracer.instant("cancel", req=idx)
                self._seal(Completion(
                    index=idx, tokens=[], prompt_len=int(item[1].shape[0]),
                    finish_reason="cancelled", slot=-1, arrival=item[3].arrival,
                    admitted_step=-1, finished_step=self.step_count))
                self.events.append((self.step_count, "cancel", idx, -1))
                self.stats["cancellations"] += 1
                return True
        for slot, state in enumerate(self._slots):
            if state is not None and state.index == idx:
                self._emit_tokens(state)
                self._release(slot)
                self._timeline(idx, "cancel")
                self.tracer.instant("cancel", req=idx, slot=slot)
                self._seal(Completion(
                    index=idx, tokens=list(state.out), prompt_len=state.prompt_len,
                    finish_reason="cancelled", slot=slot, arrival=state.req.arrival,
                    admitted_step=state.admitted_step, finished_step=self.step_count,
                    first_token_step=state.first_token_step))
                self.events.append((self.step_count, "cancel", idx, slot))
                self.stats["cancellations"] += 1
                return True
        return False

    def _timeline(self, idx: int, event: str) -> None:
        tl = self._timelines.get(idx)
        if tl is not None:
            tl.append((event, self.step_count))

    def _seal(self, comp: Completion) -> None:
        """Record a completion, attach its timeline, fire its on_finish."""
        comp.timeline = self._timelines.pop(comp.index, [])
        self._completions[comp.index] = comp
        cb = self._on_finish.get(comp.index)
        if cb is not None:
            cb(comp)

    def _emit_tokens(self, state: _Slot) -> None:
        """Stream the request's committed tokens not yet streamed, one
        'token' timeline entry each.  Dedup is by count against the
        request's lifetime stream: a preemption replay is token-exact, so a
        replayed prefix is exactly what was already delivered."""
        n = self._streamed.get(state.index, 0)
        if len(state.out) <= n:
            return
        cb = self._on_token.get(state.index)
        tl = self._timelines.get(state.index)
        for t in state.out[n:]:
            if cb is not None:
                cb(state.index, int(t))
            if tl is not None:
                tl.append(("token", self.step_count))
        self._streamed[state.index] = len(state.out)

    def _bucket(self, lp: int) -> int:
        """Power-of-two padded prompt length, capped at the cache room."""
        b = 1
        while b < lp:
            b <<= 1
        return min(b, self.eng.max_len)

    def _pop_due(self):
        """Highest-priority due request, FIFO among equal priorities (a
        future-dated or low-priority head does not block due work behind
        it); ``priority=0`` everywhere is plain FIFO among due requests."""
        best = None
        for i, item in enumerate(self._queue):
            if item[3].arrival <= self.step_count:
                if best is None or item[3].priority > self._queue[best][3].priority:
                    best = i
        if best is None:
            return None
        item = self._queue[best]
        del self._queue[best]
        return item

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a sync: pinned and
        non-blocking to a card (a pageable copy would wait on the stream)."""
        t = torch.from_numpy(np.array(a))
        if self.eng.device.type == "cuda":
            return t.pin_memory().to(self.eng.device, non_blocking=True)
        return t

    def _match_prefix(self, prompt: np.ndarray) -> Tuple[int, List[int]]:
        """Cached-prefix match for admission: ``(matched, path_bids)``, the
        bids covering the first ceil(matched / block) prompt blocks.  Capped
        at ``lp - 1`` so a hit leaves at least one tail token to prefill
        (the admission samples a first token)."""
        if self.prefix is None:
            return 0, []
        return self.prefix.match(prompt, self.eng.params_fingerprint(),
                                 max_match=prompt.shape[0] - 1)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self._slots[slot] is not None:
                continue
            item = self._pop_due()
            if item is None:
                return
            idx, prompt, budget, req = item
            lp = prompt.shape[0]
            # +1 covers the first decode write at pos = lp, clamped to the table
            need = min(lp // self.block_size + 1, self.max_blocks)
            matched, path = self._match_prefix(prompt)
            m_full, m_part = divmod(matched, self.block_size)
            # pin the matched path first: alloc's reclaim (LRU eviction of
            # cached-free blocks) must not recycle the blocks just matched
            shared, src = path[:m_full], (path[m_full] if m_part else None)
            for bid in shared:
                self.pool.acquire(bid)
            if src is not None:
                self.pool.acquire(src)
            fresh = self.pool.alloc(need - m_full)
            if fresh is None:  # memory-bound: undo the pins, requeue at the front, stop
                for bid in shared:
                    self.pool.free(bid)
                if src is not None:
                    self.pool.free(src)
                self._queue.appendleft(item)
                return
            if src is not None:
                # copy-on-write: the hit ends inside a cached block; the
                # request appends into a private copy of its physical row
                # (before the tail writes into it)
                self.caches = self.eng._with_backend(self._fns.cow_copy, self.caches, src + 1,
                                                     fresh[0] + 1)
                self.pool.free(src)
                self.stats["prefix_cow_copies"] += 1
                self.tracer.instant("cow", req=idx, src=src, dst=fresh[0])
            if matched:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += matched
                self.tracer.instant("prefix_hit", req=idx, tokens=matched)
            elif self.prefix is not None:
                self.stats["prefix_misses"] += 1
            self._admit_one(slot, idx, prompt, budget, req, shared + fresh, start=matched)

    def _admit_batch(self, prompt: np.ndarray):
        """(bucket, batch) of a one-shot admission: the prompt right-padded
        to its power-of-two bucket.  Shared with the speculative scheduler's
        draft-pool mirror, so the two prefills cannot diverge in prep."""
        lp = prompt.shape[0]
        bucket = self._bucket(lp)
        padded = np.zeros(bucket, np.int32)
        padded[:lp] = prompt
        return bucket, {"tokens": self._upload(padded[None])}

    def _new_slot(self, slot, idx, prompt, budget, req, blocks) -> _Slot:
        """Host-side slot bookkeeping of one-shot and chunked admission;
        the device row stays untouched here."""
        state = _Slot(index=idx, eos_id=int(req.eos_id), budget=budget, prompt=prompt, req=req,
                      out=[], admitted_step=self.step_count, pos=prompt.shape[0], blocks=blocks)
        self._slots[slot] = state
        self._n_live += 1
        self.stats["peak_live_slots"] = max(self.stats["peak_live_slots"], self._n_live)
        self._timeline(idx, "admit")
        return state

    def _table_row(self, blocks: List[int]) -> np.ndarray:
        row = np.zeros(self.max_blocks, np.int32)
        row[: len(blocks)] = np.asarray(blocks, np.int32) + 1  # physical ids
        return row

    def _tail_step(self, prompt: np.ndarray, start: int, tail: int, bt_row, idx: int):
        """One tail-prefill call: ``tail`` prompt tokens from ``start`` into
        the pool through ``bt_row``; returns the first-token tensor."""
        bucket = self._bucket(tail)
        padded = np.zeros(bucket, np.int32)
        padded[:tail] = prompt[start: start + tail]
        admit = self._fns.admit_prefix_step(bucket, self.block_size)
        first_t, self.caches = self.eng._with_backend(
            admit, self.eng.params, {"tokens": self._upload(padded[None])}, tail, start,
            self.caches, bt_row, _sample_seed(idx, 0), self._seed, self._temp)
        self._buckets_used.add(("prefix", bucket, self.block_size))
        return first_t

    def _count_traces(self) -> None:
        """admission_traces: the distinct bucketed admission steps this run
        used; the compile counters: the ones built fresh for this run (0 on
        a warm engine; the chunk counter the tail-prefill subset)."""
        self.stats["admission_traces"] = len(self._buckets_used)
        self.stats["admission_trace_compiles"] = self._fns.admit_compiles - self._compiles0
        self.stats["chunk_trace_compiles"] = self._fns.prefix_compiles - self._prefix_compiles0

    def _index_prompt(self, state: _Slot) -> None:
        """Index every prompt block in the prefix cache (shared levels dedupe
        onto existing nodes) while the blocks are still pinned by the table."""
        if self.prefix is not None:
            self.prefix.insert(state.prompt, state.blocks, self.eng.params_fingerprint())
            self.stats["prefix_evicted_blocks"] = self.prefix.stats["evicted_blocks"]

    def _admit_one(self, slot, idx, prompt, budget, req, blocks, start: int = 0) -> None:
        lp = prompt.shape[0]
        if self.chunk and lp - start > self.chunk:
            # chunked admission: hold the blocks, keep the DEVICE row zeroed,
            # and let the step loop run one tail-prefill chunk per step
            state = self._new_slot(slot, idx, prompt, budget, req, blocks)
            state.prefilling, state.done, state.hit = True, start, start
            state.row = self._table_row(blocks)
            self.stats["chunked_admissions"] += 1
            self.events.append((self.step_count, "admit", idx, slot))
            return
        t0 = time.perf_counter() if self._time_admissions else 0.0
        with self.tracer.span("admit", step=self.step_count, req=idx, slot=slot, prompt=lp):
            self._block_tables[slot] = self._upload(self._table_row(blocks))
            bt_row = self._block_tables[slot]
            if start or self._quant_admit:
                # a prefix hit prefills only the uncached tail; a quantized
                # pool sends misses (start 0) through the same step, so every
                # first token comes from attention over the quantized pool
                first_t = self._tail_step(prompt, start, lp - start, bt_row, idx)
            else:
                bucket, batch = self._admit_batch(prompt)
                admit = self._fns.admit_step(bucket, self.block_size)
                first_t, self.caches = self.eng._with_backend(
                    admit, self.eng.params, batch, lp, self.caches, bt_row, slot,
                    _sample_seed(idx, 0), self._seed, self._temp)
                self._buckets_used.add((bucket, self.block_size))
        self.stats["prefills"] += 1
        self._count_traces()
        state = self._new_slot(slot, idx, prompt, budget, req, blocks)
        self._index_prompt(state)
        if self._time_admissions:
            first_t.cpu()
            self.admit_times.append((idx, time.perf_counter() - t0, start))
        self.events.append((self.step_count, "admit", idx, slot))
        self._activate(slot, first_t)

    def _prefill_chunk(self, slot: int) -> None:
        """One tail-prefill chunk of a prefilling slot from ``start`` = the
        tokens done, through the host row (the device row stays zeroed).  A
        non-final chunk's sampled token is dropped without a sync; the final
        chunk's is the request's first token, drawn with the (request, 0)
        stream a one-shot admission uses, and then the device row is
        published and the slot goes live."""
        state = self._slots[slot]
        lp = state.prompt_len
        tail = min(self.chunk, lp - state.done)
        t0 = time.perf_counter() if self._time_admissions else 0.0
        with self.tracer.span("chunk", step=self.step_count, req=state.index, slot=slot,
                              done=state.done, tail=tail):
            first_t = self._tail_step(state.prompt, state.done, tail, self._upload(state.row),
                                      state.index)
        state.done += tail
        self._timeline(state.index, "chunk")
        self.stats["prefill_chunks"] += 1
        self._count_traces()
        if self._time_admissions:
            first_t.cpu()
            state.admit_wall += time.perf_counter() - t0
        if state.done < lp:
            return
        self.stats["prefills"] += 1
        self._block_tables[slot] = self._upload(state.row)
        # only now do the blocks hold the whole prompt's KV
        self._index_prompt(state)
        if self._time_admissions:
            self.admit_times.append((state.index, state.admit_wall, state.hit))
        self._activate(slot, first_t)

    def _advance_prefills(self) -> None:
        """The chunk pass: one chunk per prefilling slot per step, before
        the live decode step."""
        for slot in range(self.n_slots):
            state = self._slots[slot]
            if state is not None and state.prefilling:
                self._prefill_chunk(slot)

    def _activate(self, slot: int, first_t) -> None:
        """Flip a slot live once the whole prompt's KV is resident and its
        first token sampled: publish the device slot state the decode step
        reads, record and stream the token, and apply the instant finish
        checks."""
        state = self._slots[slot]
        first = int(first_t)  # the admission's one host sync
        state.prefilling = False
        state.out.append(first)
        state.first_token_step = self.step_count
        self.stats["admissions"] += 1
        self.stats["tokens_emitted"] += 1
        self._tokens[slot] = first_t
        self._pos[slot] = state.pos
        # seed0 + pos == _sample_seed(idx, len(out)) at every later step
        self._seed0[slot] = _sample_seed(state.index, 1) - state.pos
        self._active[slot] = True
        self._emit_tokens(state)
        if first == state.eos_id or len(state.out) >= state.budget:
            self._finish(slot, "eos" if first == state.eos_id else "length")

    # ------------------------------------------------------------------
    # eviction / preemption
    # ------------------------------------------------------------------
    def _release(self, slot: int) -> _Slot:
        """Free the blocks, zero the table row (writes go to trash), deactivate."""
        state = self._slots[slot]
        self.pool.free_all(state.blocks)
        self._block_tables[slot] = 0
        self._slots[slot] = None
        self._n_live -= 1
        self._active[slot] = False
        return state

    def _finish(self, slot: int, reason: str) -> None:
        state = self._release(slot)
        self._h_queue.observe(max(0, state.admitted_step - state.req.arrival))
        if state.first_token_step >= 0:
            self._h_ttft.observe(state.first_token_step - state.req.arrival + 1)
        self.tracer.instant("evict", req=state.index, slot=slot, reason=reason)
        self._timeline(state.index, "finish")
        self._seal(Completion(
            index=state.index, tokens=list(state.out), prompt_len=state.prompt_len,
            finish_reason=reason, slot=slot, arrival=state.req.arrival,
            admitted_step=state.admitted_step, finished_step=self.step_count,
            first_token_step=state.first_token_step))
        self.events.append((self.step_count, "evict", state.index, slot))
        self.stats["evictions"] += 1

    def _preempt(self, slot: int) -> None:
        """Evict a live request under pool pressure and requeue it at the
        front for a from-scratch (token-exact) restart; what it already
        streamed is not streamed again (``_emit_tokens`` dedupes)."""
        state = self._release(slot)
        self._queue.appendleft((state.index, state.prompt, state.budget, state.req))
        self.events.append((self.step_count, "preempt", state.index, slot))
        self.stats["preemptions"] += 1
        self.tracer.instant("preempt", req=state.index, slot=slot)
        self._timeline(state.index, "preempt")

    def _grow_tables(self, horizon: int = 0) -> None:
        """Allocate blocks for every live row through position ``pos +
        horizon`` (clamped to the cache end), oldest request first;
        exhaustion preempts the lowest-priority live request, the youngest
        among ties (the oldest high-priority request always progresses, so
        the loop terminates).  A decode step needs horizon 0; the
        speculative scheduler reserves its whole draft window, so a verify
        never writes through a missing table entry."""
        order = sorted((s for s in range(self.n_slots) if self._slots[s] is not None),
                       key=lambda s: (self._slots[s].admitted_step, self._slots[s].index))
        for slot in order:
            state = self._slots[slot]
            if state is None:  # preempted by an older slot's growth
                continue
            need_bi = min(state.pos + horizon, self.eng.max_len - 1) // self.block_size
            while state is not None and need_bi >= len(state.blocks):
                bi = len(state.blocks)
                got = self.pool.alloc(1)
                if got is not None:
                    state.blocks.append(got[0])
                    self._block_tables[slot, bi] = got[0] + 1
                    continue
                victim = max(
                    (s for s in range(self.n_slots) if self._slots[s] is not None),
                    key=lambda s: (-self._slots[s].req.priority, self._slots[s].admitted_step,
                                   self._slots[s].index),
                )
                self._preempt(victim)
                if victim == slot:
                    state = None  # the requester itself was the victim; it restarts

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------
    def _n_decoding(self) -> int:
        """Live slots past their prefill (the decode step's real rows)."""
        return sum(1 for st in self._slots if st is not None and not st.prefilling)

    def _sync_gauges(self) -> None:
        """Refresh the point-in-time occupancy gauges (host ints, per step)."""
        self._g_live.set(self._n_live)
        self._g_queue.set(len(self._queue))
        self._g_pool_live.set(self.pool.n_live)
        self._g_pool_free.set(self.pool.n_free)
        self._g_pool_cached.set(self.pool.n_cached_free)

    def _observe_step_time(self, dt: float) -> None:
        """Feed one decode step's wall time to the straggler monitor, mirror
        its EWMA and straggler fraction into gauges, and warn once when the
        flagged fraction stays above ``telemetry.straggler_warn`` past
        warmup (the gauges keep tracking either way)."""
        self.monitor.observe(dt)
        self._g_ewma.set(self.monitor.ewma or 0.0)
        frac = self.monitor.straggler_fraction()
        self._g_straggler.set(frac)
        warn = self.config.telemetry.straggler_warn
        if (warn and not self._straggler_warned
                and self.monitor.count > 2 * self.monitor.warmup and frac > warn):
            self._straggler_warned = True
            print(f"[serve] sustained stragglers: {frac:.0%} of {self.monitor.count} decode "
                  f"steps ran > {self.monitor.threshold:g}x the EWMA step time "
                  f"({self.monitor.ewma:.4g}s)", file=sys.stderr)

    def step(self) -> bool:
        """Grow live tables, admit what fits, run one prefill chunk per
        prefilling slot, then one ragged decode step over the live rows.
        Growth runs first, so live requests reserve their next blocks
        before admission spends them.  Returns False once the queue is
        drained and every slot is idle."""
        if self._profile is not None:
            self._profile.on_step()
        self._grow_tables()
        self._admit()
        if self.prefix is not None:
            self.stats["prefix_evicted_blocks"] = self.prefix.stats["evicted_blocks"]
        if self._n_live == 0:
            if not self._queue:
                self._sync_gauges()
                return False
            self.step_count += 1  # arrivals still in the future: tick time
            self.stats["idle_steps"] += 1
            self._sync_gauges()
            return True
        self._advance_prefills()
        if self._n_decoding() == 0:
            # every live slot is mid-prefill: the chunk pass was this step
            self.step_count += 1
            self.stats["prefill_only_steps"] += 1
            self._sync_gauges()
            return bool(self._n_live or self._queue)
        t0 = time.perf_counter()
        with self.tracer.span("decode", step=self.step_count, n_decode=self._n_decoding(),
                              n_live=self._n_live):
            self._tokens, self._pos, self.caches = self.eng._with_backend(
                self._fns.decode_step, self.eng.params, self.caches, self._tokens, self._pos,
                self._active, self._seed0, self._block_tables, self._seed, self._temp,
            )
            nxt = self._tokens.cpu().numpy()  # the loop's one host sync
        dt = time.perf_counter() - t0
        self.step_count += 1
        self.stats["decode_steps"] += 1
        self.stats["decode_trace_compiles"] = self._fns.decode_cache_size() - self._decode_cache0
        self._observe_step_time(dt)
        for s, state in enumerate(self._slots):
            if state is None or state.prefilling:
                continue
            state.pos += 1
            tok = int(nxt[s])
            state.out.append(tok)
            self.stats["tokens_emitted"] += 1
            self._h_itl.observe(dt)
            self._emit_tokens(state)
            if tok == state.eos_id:
                self._finish(s, "eos")
            elif len(state.out) >= state.budget:
                self._finish(s, "length")
        self._sync_gauges()
        return bool(self._n_live or self._queue)

    def run(self) -> List[Completion]:
        """Drain the queue; completions in submission order."""
        try:
            while self.step():
                pass
        finally:
            if self._profile is not None:
                self._profile.stop()
        return [self._completions[i] for i in sorted(self._completions)]


def serve_requests(engine, requests: Sequence[Request],
                   config: Optional[ServeConfig] = None) -> Tuple[List[Completion], Scheduler]:
    """Schedule ``requests`` onto ``engine`` and drain; ``config.speculative``
    runs the draft / verify scheduler."""
    config = (config or ServeConfig()).resolve(engine, requests)
    if config.speculative is not None:
        from repro_torch.serve.speculative import SpeculativeScheduler

        sched = SpeculativeScheduler(engine, config)
    else:
        sched = Scheduler(engine, config)
    for r in requests:
        sched.submit(r)
    return sched.run(), sched
