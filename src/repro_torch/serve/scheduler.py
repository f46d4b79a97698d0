"""Continuous-batching request scheduler over ``ServeEngine`` with a paged
KV-cache block pool (mirrors the core of ``repro/serve/scheduler.py``).

  * a FIFO request queue with optional arrival times (decode-step units);
    admission takes the first due request;
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
    crosses a boundary; pool exhaustion preempts the youngest live request,
    which restarts from scratch — greedy decoding is deterministic and
    sampled streams are keyed by (request index, step), so the replay is
    token-exact;
  * eviction on eos or length returns the blocks and zeroes the table row;
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

Telemetry, async, priority and cancellation come in later slices.  Slot
state (tokens, positions, stream offsets, active flags, block tables) lives
on the device; the host downloads only the sampled tokens, once per step
(and a chunked admission's first token, at its final chunk).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.lm import PAGED_CACHE_LEAVES, scan_groups
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


@dataclasses.dataclass
class Completion:
    index: int  # submission order
    tokens: List[int]  # generated ids (incl. the eos token if emitted)
    prompt_len: int
    finish_reason: str  # 'eos' | 'length'
    slot: int
    arrival: int
    admitted_step: int  # last admission (preempted requests restart)
    finished_step: int
    first_token_step: int = -1  # == admitted_step one-shot; a chunked prompt's final chunk
    spec_steps: int = 0  # speculative draft / verify rounds this request rode
    spec_tokens: int = 0  # tokens those rounds committed (accepted + bonus)


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


def _sample_seed(req_index: int, step: int) -> int:
    """Stream id of the ``step``-th token of request ``req_index``: keyed by
    request identity, not slot, so placement and preemption restarts cannot
    change a draw.  Decode recomputes it on the device as ``seed0 + pos``
    (seed0 written at activation), so it stays affine in ``step``.  The
    index wraps at 2048 to stay inside int32, as in the JAX package."""
    return (req_index % 2048) * 1_000_003 + step


def latency_stats(completions: Sequence[Completion]) -> Dict[str, Dict[str, float]]:
    """Per-request latency percentiles in decode-step units: queue_steps
    (admitted - arrival), ttft_steps (first token - arrival + 1: a chunked
    prompt's first token comes at its final chunk), tokens_per_step
    (tokens over the steps the slot was occupied) and, for speculative
    serves, accepted_per_step (tokens committed per draft / verify round;
    vanilla decode is 1)."""
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

    ``n_blocks`` defaults to n_slots x ceil(max_len/block) (never preempts)
    and must hold at least one max_len request."""

    def __init__(self, engine, config: Optional[ServeConfig] = None):
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
            self.prefix = PrefixCache(self.pool, blk, engine.params_fingerprint())
            self.pool.set_reclaimer(self.prefix.reclaim)
        self.chunk = int(config.prefill_chunk) if caps["chunked_prefill"] else 0
        self._time_admissions = bool(config.time_admissions)
        self.admit_times: List[Tuple[int, float, int]] = []  # (request, seconds, hit tokens)
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
        self.step_count = 0
        self._buckets_used: set = set()
        self.stats: Dict[str, int] = {
            k: 0 for k in (
                "decode_steps", "idle_steps", "prefill_only_steps", "prefills",
                "prefill_chunks", "chunked_admissions", "admissions", "evictions",
                "preemptions", "tokens_emitted", "admission_traces",
                "admission_trace_compiles", "peak_live_slots", "prefix_hits",
                "prefix_misses", "prefix_hit_tokens", "prefix_cow_copies",
                "prefix_evicted_blocks",
            )
        }

    # ------------------------------------------------------------------
    # cache pool
    # ------------------------------------------------------------------
    def _init_caches(self):
        """Zero pools with the prefill caches' dtypes: paged leaves become
        shared (n_blocks+1, block, ...) pools (+1 for the trash block); any
        other leaf keeps a per-slot row with the batch axis widened to
        n_slots.  Zeros keep the trash block finite: the kernel multiplies
        masked p = 0 by v, so a NaN there would poison every row.

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
            sub = {}
            for name, spec in specs[g.name]["sub0"].items():
                shape, dt = tuple(spec.shape), spec.dtype
                if g.paged[0] and name in PAGED_CACHE_LEAVES:
                    feat = shape[axis + 2:]
                    if qbits:
                        if qbits == 4:
                            feat = feat[:-1] + (feat[-1] // 2,)
                        sub[name] = torch.zeros(shape[:axis] + (n_phys, blk) + feat,
                                                dtype=torch.int8, device=dev)
                        sub[name + "_scale"] = torch.zeros(shape[:axis] + (n_phys,) + feat[:-1],
                                                           dtype=torch.int32, device=dev)
                        continue
                    shape = shape[:axis] + (n_phys, blk) + feat
                else:
                    shape = shape[:axis] + (S,) + shape[axis + 1:]
                sub[name] = torch.zeros(shape, dtype=dt, device=dev)
            pool[g.name] = {"sub0": sub}
        return pool

    def cache_bytes(self) -> int:
        """Resident KV bytes of the pool (exponent leaves included)."""
        return sum(leaf.numel() * leaf.element_size()
                   for g in self.caches.values() for sub in g.values() for leaf in sub.values())

    # ------------------------------------------------------------------
    # queue / admission
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        """Enqueue a request; returns its index (completion order key)."""
        prompt = np.asarray(req.tokens, np.int32).reshape(-1)
        budget = min(int(req.max_new_tokens), self.eng.max_len - prompt.shape[0] + 1)
        if budget < 1:
            raise ValueError(f"prompt of length {prompt.shape[0]} leaves no room for "
                             f"generation under max_len={self.eng.max_len}")
        idx = self._n_submitted
        self._n_submitted += 1
        self._queue.append((idx, prompt, budget, req))
        return idx

    def _bucket(self, lp: int) -> int:
        """Power-of-two padded prompt length, capped at the cache room."""
        b = 1
        while b < lp:
            b <<= 1
        return min(b, self.eng.max_len)

    def _pop_due(self):
        """First due request (a future-dated head does not block due work)."""
        for i, item in enumerate(self._queue):
            if item[3].arrival <= self.step_count:
                del self._queue[i]
                return item
        return None

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
            if matched:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += matched
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
        self.stats["admission_traces"] = len(self._buckets_used)
        self.stats["admission_trace_compiles"] = self._fns.admit_compiles - self._compiles0

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
            return
        t0 = time.perf_counter() if self._time_admissions else 0.0
        self._block_tables[slot] = self._upload(self._table_row(blocks))
        bt_row = self._block_tables[slot]
        if start or self._quant_admit:
            # a prefix hit prefills only the uncached tail; a quantized pool
            # sends misses (start 0) through the same step, so every first
            # token comes from attention over the quantized pool
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
        first_t = self._tail_step(state.prompt, state.done, tail, self._upload(state.row),
                                  state.index)
        state.done += tail
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
        reads, record the token, and apply the instant finish checks."""
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
        self._completions[state.index] = Completion(
            index=state.index, tokens=list(state.out), prompt_len=state.prompt_len,
            finish_reason=reason, slot=slot, arrival=state.req.arrival,
            admitted_step=state.admitted_step, finished_step=self.step_count,
            first_token_step=state.first_token_step,
        )
        self.stats["evictions"] += 1

    def _preempt(self, slot: int) -> None:
        """Evict a live request under pool pressure and requeue it at the
        front for a from-scratch (token-exact) restart."""
        state = self._release(slot)
        self._queue.appendleft((state.index, state.prompt, state.budget, state.req))
        self.stats["preemptions"] += 1

    def _grow_tables(self, horizon: int = 0) -> None:
        """Allocate blocks for every live row through position ``pos +
        horizon`` (clamped to the cache end), oldest request first;
        exhaustion preempts the youngest live request (the oldest always
        progresses, so the loop terminates).  A decode step needs horizon 0;
        the speculative scheduler reserves its whole draft window, so a
        verify never writes through a missing table entry."""
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
                    key=lambda s: (self._slots[s].admitted_step, self._slots[s].index),
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

    def step(self) -> bool:
        """Grow live tables, admit what fits, run one prefill chunk per
        prefilling slot, then one ragged decode step over the live rows.
        Growth runs first, so live requests reserve their next blocks
        before admission spends them.  Returns False once the queue is
        drained and every slot is idle."""
        self._grow_tables()
        self._admit()
        if self.prefix is not None:
            self.stats["prefix_evicted_blocks"] = self.prefix.stats["evicted_blocks"]
        if self._n_live == 0:
            if not self._queue:
                return False
            self.step_count += 1  # arrivals still in the future: tick time
            self.stats["idle_steps"] += 1
            return True
        self._advance_prefills()
        if self._n_decoding() == 0:
            # every live slot is mid-prefill: the chunk pass was this step
            self.step_count += 1
            self.stats["prefill_only_steps"] += 1
            return bool(self._n_live or self._queue)
        self._tokens, self._pos, self.caches = self.eng._with_backend(
            self._fns.decode_step, self.eng.params, self.caches, self._tokens, self._pos,
            self._active, self._seed0, self._block_tables, self._seed, self._temp,
        )
        nxt = self._tokens.cpu().numpy()  # the loop's one host sync
        self.step_count += 1
        self.stats["decode_steps"] += 1
        for s, state in enumerate(self._slots):
            if state is None or state.prefilling:
                continue
            state.pos += 1
            tok = int(nxt[s])
            state.out.append(tok)
            self.stats["tokens_emitted"] += 1
            if tok == state.eos_id:
                self._finish(s, "eos")
            elif len(state.out) >= state.budget:
                self._finish(s, "length")
        return bool(self._n_live or self._queue)

    def run(self) -> List[Completion]:
        """Drain the queue; completions in submission order."""
        while self.step():
            pass
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
