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
  * eviction on eos or length returns the blocks and zeroes the table row.

With ``kv_cache_dtype`` int8_fp/int4_fp the pools hold
SYMOG-quantized int8 / packed-int4 mantissas with one int32 exponent per
(physical block, KV head) in a ``<name>_scale`` sibling leaf (per physical
block for MLA's head-less c_kv / k_rope).

The prefix cache, chunked prefill, telemetry, async and cancellation come
in later slices.  Slot state (tokens, positions, stream offsets, active
flags, block tables) lives on the device; the host downloads only the
sampled tokens, once per step.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.lm import PAGED_CACHE_LEAVES, scan_groups
from repro_torch.serve.blockpool import BlockPool
from repro_torch.serve.config import ServeConfig, _tier_reasons


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
    first_token_step: int = -1


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
    (admitted - arrival), ttft_steps (first token - arrival + 1) and
    tokens_per_step (tokens over the steps the slot was occupied)."""
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

    return {"queue_steps": pct(queue), "ttft_steps": pct(ttft), "tokens_per_step": pct(tps)}


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
        # quantized pools of the fully-paged tier: every admission runs the
        # tail-prefill step (start 0), so its first token comes from
        # attention over the quantized pool, as every later step's does
        self._quant_admit = bool(engine.kv_quant_bits) and fully_paged_tier(engine)
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
                "decode_steps", "idle_steps", "prefills", "admissions", "evictions",
                "preemptions", "tokens_emitted", "admission_traces",
                "admission_trace_compiles", "peak_live_slots",
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
            blocks = self.pool.alloc(need)
            if blocks is None:  # memory-bound: requeue at the front and stop
                self._queue.appendleft(item)
                return
            self._admit_one(slot, idx, prompt, budget, req, blocks)

    def _admit_one(self, slot, idx, prompt, budget, req, blocks) -> None:
        lp = prompt.shape[0]
        row = np.zeros(self.max_blocks, np.int32)
        row[: len(blocks)] = np.asarray(blocks, np.int32) + 1  # physical ids
        self._block_tables[slot] = torch.from_numpy(row).to(self.eng.device)
        bucket = self._bucket(lp)
        padded = np.zeros(bucket, np.int32)
        padded[:lp] = prompt
        batch = {"tokens": torch.from_numpy(padded[None]).to(self.eng.device)}
        bt_row = self._block_tables[slot]
        sample = (_sample_seed(idx, 0), self._seed, self._temp)
        if self._quant_admit:
            admit = self._fns.admit_prefix_step(bucket, self.block_size)
            first_t, self.caches = self.eng._with_backend(
                admit, self.eng.params, batch, lp, 0, self.caches, bt_row, *sample)
            self._buckets_used.add(("prefix", bucket, self.block_size))
        else:
            admit = self._fns.admit_step(bucket, self.block_size)
            first_t, self.caches = self.eng._with_backend(
                admit, self.eng.params, batch, lp, self.caches, bt_row, slot, *sample)
            self._buckets_used.add((bucket, self.block_size))
        self.stats["prefills"] += 1
        self.stats["admission_traces"] = len(self._buckets_used)
        self.stats["admission_trace_compiles"] = self._fns.admit_compiles - self._compiles0
        state = _Slot(index=idx, eos_id=int(req.eos_id), budget=budget, prompt=prompt, req=req,
                      out=[], admitted_step=self.step_count, pos=lp, blocks=blocks)
        self._slots[slot] = state
        self._n_live += 1
        self.stats["peak_live_slots"] = max(self.stats["peak_live_slots"], self._n_live)
        first = int(first_t)
        state.out.append(first)
        state.first_token_step = self.step_count
        self.stats["admissions"] += 1
        self.stats["tokens_emitted"] += 1
        self._tokens[slot] = first_t
        self._pos[slot] = state.pos
        # seed0 + pos == _sample_seed(idx, len(out)) at every later step
        self._seed0[slot] = _sample_seed(idx, 1) - state.pos
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

    def _grow_tables(self) -> None:
        """Allocate blocks for every live row through its next write position,
        oldest request first; exhaustion preempts the youngest live request
        (the oldest always progresses, so the loop terminates)."""
        order = sorted((s for s in range(self.n_slots) if self._slots[s] is not None),
                       key=lambda s: (self._slots[s].admitted_step, self._slots[s].index))
        for slot in order:
            state = self._slots[slot]
            if state is None:  # preempted by an older slot's growth
                continue
            need_bi = min(state.pos, self.eng.max_len - 1) // self.block_size
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
    def step(self) -> bool:
        """Grow live tables, admit what fits, run one ragged decode step.
        Returns False once the queue is drained and every slot is idle."""
        self._grow_tables()
        self._admit()
        if self._n_live == 0:
            if not self._queue:
                return False
            self.step_count += 1  # arrivals still in the future: tick time
            self.stats["idle_steps"] += 1
            return True
        self._tokens, self._pos, self.caches = self.eng._with_backend(
            self._fns.decode_step, self.eng.params, self.caches, self._tokens, self._pos,
            self._active, self._seed0, self._block_tables, self._seed, self._temp,
        )
        nxt = self._tokens.cpu().numpy()  # the loop's one host sync
        self.step_count += 1
        self.stats["decode_steps"] += 1
        for s, state in enumerate(self._slots):
            if state is None:
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
    """Schedule ``requests`` onto ``engine`` and drain."""
    config = (config or ServeConfig()).resolve(engine, requests)
    sched = Scheduler(engine, config)
    for r in requests:
        sched.submit(r)
    return sched.run(), sched
