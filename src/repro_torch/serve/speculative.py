"""Self-speculative decoding: a low-bit SYMOG draft, a full-precision verify
(mirrors ``repro/serve/speculative.py``).

SYMOG training gives the same weights at several fixed-point bit widths, so
every served model ships with a cheap twin: its low-bit ``pack_tree``
artifact.  Each round the DRAFT (that artifact, with its own paged KV pool
under the target's block tables) runs k single-token decode steps to
propose d_1..d_k; the TARGET then scores all k proposals plus one bonus
position in ONE multi-token pass (``models/lm.py::decode_verify_lm``),
whose logits are what k + 1 sequential decode steps give.

Acceptance:

  * greedy: the longest prefix of drafts equal to the target's argmax
    chain, then the target's own argmax at the first mismatch.  Every
    committed token is the target's greedy choice, so a speculative serve
    is token-identical to ``generate_static``: the draft only decides how
    many tokens arrive per round;
  * sampled: accept d_j with probability min(1, p(d_j) / q(d_j)) (p, q the
    target's and draft's distributions under the same temperature and
    top-k), on rejection draw from norm(max(p - q, 0)), on full acceptance
    draw the bonus token from p_k.  The committed stream is distributed as
    vanilla sampling (not draw-for-draw equal to it).  Draft, accept and
    residual draws take the port's splitmix64 uniforms (``engine.
    sample_uniform``), each under its own tag mixed into the seed and keyed
    by (request, position), never by a ``torch.Generator``: the stream does
    not depend on batch composition.  It differs from ``jax.random``'s.

Rollback is position bookkeeping alone: rejected positions keep stale KV in
both pools, hidden by the position mask until the next round overwrites
it; per-request positions roll back on the host.  The draft pool trails by
one entry after a fully accepted round (the bonus token was never
drafted), so the draft phase runs k + 1 steps: the last writes d_k's draft
KV and its proposal is dropped.  A rejected draft entry can be the first
write to a new block of a quantized pool and so sets that block's
exponent, as in the JAX package.

Adaptive depth (greedy only): each request carries an AIMD recommendation
(one deeper after a clean round, its accepted count after a rejection) and
a round runs at the largest over the live rows.  Sampled rounds always run
at full k: the depth decides which positions draw bonus vs accept /
residual, so a neighbour's recommendation would leak into a stream.

Eligibility is structural (``capabilities()['speculative']``): the
fully-paged tier with MLA allowed.  Elsewhere the flag is accepted and
inert: every step is a vanilla decode step (``stats['spec_steps']`` 0).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.lm import decode_lm, decode_verify_lm
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import filter_logits, sample_tokens, sample_uniform
from repro_torch.serve.scheduler import Scheduler, _sample_seed

# stream tags: draft proposals, accept uniforms and residual draws each mix
# their own tag into the serve seed, so no stream is reused
_DRAFT_TAG = 7901
_ACCEPT_TAG = 7907
_RESIDUAL_TAG = 7919


def _tagged(seed: int, tag: int) -> int:
    """The base seed of one tagged stream family (fits int64)."""
    return ((int(seed) & ((1 << 48) - 1)) << 14) | tag


def speculative_eligible(engine) -> bool:
    """Would ``speculative`` speculate on this engine?  True on the
    fully-paged tier, MLA allowed (``engine.capabilities()``)."""
    return bool(engine.capabilities()["speculative"])


@dataclasses.dataclass
class SpeculativeConfig:
    """``draft``: the draft artifact, a params tree of the SAME architecture
    (typically the 2-bit ``pack_tree``) or a ready ``ServeEngine`` over one.
    ``k``: the most draft tokens a round (the verify scores k + 1).
    ``adaptive``: per-request AIMD depth, honored when greedy only."""

    draft: Any
    k: int = 4
    adaptive: bool = True


def accept_greedy(logits: torch.Tensor, draft_toks: torch.Tensor, valid: torch.Tensor):
    """logits (B, k+1, V), drafts (B, k), valid (B, k+1) -> (tokens (B,
    k+1), accepted (B,)): the target's argmax chain and the length of the
    drafts' agreeing prefix (a masked position never accepts)."""
    tgt = torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
    ok = (draft_toks == tgt[:, :-1]) & valid[:, 1:]
    return tgt, torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def accept_sampled(logits, draft_toks, draft_probs, valid, streams, seed: int, temperature,
                   top_k: int):
    """The rejection rule over one verify.  logits (B, k+1, V) target;
    drafts (B, k) drawn from ``draft_probs`` (B, k, V); valid (B, k+1);
    ``streams`` (B,) int64, the stream id of each row's first verified
    position (seed0 + pos), so position j of row b draws under stream
    ``streams[b] + j``.  Returns (tokens (B, k+1), accepted m (B,)): the
    accepted drafts, then at index m the residual draw from
    norm(max(p_m - q_m, 0)) (p_k itself on full acceptance, and at any
    position whose accept test was masked: q is zeroed there, so a
    capacity-blocked test gets bonus semantics)."""
    B, T, V = logits.shape
    k = T - 1
    dev = logits.device
    p = torch.softmax(filter_logits(logits.to(torch.float32), temperature, top_k), dim=-1)
    d = draft_toks.to(torch.int64)
    p_d = torch.gather(p[:, :k], 2, d[..., None])[..., 0]
    q_d = torch.gather(draft_probs, 2, d[..., None])[..., 0]
    # accept d_j w.p. min(1, p/q); an exact draft (p == q) always accepts (u < 1)
    seeds = streams.to(torch.int64)[:, None] + torch.arange(k, device=dev)[None]
    u = sample_uniform(_tagged(seed, _ACCEPT_TAG), seeds.reshape(-1), 1).reshape(B, k)
    ratio = torch.where(q_d > 0, p_d / torch.clamp(q_d, min=1e-20), torch.zeros_like(p_d))
    ok = (u < ratio) & valid[:, 1:]
    m = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int64)
    q_pad = torch.cat([draft_probs, torch.zeros_like(p[:, :1])], dim=1)
    tested = torch.cat([valid[:, 1:], torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1)
    q_pad = q_pad * tested[..., None].to(q_pad.dtype)
    p_m = torch.gather(p, 1, m[:, None, None].expand(B, 1, V))[:, 0]
    q_m = torch.gather(q_pad, 1, m[:, None, None].expand(B, 1, V))[:, 0]
    res = torch.clamp(p_m - q_m, min=0.0)
    res = torch.where(res.sum(dim=-1, keepdim=True) > 0, res, p_m)
    g = sample_uniform(_tagged(seed, _RESIDUAL_TAG), streams.to(torch.int64) + m, V)
    logr = torch.where(res > 0, torch.log(res), torch.full_like(res, -float("inf")))
    res_tok = torch.argmax(logr - torch.log(-torch.log(g)), dim=-1).to(torch.int32)
    d_pad = torch.cat([draft_toks.to(torch.int32),
                       torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
    at_m = torch.arange(T, device=dev)[None] == m[:, None]
    return torch.where(at_m, res_tok[:, None], d_pad), m.to(torch.int32)


class SpeculativeFns:
    """Draft and verify steps for one (greedy, top_k) sampling config,
    owned by the TARGET engine (``ServeEngine.speculative_fns``); draft
    params ride in as arguments.

    ``draft_step`` is one single-token decode on the draft pool, which when
    sampling also returns the draft's filtered distribution;
    ``verify_step(k)`` the depth-k verify, memoized per depth (adaptive
    depth visits at most ``k`` of them): one ``decode_verify_lm`` pass over
    the target pool and the acceptance rule, leaving (tokens, accepted
    counts) on the device."""

    def __init__(self, engine, *, greedy: bool, top_k: int):
        self._eng = engine
        self._greedy = bool(greedy)
        self._top_k = int(top_k)
        self._verifies: Dict[int, Any] = {}
        self.verify_compiles = 0

    def draft_step(self, params, caches, tokens, pos, active, seed0, block_tables, seed,
                   temperature):
        eng = self._eng
        logits, caches = decode_lm(params, caches, tokens[:, None], pos, eng.cfg,
                                   compute_dtype=eng.compute_dtype, active=active,
                                   block_tables=block_tables)
        lg = logits[:, -1, :].to(torch.float32)
        new_pos = pos + active.to(torch.int32)
        if self._greedy:
            return torch.argmax(lg, dim=-1).to(torch.int32), new_pos, caches
        probs = torch.softmax(filter_logits(lg, temperature, self._top_k), dim=-1)
        nxt = sample_tokens(lg, seed0.to(torch.int64) + pos.to(torch.int64),
                            _tagged(seed, _DRAFT_TAG), temperature, self._top_k)
        return nxt, probs, new_pos, caches

    def verify_step(self, k: int):
        k = int(k)
        if k not in self._verifies:
            self._verifies[k] = self._build_verify(k)
            self.verify_compiles += 1
        return self._verifies[k]

    def _build_verify(self, k: int):
        eng, greedy, top_k = self._eng, self._greedy, self._top_k
        T = k + 1

        def _verify(params, caches, last_tok, draft_toks, draft_probs, pos, active, seed0, bt,
                    seed, temperature):
            tokens = torch.cat([last_tok[:, None], draft_toks], dim=1)
            positions = pos[:, None] + torch.arange(T, dtype=torch.int32, device=pos.device)[None]
            valid = positions <= eng.max_len - 1
            logits, caches = decode_verify_lm(params, caches, tokens, pos, eng.cfg,
                                              compute_dtype=eng.compute_dtype, active=active,
                                              valid=valid, block_tables=bt)
            if greedy:
                out, m = accept_greedy(logits, draft_toks, valid)
            else:
                out, m = accept_sampled(logits, draft_toks, draft_probs, valid,
                                        seed0.to(torch.int64) + pos.to(torch.int64), seed,
                                        temperature, top_k)
            return out, m, caches

        return _verify


class SpeculativeScheduler(Scheduler):
    """Continuous batching with a draft-k / verify-k+1 controller on the
    fully-paged tier (module docstring).  The draft owns a second pool of
    the same geometry; one ``BlockPool`` and the slot tables drive both, so
    allocation, growth, eviction, preemption and the trash-block redirect
    are shared.  Off the tier every step is the vanilla ``Scheduler.step``."""

    def __init__(self, engine, config: Optional[ServeConfig] = None, **legacy):
        if isinstance(config, int):  # legacy positional n_slots
            legacy["n_slots"] = config
            config = None
        if legacy:
            config = ServeConfig(**legacy)  # the base class would warn again; build once
        config = (config or ServeConfig()).resolve(engine)
        if config.speculative is None:
            raise ValueError("SpeculativeScheduler needs config.speculative (a SpeculativeConfig)")
        spec = config.speculative
        super().__init__(engine, config)
        self.spec_cfg = spec
        self.draft_k = max(1, int(spec.k))
        self._adaptive = bool(spec.adaptive) and self.temperature <= 0.0
        # spec_* count work performed (a preempted request's discarded rounds
        # stay counted); Completion.spec_steps / spec_tokens the delivered stream
        self.stats.update({"spec_steps": 0, "spec_row_rounds": 0, "spec_drafted": 0,
                           "spec_accepted": 0, "spec_emitted": 0, "verify_trace_compiles": 0})
        self.spec_fns: Optional[SpeculativeFns] = None
        self.draft_eng = None
        self.draft_caches = None
        self._adaptive_k: Dict[int, int] = {}  # slot -> AIMD depth recommendation
        self._slot_spec: Dict[int, Tuple[int, int]] = {}  # slot -> (rounds, tokens)
        if not speculative_eligible(engine):
            return  # inert: every step is a vanilla decode step
        from repro_torch.serve.engine import ServeEngine

        draft = spec.draft
        if not isinstance(draft, ServeEngine):
            draft = ServeEngine(engine.cfg, draft, max_len=engine.max_len,
                                compute_dtype=engine.compute_dtype, device=engine.device)
        if draft.cfg != engine.cfg:
            raise ValueError("draft must share the target's architecture (cache shapes mirror)")
        if draft.max_len != engine.max_len:
            raise ValueError(f"draft max_len={draft.max_len} != target max_len={engine.max_len}")
        self.draft_eng = draft
        self.spec_fns = engine.speculative_fns(greedy=self.temperature <= 0.0, top_k=self.top_k)
        self._verify_compiles0 = self.spec_fns.verify_compiles
        self.draft_caches = self._init_caches()  # same geometry: cfg and dtypes match

    # ------------------------------------------------------------------
    # admission / teardown hooks
    # ------------------------------------------------------------------
    def _admit_one(self, slot, idx, prompt, budget, req, blocks, start: int = 0) -> None:
        super()._admit_one(slot, idx, prompt, budget, req, blocks, start)
        if self.spec_fns is None or self._slots[slot] is None:
            # off the tier, or the request finished at admission
            return
        # mirror the admission into the DRAFT pool: the one-shot bucketed
        # prefill with the draft's params and the slot's live table row; its
        # token is dropped (the first committed token is the target's)
        bucket, batch = self._admit_batch(prompt, req)
        admit = self._fns.admit_step(bucket, self.block_size)
        _, self.draft_caches = self.draft_eng._with_backend(
            admit, self.draft_eng.params, batch, prompt.shape[0], self.draft_caches,
            self._block_tables[slot], slot, _sample_seed(idx, 0), self._seed, self._temp)
        self._adaptive_k[slot] = self.draft_k

    def _release(self, slot):
        self._adaptive_k.pop(slot, None)
        self._slot_spec.pop(slot, None)
        return super()._release(slot)

    def _finish(self, slot, reason):
        state = self._slots[slot]
        rounds, toks = self._slot_spec.get(slot, (0, 0))
        super()._finish(slot, reason)
        comp = self._completions[state.index]
        comp.spec_steps, comp.spec_tokens = rounds, toks

    # ------------------------------------------------------------------
    # the speculative loop
    # ------------------------------------------------------------------
    def _depth(self) -> int:
        """This round's draft depth: the largest live recommendation, or
        full ``draft_k`` when adaptation is off (or sampling)."""
        if not self._adaptive:
            return self.draft_k
        ks = [self._adaptive_k.get(s, self.draft_k) for s in range(self.n_slots)
              if self._slots[s] is not None]
        return max(1, min(self.draft_k, max(ks))) if ks else self.draft_k

    def step(self) -> bool:
        if self.spec_fns is None:
            return super().step()
        if self._profile is not None:
            self._profile.on_step()
        # growth twice: live rows reserve their draft windows before
        # admission spends blocks, then the fresh rows' windows
        self._grow_tables(horizon=self._depth())
        self._admit()
        depth = self._depth()
        self._grow_tables(horizon=depth)
        if self._n_live == 0:
            if not self._queue:
                self._sync_gauges()
                return False
            self.step_count += 1
            self.stats["idle_steps"] += 1
            self._sync_gauges()
            return True
        self._spec_round(depth)
        self._sync_gauges()
        return bool(self._n_live or self._queue)

    def _spec_round(self, k: int) -> None:
        fns, eng, deng = self.spec_fns, self.eng, self.draft_eng
        greedy = self.temperature <= 0.0
        t0 = time.perf_counter()
        span = self.tracer.span("verify", step=self.step_count, k=k, n_live=self._n_live)
        span.__enter__()
        # draft phase: k + 1 single-token steps on the draft pool, chained on
        # the device; the last only writes d_k's draft KV
        cur, dpos = self._tokens, self._pos
        d_toks, d_probs = [], []
        for i in range(k + 1):
            out = deng._with_backend(fns.draft_step, deng.params, self.draft_caches, cur, dpos,
                                     self._active, self._seed0, self._block_tables, self._seed,
                                     self._temp)
            if greedy:
                cur, dpos, self.draft_caches = out
            else:
                cur, probs, dpos, self.draft_caches = out
                if i < k:
                    d_probs.append(probs)
            if i < k:
                d_toks.append(cur)
        draft_toks = torch.stack(d_toks, dim=1)  # (B, k)
        out_t, m_t, self.caches = eng._with_backend(
            fns.verify_step(k), eng.params, self.caches, self._tokens, draft_toks,
            None if greedy else torch.stack(d_probs, dim=1), self._pos, self._active,
            self._seed0, self._block_tables, self._seed, self._temp)
        both = torch.cat([out_t, m_t[:, None]], dim=1).cpu().numpy()  # the round's one sync
        span.__exit__(None, None, None)
        dt = time.perf_counter() - t0
        out_np, m_np = both[:, :-1], both[:, -1]
        self.step_count += 1
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        self.stats["spec_drafted"] += k * self._n_live
        self.stats["verify_trace_compiles"] = fns.verify_compiles - self._verify_compiles0
        self._observe_step_time(dt)
        for s in range(self.n_slots):
            state = self._slots[s]
            if state is None:
                continue
            accepted = int(m_np[s])
            # commits: the accepted drafts, then the verify's correction or
            # bonus token, cut at the budget and at an EOS
            ncommit = min(accepted + 1, state.budget - len(state.out))
            toks = [int(t) for t in out_np[s, :ncommit]]
            if state.eos_id >= 0 and state.eos_id in toks:
                toks = toks[: toks.index(state.eos_id) + 1]
                ncommit = len(toks)
            state.out.extend(toks)
            state.pos += ncommit
            self._emit_tokens(state)
            self.stats["tokens_emitted"] += ncommit
            self._h_accept.observe(ncommit)
            per_tok = dt / max(1, ncommit)  # this row's per-token wall time
            for _ in range(ncommit):
                self._h_itl.observe(per_tok)
            self.stats["spec_accepted"] += min(accepted, ncommit)
            self.stats["spec_emitted"] += ncommit
            self.stats["spec_row_rounds"] += 1
            rounds, committed = self._slot_spec.get(s, (0, 0))
            self._slot_spec[s] = (rounds + 1, committed + ncommit)
            if self._adaptive:
                # AIMD: one deeper after a clean round, else what was accepted
                self._adaptive_k[s] = min(self.draft_k, k + 1) if accepted >= k \
                    else max(1, accepted)
            if toks[-1] == state.eos_id:
                self._finish(s, "eos")
            elif len(state.out) >= state.budget:
                self._finish(s, "length")
        # rollback: the device mirrors take the host's committed tokens and
        # positions; rejected positions keep stale KV the position mask hides
        tok_np = np.zeros(self.n_slots, np.int32)
        pos_np = np.zeros(self.n_slots, np.int32)
        for s, state in enumerate(self._slots):
            if state is not None:
                tok_np[s] = state.out[-1]
                pos_np[s] = state.pos
        self._tokens = self._upload(tok_np)
        self._pos = self._upload(pos_np)
