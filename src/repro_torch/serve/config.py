"""The serving configuration object and the engine's capability report
(mirrors ``repro/serve/config.py``, reduced to the knobs this port serves:
greedy or sampled decoding on the paged pool)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

from repro_torch.models.lm import PAGED_CACHE_LEAVES, scan_groups


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """n_slots    — decode slot-table size; 0 resolves to min(len(requests), 8);
    temperature   — sampling temperature (<= 0: greedy);
    top_k         — top-k sampling cutoff (0: off);
    seed          — base seed of the (request, step)-keyed sampling streams;
    block_size    — tokens per paged KV block;
    n_blocks      — pool capacity in blocks (0: n_slots x ceil(max_len/block))."""

    n_slots: int = 0
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    block_size: int = 16
    n_blocks: int = 0

    def __post_init__(self):
        if self.n_slots < 0:
            raise ValueError(f"n_slots must be >= 0 (0 = auto), got {self.n_slots}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.n_blocks < 0:
            raise ValueError(f"n_blocks must be >= 0 (0 = dense-equivalent), got {self.n_blocks}")

    def resolve(self, engine=None, requests: Sequence[Any] = ()) -> "ServeConfig":
        """The explicit copy a Scheduler is built from: ``n_slots=0`` becomes
        min(len(requests), 8), or 8 with no requests."""
        n = self.n_slots
        if not n:
            n = max(1, min(len(requests), 8)) if len(requests) else 8
        return dataclasses.replace(self, n_slots=n)


@dataclasses.dataclass(frozen=True)
class Capability:
    """One structural-eligibility verdict: truthy iff supported; ``reason``
    says what blocks the feature when not."""

    supported: bool
    reason: str = ""

    def __bool__(self) -> bool:
        return self.supported


def _tier_reasons(engine) -> list:
    """Why this engine misses the fully-paged tier (empty when it holds):
    every cache leaf of every group must page into the block pool, so MoE
    capacity coupling and MLA's compressed cache keep a model off it."""
    cfg = engine.cfg
    r = []
    if cfg.family != "decoder":
        r.append(f"family '{cfg.family}' is not an all-attention decoder")
    if cfg.moe:
        r.append("MoE capacity competition couples tokens across the batch")
    if cfg.use_mla:
        r.append("MLA's compressed cache has no tail-prefill trace")
    if not r:
        specs = engine.prefill_cache_specs()
        if not all(g.paged[0] and name in PAGED_CACHE_LEAVES
                   for g in scan_groups(cfg) for name in specs[g.name]["sub0"]):
            r.append("non-paged per-row cache state")
    return r


def capabilities(engine) -> Dict[str, Capability]:
    """Structural serving capabilities of ``engine`` in the port, with
    reasons.

    fully_paged     — every cache leaf of every group pages into the block
                      pool (no MoE, no MLA): the tier on which admissions to
                      a quantized pool run the tail-prefill trace;
    prefix_cache    — not ported yet (the radix cache and copy-on-write);
    chunked_prefill — not ported yet (chunks of the tail-prefill trace);
    speculative     — not ported yet (draft / verify rounds);
    ep_moe          — the port has no expert parallelism: MoE layers run
                      on one card."""
    strict = _tier_reasons(engine)
    later = "not ported yet"
    return {
        "fully_paged": Capability(not strict, "; ".join(strict)),
        "prefix_cache": Capability(False, later),
        "chunked_prefill": Capability(False, later),
        "speculative": Capability(False, later),
        "ep_moe": Capability(False, "no MoE layers" if not engine.cfg.moe
                             else "the port has no expert parallelism: MoE layers run on one "
                                  "card"),
    }
