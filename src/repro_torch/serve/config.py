"""The serving configuration objects and the engine's capability report
(mirrors ``repro/serve/config.py``: greedy or sampled decoding on the
paged pool, the prefix cache, chunked prefill, self-speculative decoding,
streaming callbacks and telemetry).

Cross-feature conflicts are refused at construction, as in the JAX
package: ``prefix_cache`` with ``speculative`` (the draft pool does not
share blocks under the radix index), and ``speculative`` with
``prefill_chunk`` (the draft pool mirrors the target's admission one-shot)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

from repro_torch.models.lm import PAGED_CACHE_LEAVES, scan_groups


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Observability knobs of one scheduler, as in the JAX package.

    Metrics (the registry behind ``Scheduler.stats`` plus gauges and
    latency histograms) are always on: host-side integer arithmetic beside
    a device-bound loop, with no device sync of their own.  The knobs gate
    the optional layers:

    trace           — record step spans and instants into the ring
                      tracer (off: the scheduler holds ``NULL_TRACER``);
    trace_capacity  — ring capacity shared by the tracer and the
                      scheduler's ``events`` / ``admit_times`` logs: all
                      three keep the most recent ``trace_capacity`` records;
    profile_dir     — non-empty arms a ``torch.profiler`` capture window
                      (a Chrome trace in this directory) over the first
                      ``profile_steps`` serve steps;
    profile_steps   — capture-window length in serve steps;
    straggler_warn  — warn once (one line on stderr) when the step-time
                      monitor's straggler fraction exceeds this after
                      warmup; 0 disables the warning (the gauges stay).
    """

    trace: bool = False
    trace_capacity: int = 4096
    profile_dir: str = ""
    profile_steps: int = 8
    straggler_warn: float = 0.25

    def __post_init__(self):
        if self.trace_capacity < 1:
            raise ValueError(f"trace_capacity must be >= 1, got {self.trace_capacity}")
        if self.profile_steps < 1:
            raise ValueError(f"profile_steps must be >= 1, got {self.profile_steps}")
        if not 0.0 <= self.straggler_warn <= 1.0:
            raise ValueError(
                f"straggler_warn is a fraction in [0, 1] (0 = off), got {self.straggler_warn}"
            )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """n_slots    — decode slot-table size; 0 resolves to min(len(requests), 8);
    temperature   — sampling temperature (<= 0: greedy);
    top_k         — top-k sampling cutoff (0: off);
    seed          — base seed of the (request, step)-keyed sampling streams;
    block_size    — tokens per paged KV block;
    n_blocks      — pool capacity in blocks (0: n_slots x ceil(max_len/block));
    prefix_cache  — radix prefix cache over the pool (inert off the
                    fully-paged tier);
    speculative   — a ``serve.SpeculativeConfig``: draft-k / verify-k+1
                    self-speculative decoding (inert off its tier);
    prefill_chunk — > 0 splits admissions into tail-prefill chunks of at
                    most this many tokens, one per step beside the live
                    decode (inert off the fully-paged tier);
    on_token      — default per-token streaming callback
                    ``cb(request_index, token)``, fired as each token is
                    committed (``Scheduler.submit`` overrides it per
                    request); a preemption replay streams nothing twice;
    time_admissions — record each admission's wall time
                    (``Scheduler.admit_times``);
    telemetry     — a ``TelemetryConfig``: span tracing, ring capacities,
                    the profiler window, the straggler warning."""

    n_slots: int = 0
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    block_size: int = 16
    n_blocks: int = 0
    prefix_cache: bool = False
    speculative: Optional[Any] = None  # serve.SpeculativeConfig
    prefill_chunk: int = 0
    on_token: Optional[Callable[[int, int], None]] = None
    time_admissions: bool = False
    telemetry: TelemetryConfig = TelemetryConfig()

    def __post_init__(self):
        if not isinstance(self.telemetry, TelemetryConfig):
            raise ValueError(
                f"telemetry must be a TelemetryConfig, got {type(self.telemetry).__name__}"
            )
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
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 (0 = one-shot), got {self.prefill_chunk}")
        if self.prefix_cache and self.speculative is not None:
            raise ValueError("speculative decoding and prefix_cache are mutually exclusive")
        if self.speculative is not None and self.prefill_chunk:
            raise ValueError("speculative decoding and prefill_chunk are mutually exclusive "
                             "(the draft pool mirrors admission prefills one-shot)")

    def resolve(self, engine=None, requests: Sequence[Any] = ()) -> "ServeConfig":
        """The explicit copy a Scheduler is built from: ``n_slots=0`` becomes
        min(len(requests), 8), or 8 with no requests (an open-ended async
        engine)."""
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


def _tier_reasons(engine, *, allow_mla: bool = False) -> list:
    """Why this engine misses the fully-paged tier (empty when it holds):
    every cache leaf of every group must page into the block pool, so MoE
    capacity coupling keeps a model off it, and MLA's compressed cache too
    unless ``allow_mla`` (the speculative verify has an MLA form; the tail
    prefill has none)."""
    cfg = engine.cfg
    r = []
    if cfg.family != "decoder":
        r.append(f"family '{cfg.family}' is not an all-attention decoder")
    if cfg.moe:
        r.append("MoE capacity competition couples tokens across the batch")
    if cfg.use_mla and not allow_mla:
        r.append("MLA's compressed cache has no tail-prefill trace")
    if not r:
        specs = engine.prefill_cache_specs()
        if not all(paged and name in PAGED_CACHE_LEAVES
                   for g in scan_groups(cfg) for j, paged in enumerate(g.paged)
                   for name in specs[g.name][f"sub{j}"]):
            r.append("non-paged per-row cache state (recurrent/SSD/ring/cross-kv)")
    return r


def capabilities(engine) -> Dict[str, Capability]:
    """Structural serving capabilities of ``engine`` in the port, with
    reasons, as the JAX package reports them.

    fully_paged     — every cache leaf of every group pages into the block
                      pool (no MoE, no MLA): the tier on which admissions to
                      a quantized pool run the tail-prefill trace;
    prefix_cache    — radix prefix sharing would share (the fully-paged tier);
    chunked_prefill — ``prefill_chunk`` would chunk (the same tier);
    speculative     — draft / verify rounds would run (the tier with MLA
                      allowed: the verify has an absorbed MLA form);
    ep_moe          — the port has no expert parallelism: MoE layers run
                      on one card."""
    strict = _tier_reasons(engine)
    with_mla = _tier_reasons(engine, allow_mla=True)
    full = Capability(not strict, "; ".join(strict))
    return {
        "fully_paged": full,
        "prefix_cache": full,
        "chunked_prefill": full,
        "speculative": Capability(not with_mla, "; ".join(with_mla)),
        "ep_moe": Capability(False, "no MoE layers" if not engine.cfg.moe
                             else "the port has no expert parallelism: MoE layers run on one "
                                  "card"),
    }
