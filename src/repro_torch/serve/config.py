"""The serving configuration object (mirrors ``repro/serve/config.py``,
reduced to the knobs this slice serves: greedy decoding on the paged pool)."""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """n_slots    — decode slot-table size; 0 resolves to min(len(requests), 8);
    temperature   — sampling temperature; only greedy (<= 0) is ported;
    top_k         — top-k cutoff (0: off; read only by sampling);
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
        if self.temperature > 0:
            raise NotImplementedError(
                "sampled decoding is not ported yet (ROADMAP 'Next' item: sampling); "
                "the port serves greedy decoding (temperature=0)"
            )
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
