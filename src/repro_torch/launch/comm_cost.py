"""Collective wire bytes of a step (the port's counterpart of
``repro/launch/hlo.py``).

JAX reads the collectives out of the compiled per-device HLO.  The port has
no HLO: every collective of a step goes through
``distributed/collectives.py``, which, inside ``collectives.recorded()``,
keeps a ``Record`` of each call: its kind, the bytes of its RESULT, the
group size g and whether the group lies in one node.  The port runs
eagerly, so a loop's trips, remat's recompute and the backward are counted
as they run; no loop weighting is needed.  Each record's per-rank wire
bytes follow ``hlo.py``'s ring model, s the result's bytes:

    all-reduce       2·s·(g-1)/g        (reduce-scatter + all-gather phases)
    all-gather         s·(g-1)/g        (s = gathered result size)
    reduce-scatter     s·(g-1)          (input = s·g, each rank ships (g-1)/g)
    all-to-all         s·(g-1)/g

The port has no collective-permute; its keys stay at 0.  There is no
``total_bytes_tpu``: that key undoes XLA-CPU's f32 promotion of bf16
reductions, and here the wire dtype is the one given (NCCL sends bf16 as
bf16).
"""
from __future__ import annotations

from typing import Dict, Iterable

from repro_torch.distributed.collectives import Record

_KINDS = {  # the port's kind -> the HLO op name JAX's keys use
    "all_gather": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
}
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# H100 links, bytes/s a direction: NVLink 4 inside one 8-GPU node, else one
# 400 Gb/s InfiniBand port a GPU
NVLINK_BW = 450e9
IB_BW = 50e9


def wire_bytes(rec: Record) -> float:
    """Per-rank wire bytes of one collective (ring model)."""
    s, g = float(rec.result_bytes), rec.group
    if rec.kind == "all_reduce":
        return 2.0 * s * (g - 1) / g
    if rec.kind in ("all_gather", "all_to_all"):
        return s * (g - 1) / g
    if rec.kind == "reduce_scatter":
        return s * (g - 1)
    raise ValueError(f"unknown collective kind {rec.kind!r}")


def collective_bytes(records: Iterable[Record]) -> Dict[str, int]:
    """JAX's keys: ``{kind}_bytes`` (per-rank wire bytes), ``{kind}_count``
    for every HLO collective kind, and ``total_bytes``."""
    out = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for rec in records:
        k = _KINDS[rec.kind]
        out[k] += wire_bytes(rec)
        counts[k] += 1
    res: Dict[str, int] = {f"{k}_bytes": int(v) for k, v in out.items()}
    res.update({f"{k}_count": counts[k] for k in COLLECTIVES})
    res["total_bytes"] = int(sum(out.values()))
    return res


def collective_seconds(records: Iterable[Record]) -> Dict[str, float]:
    """Seconds on the wire a rank, each record at its group's link:
    ``nvlink_s`` (groups inside one node), ``ib_s`` (groups across nodes)
    and their sum ``collective_s``."""
    nv = ib = 0.0
    for rec in records:
        if rec.in_node:
            nv += wire_bytes(rec) / NVLINK_BW
        else:
            ib += wire_bytes(rec) / IB_BW
    return {"nvlink_s": nv, "ib_s": ib, "collective_s": nv + ib}
