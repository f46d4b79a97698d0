"""Elastic scaling: re-mesh a checkpoint onto another rank count (the
port's counterpart of ``repro/distributed/elastic.py``).

The checkpoint format is mesh-independent (full logical arrays per leaf,
written by rank 0).  ``reshard_plan`` computes, for a new mesh, the spec
every TrainState leaf restores into; ``CheckpointManager.restore(mesh=,
rules=)`` slices each rank's piece.  Growing or shrinking the world is
therefore: re-run the launcher with the new mesh — nothing else changes.
"""
from __future__ import annotations

from typing import Any

from repro_torch.nn.sharding import AbstractMesh, make_rules, pspec_tree_for_params


def reshard_plan(train_state_like: Any, mesh: AbstractMesh, profile: str) -> Any:
    """Tree of specs (matching ``train_state_like``) for the new mesh —
    params / opt-state leaves shard by the profile rules, everything else
    (scalars, schedules) replicates."""
    return pspec_tree_for_params(make_rules(mesh, profile), train_state_like)
