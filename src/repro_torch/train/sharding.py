"""Tensor-parallel and FSDP placement of training state (the port's
counterpart of ``repro/launch/shardings.py::state_shardings`` plus
``device_put``).

``train_layout(cfg, mesh)`` decides, from the whole config's param shapes
and ``cfg.sharding_profile``'s rules, where every param lives, the same way
a serving engine does (``serve.sharding.make_tp_plan`` / ``local_config``):

  * a piece (a layer's attention, its MLP, an SSD or RG-LRU block, the
    embedding, the head) splits over the ``model`` axis only when all of
    its split leaves do (``serve.sharding.leaf_spec``: a column-parallel
    bias with its outputs; a row-parallel bias, mamba2's B / C
    projections, conv kernel and norm scale whole, the last four entering
    through Megatron's f); expert stacks split their expert axis over
    ``cfg.ep_axes`` under EP; the rest is replicated over ``model``
    (``TPPlan``);
  * under an FSDP profile (``fsdp_tp``) every decoder leaf whose ``embed``
    dimension the rules put on the (pod, data) axes keeps that split as
    well (ZeRO-3): the model code joins it where it is used
    (``models.layers.fsdp_gather``) and the backward reduce-scatters its
    grad.  Expert stacks and the other families stay whole over the data
    axes.

The momentum takes its param's spec; SYMOG's f, found on the whole leaf
before the cut, is replicated, or split with its experts for an expert
stack.  ``shard_train_state`` cuts a whole ``TrainState`` to this rank's
pieces; the layout then answers the questions whose answer spans ranks:
``numel`` (a leaf's whole count, M_l of λ_eff = λ·2/M_l) and
``sum_over_shards`` (a sum of per-leaf partials that counts every element
of the logical tree once, for the clip's norm and the metrics).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TPPlan
from repro_torch.nn.sharding import Mesh, ShardingRules, Spec, make_rules, shard_tree
from repro_torch.nn.tree import flatten_with_paths
from repro_torch.serve.sharding import (
    _piece,
    expert_spec,
    leaf_spec,
    local_config,
    make_tp_plan,
    piece_on,
)

DATA_AXES = ("pod", "data")


@functools.lru_cache(maxsize=8)
def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """{path: shape} of ``init_lm(cfg)``'s params, from an init that
    allocates nothing (``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.lm import init_lm

    with FakeTensorMode():
        tree = init_lm(0, cfg, device="cpu")
    return {p: tuple(t.shape) for p, t in flatten_with_paths(tree)}


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


@dataclasses.dataclass(eq=False)
class TrainLayout:
    """Where every leaf of a ``TrainState`` lives on ``mesh`` (see the module
    docstring).  ``cfg`` is the per-rank config the model code runs on,
    ``global_cfg`` the whole one; ``specs`` and ``shapes`` are by param
    path."""

    mesh: Mesh
    rules: ShardingRules
    plan: TPPlan
    cfg: ModelConfig
    global_cfg: ModelConfig
    shapes: Dict[str, Tuple[int, ...]]
    specs: Dict[str, Spec]
    data_axes: Tuple[str, ...]
    n_data: int
    data_index: int

    def numel(self, path: str) -> int:
        """The whole leaf's element count."""
        return math.prod(self.shapes[path])

    def split_axes(self, path: str) -> Tuple[str, ...]:
        """The mesh axes a param's shards span, in mesh order (() replicated)."""
        used = {a for e in self.specs[path] for a in _axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def sum_over_shards(self, parts: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Σ of per-leaf partials (``{param path: 0-d}``, this rank's
        shards): the partials of the leaves split over the same axes are
        added, each such sum is all-reduced over those axes (fp32), and the
        sums are added in a fixed order, so every rank gets the same value
        and a replicated leaf counts once."""
        from repro_torch.distributed.collectives import all_reduce

        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        for path, v in parts.items():
            key = self.split_axes(path)
            v = v.to(torch.float32)
            by_axes[key] = v if key not in by_axes else by_axes[key] + v
        total = None
        for key in sorted(by_axes):
            s = by_axes[key]
            if key:
                s = all_reduce(s, self.mesh.group(key))
            total = s if total is None else total + s
        return total if total is not None else torch.zeros(())

    def _param_of(self, path: str) -> Optional[str]:
        parts = path.split("/")
        for i in range(len(parts)):
            cand = "/".join(parts[i:])
            if cand in self.shapes:
                return cand
        return None

    def spec_fn(self, path: str, shape: Tuple[int, ...], spec: Spec = ()) -> Spec:
        """``shard_tree``'s ``spec_fn`` over a ``TrainState`` (or a params
        tree): a param or its momentum takes the param's spec, a SYMOG f
        (``symog/0/...``) its expert split; reads only the path and, for an
        f, the rank of ``shape``, so a shard's own shape gives its spec too."""
        param = self._param_of(path)
        if param is None:
            return ()
        if path.startswith("symog/"):
            if len(shape) == 0 or _piece(param) != "experts":
                return ()
            # one f per leading (layer, expert) index: the expert axis is last
            return expert_spec(self.global_cfg, self.plan, self.shapes[param][:-2],
                               len(shape) - 1)
        return self.specs[param]


def _param_spec(cfg: ModelConfig, plan: TPPlan, rules: ShardingRules, path: str,
                shape: Tuple[int, ...], fsdp_axes: Tuple[str, ...]) -> Spec:
    piece = _piece(path)
    if piece == "experts":
        return expert_spec(cfg, plan, shape, len(shape) - 3)
    model = ()
    if piece is not None and piece_on(plan).get(piece, False):
        model = leaf_spec(rules, path, shape) or ()
    out = []
    for d, e in enumerate(rules.pspec_for(path, shape)):
        axes = _axes(e)
        if d < len(model) and model[d] == "model":
            out.append("model")
        elif fsdp_axes and axes == fsdp_axes:  # a partial fallback stays whole
            out.append(fsdp_axes[0] if len(fsdp_axes) == 1 else fsdp_axes)
        else:
            out.append(None)
    return tuple(out) if any(e is not None for e in out) else ()


@functools.lru_cache(maxsize=16)
def _cached_layout(cfg: ModelConfig, mesh: Mesh, profile: str) -> TrainLayout:
    rules = make_rules(mesh, profile)
    shapes = param_shapes(cfg)
    metas = {p: torch.empty(s, device="meta") for p, s in shapes.items()}
    plan = make_tp_plan(cfg, metas, mesh, rules)
    fsdp_axes = _axes(rules.axis_map.get("embed")) if cfg.family == "decoder" else ()
    if math.prod(mesh.shape[a] for a in fsdp_axes) <= 1:
        fsdp_axes = ()
    specs = {p: _param_spec(cfg, plan, rules, p, s, fsdp_axes) for p, s in shapes.items()}
    fsdp = {}
    n_fsdp = math.prod(mesh.shape[a] for a in fsdp_axes)
    for p, spec in specs.items():
        dims = [d for d, e in enumerate(spec) if e is not None and _axes(e) == fsdp_axes]
        if dims:
            (d,) = dims  # one embed dim a leaf
            fsdp[p] = (d, shapes[p][d] // n_fsdp)
    data_axes = tuple(a for a in mesh.axis_names if a in DATA_AXES)
    plan = dataclasses.replace(plan, dp_axes=data_axes, fsdp=fsdp or None,
                               fsdp_group=mesh.group(fsdp_axes) if fsdp else None)
    n_data = math.prod(mesh.shape[a] for a in data_axes) if data_axes else 1
    return TrainLayout(mesh=mesh, rules=rules, plan=plan, cfg=local_config(cfg, plan),
                       global_cfg=cfg, shapes=shapes, specs=specs, data_axes=data_axes,
                       n_data=n_data, data_index=mesh.axis_index(data_axes))


def train_layout(cfg: ModelConfig, mesh: Mesh, profile: str = "") -> TrainLayout:
    """The layout of ``cfg``'s training state on ``mesh`` under ``profile``
    (default ``cfg.sharding_profile``); made once per (config, mesh,
    profile).  Every family takes a model axis > 1: a piece that cannot
    split stays whole (``make_tp_plan``)."""
    return _cached_layout(cfg, mesh, profile or cfg.sharding_profile)


def shard_train_state(state: Any, layout: TrainLayout) -> Any:
    """This rank's pieces of a whole ``TrainState`` (params, momentum,
    SYMOG's f; ``symog_init`` ran on the whole leaves) or params tree under
    ``layout``: a split leaf's piece is a copy, a replicated leaf the whole
    one itself (the fused update writes it in place)."""
    return shard_tree(layout.rules, layout.mesh, state, layout.spec_fn)
