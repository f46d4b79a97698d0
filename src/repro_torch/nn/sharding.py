"""Path-based logical-axis sharding rules (a copy of ``repro/nn/sharding.py``)
and the port's device mesh over ``torch.distributed``.

Every parameter leaf gets a tuple of *logical* axis names derived from its
path + shape (``LOGICAL_RULES``); a *profile* maps logical names to mesh
axes.  Resolution is shape-aware: a mapping that does not divide the
dimension is dropped (replicated) rather than erroring, so the same profile
works across all 10 architectures.  A spec is a tuple with one entry per
dimension, the entries of JAX's ``PartitionSpec``: None (replicated), a
mesh axis name, or a tuple of them (the dimension split over their product,
the first axis major).

Profiles
--------
``dp``       batch over (pod, data); params replicated.
``dp_tp``    + tensor parallelism: mlp/heads/vocab/expert over ``model``.
``fsdp_tp``  + ZeRO-3: the ``embed`` axis of params/optimizer over (pod, data).
``fsdp_tp_sp``  + sequence sharding of activations (long-context).

The mesh
--------
``AbstractMesh`` is a shape and axis names, enough to resolve rules.
``Mesh`` adds this process's place in it: every rank of a
``torch.distributed`` world runs the same host program (SPMD), the ranks
laid out row-major over the mesh shape, and one process group per set of
axes (made at construction, by every rank in the same order, as
``new_group`` requires).  ``with mesh:`` makes it the thread's current mesh,
as the kernel dispatch backends are per thread.  ``shard_tree`` slices this
rank's piece of every leaf: the counterpart of ``shardings_for_tree`` plus
``device_put``.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import re
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.nn.tree import is_packed

Spec = Tuple[Any, ...]


class AbstractMesh:
    """A mesh's shape and axis names, with no processes behind it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())


class _Current(threading.local):
    stack: List["Mesh"]

    def __init__(self):
        self.stack = []


_current = _Current()


def current_mesh() -> Optional["Mesh"]:
    """The thread's current mesh (``with mesh:``), or None outside one."""
    return _current.stack[-1] if _current.stack else None


def mesh_axis_size(mesh: Optional[AbstractMesh], *names: str) -> int:
    """Product of the named mesh axes that exist on ``mesh`` (1 if none)."""
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in names if a in mesh.axis_names)


# every process group's timeout: a rank whose peer died (or that reaches a
# collective its peers never call) fails inside this, not at its caller's
# time limit
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every local rank has a card of its own, gloo otherwise
    (NCCL refuses a communicator in which two ranks share a device)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


class Mesh(AbstractMesh):
    """This rank's view of a mesh over the ``torch.distributed`` world.

    The default process group must be initialized unless the mesh has one
    device.  Rank r sits at the row-major coordinates of r in ``shape``, so
    a group over a set of axes orders its members (ascending global ranks)
    row-major over those axes in mesh order: the order JAX's collectives
    number a tuple of axes in.  Every group gets GROUP_TIMEOUT."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        super().__init__(shape, axis_names)
        import torch.distributed as dist

        live = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if live else 1
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, the world has {world}")
        self.rank = dist.get_rank() if live else 0
        self.backend = dist.get_backend() if live else None
        sizes = [self.shape[a] for a in self.axis_names]
        coords, r = [], self.rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        self.coords: Dict[str, int] = dict(zip(self.axis_names, reversed(coords)))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if mesh_axis_size(self, *axes) == 1:
                    continue
                others = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    at = dict(zip(others, fixed))
                    members = []
                    for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
                        c = dict(at, **dict(zip(axes, idx)))
                        members.append(self._rank_of(c))
                    group = dist.new_group(sorted(members), timeout=GROUP_TIMEOUT)
                    if self.rank in members:
                        self._groups[axes] = group

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes) -> Any:
        """The process group over ``axes`` holding this rank (None when the
        axes multiply to 1: every collective over it is the identity)."""
        return self._groups.get(self._key(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major in the given order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            if a in self.shape:
                i = i * self.shape[a] + self.coords[a]
        return i

    def __enter__(self) -> "Mesh":
        _current.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _current.stack.pop()


# ---------------------------------------------------------------------------
# Logical rules: (path regex, logical axes per dim).  First match wins.
# Axes tuples shorter than ndim are right-padded with None.
# ---------------------------------------------------------------------------
LOGICAL_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    # embeddings
    (r"(^|/)(tok_)?embed(dings?)?(/embedding)?$", ("vocab", "embed")),
    (r"pos_embed", (None, "embed")),
    (r"lm_head/kernel$", ("embed", "vocab")),
    # attention
    (r"(q_proj|wq)/kernel$", ("embed", "heads", "head_dim")),
    (r"(k_proj|v_proj|wk|wv)/kernel$", ("embed", "kv_heads", "head_dim")),
    (r"(o_proj|wo_attn)/kernel$", ("heads", "head_dim", "embed")),
    (r"(qkv_proj)/kernel$", ("embed", "heads", "head_dim")),
    # MLA (deepseek): low-rank compressions + expansions
    (r"q_a_proj/kernel$", ("embed", None)),
    (r"q_b_proj/kernel$", (None, "heads", "head_dim")),
    (r"kv_a_proj/kernel$", ("embed", None)),
    (r"k_rope_proj/kernel$", ("embed", None)),
    (r"(kv_b_k_proj|kv_b_v_proj)/kernel$", (None, "heads", "head_dim")),
    # MoE experts: leading expert dim (MUST precede the dense-MLP rules)
    (r"experts/(wi|gate_proj|up_proj)/kernel$", ("expert", "embed", "mlp")),
    (r"experts/(wo|down_proj)/kernel$", ("expert", "mlp", "embed")),
    # shared experts: TP on d_ff only
    (r"shared/(gate_proj|up_proj)/kernel$", (None, "mlp")),
    (r"shared/down_proj/kernel$", ("mlp", None)),
    (r"router/kernel$", ("embed", None)),
    # MLP (dense)
    (r"(wi|gate_proj|up_proj|fc1|wi_0|wi_1)/kernel$", ("embed", "mlp")),
    (r"(wo|down_proj|fc2)/kernel$", ("mlp", "embed")),
    # recurrent / ssm blocks
    (r"(in_proj\w*|x_proj)/kernel$", ("embed", "mlp")),
    (r"(out_proj)/kernel$", ("mlp", "embed")),
    (r"conv1d/kernel$", (None, "mlp")),          # (width, channels)
    (r"(a_log|A_log|dt_bias|ssm_D|rg_lru/a_param)$", ("mlp",)),
    (r"rg_lru/(input_gate|a_gate)/kernel$", ("heads", None, None)),
    (r"rg_lru/(input_gate|a_gate)/bias$", ("heads", None)),
    # convnets (paper models): (kh, kw, cin, cout)
    (r"conv\d*/kernel$", (None, None, None, "mlp")),
    # norms / scalars / biases: replicate
    (r"(scale|bias|norm|ln|layernorm)", (None,)),
]

# Activation logical axes (JAX's with_sharding_constraint kinds).
ACT_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "btd": ("batch", "seq_act", "act_embed"),
    "bt": ("batch", "seq_act"),
    "btv": ("batch", "seq_act", "vocab_act"),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved rules for one (mesh, profile)."""

    mesh: AbstractMesh
    axis_map: Dict[str, Any]  # logical name -> mesh axis | tuple | None

    def logical_axes_for(self, path: str, shape: Sequence[int]) -> Tuple[Optional[str], ...]:
        # Packed (quantized) leaves flatten as <param>/0 (int8 words) and
        # <param>/1 (exponent): match the rules against the parent path.
        path = re.sub(r"/[01]$", "", path)
        # Layer stacks carry a leading L dim: left-pad the matched axes with
        # None so they align to the right.
        stacked = bool(re.search(r"(^|/)(layers|blocks|units)\d*/", path))
        for pat, axes in LOGICAL_RULES:
            if re.search(pat, path):
                ax = tuple(axes)
                if stacked and len(shape) == len(ax) + 1:
                    ax = (None,) + ax
                ax = ax[: len(shape)]
                return ax + (None,) * (len(shape) - len(ax))
        return (None,) * len(shape)

    def pspec_for(self, path: str, shape: Sequence[int]) -> Spec:
        logical = self.logical_axes_for(path, shape)
        spec: List[Any] = []
        used: set = set()
        for dim, name in zip(shape, logical):
            mapped = self.axis_map.get(name) if name else None
            if mapped is None:
                spec.append(None)
                continue
            axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            # drop axes already used by an earlier dim of this leaf
            axes = tuple(a for a in axes if a not in used)
            size = math.prod(self.mesh.shape[a] for a in axes) if axes else 1
            if not axes or size <= 1 or dim % size != 0:
                # shape-aware fallback: try progressively shorter prefixes
                ok = ()
                for k in range(len(axes), 0, -1):
                    sz = math.prod(self.mesh.shape[a] for a in axes[:k])
                    if dim % sz == 0 and sz > 1:
                        ok = axes[:k]
                        break
                axes = ok
            if axes:
                used.update(axes)
                spec.append(axes[0] if len(axes) == 1 else tuple(axes))
            else:
                spec.append(None)
        return tuple(spec)

    def act_pspec(self, kind: str) -> Spec:
        return tuple(_entry(self.axis_map.get(name) if name else None) for name in ACT_RULES[kind])


def _entry(mapped):
    """A spec entry as ``PartitionSpec`` keeps it: one axis as its name."""
    if isinstance(mapped, tuple) and len(mapped) <= 1:
        return mapped[0] if mapped else None
    return mapped


def _present(mesh: AbstractMesh, *names: str) -> Tuple[str, ...]:
    return tuple(n for n in names if n in mesh.axis_names)


def _profile_axis_map(profile: str, mesh: AbstractMesh) -> Dict[str, Any]:
    batch = _present(mesh, "pod", "data")
    batch = batch if batch else None
    base: Dict[str, Any] = {
        "batch": batch,
        "vocab": None,
        "embed": None,
        "mlp": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "expert": None,
        "seq_act": None,
        "act_embed": None,
        "vocab_act": None,
    }
    if profile == "dp":
        return base
    if profile in ("dp_tp", "fsdp_tp", "fsdp_tp_sp", "tp"):
        base.update(
            {
                "vocab": "model",
                "mlp": "model",
                "heads": "model",
                "kv_heads": "model",
                "expert": "model",
                "vocab_act": "model",
            }
        )
    if profile in ("fsdp_tp", "fsdp_tp_sp"):
        fsdp = _present(mesh, "pod", "data")
        base["embed"] = fsdp if fsdp else None
        # 2-D expert sharding: E over (data × model); the divisibility
        # fallback keeps 1-D sharding when E % (d·m) != 0
        base["expert"] = _present(mesh, "data", "model") or "model"
    if profile == "fsdp_tp_sp":
        base["seq_act"] = "model"
    if profile == "tp":
        base["batch"] = None
    return base


PROFILES = ("dp", "dp_tp", "fsdp_tp", "fsdp_tp_sp", "tp")


def make_rules(mesh: AbstractMesh, profile: str) -> ShardingRules:
    if profile not in PROFILES:
        raise ValueError(f"unknown sharding profile {profile!r}; options: {PROFILES}")
    return ShardingRules(mesh=mesh, axis_map=_profile_axis_map(profile, mesh))


class PackedSpec(NamedTuple):
    """A ``Packed`` leaf's specs: its words' and its exponent's."""

    words: Spec
    f: Spec


def _leaf_specs(rules: ShardingRules, path: str, leaf: Any):
    """A leaf's spec; a ``Packed`` leaf's is a ``PackedSpec``, resolved at
    JAX's ``<path>/0`` and ``<path>/1``."""
    if is_packed(leaf):
        return PackedSpec(rules.pspec_for(f"{path}/0", tuple(leaf.data.shape)),
                          rules.pspec_for(f"{path}/1", tuple(leaf.f.shape)))
    return rules.pspec_for(path, tuple(getattr(leaf, "shape", ())))


def _map_paths(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts, NamedTuples (a ``TrainState``),
    lists and tuples, with the JAX package's path names: dict keys, field
    names, indices, and a ``SymogState`` as its one child ``<path>/0``."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, join(k)) for k, v in tree.items()}
    if tree is None:
        return None
    if type(tree).__name__ == "SymogState":
        return type(tree)(f=_map_paths(fn, tree.f, join(0)), mask=tree.mask)
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_map_paths(fn, v, join(k)) for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def pspec_tree_for_params(rules: ShardingRules, params: Any) -> Any:
    """A tree of specs matching ``params``' structure (a ``Packed`` leaf
    gets a ``PackedSpec``).  Takes a whole
    ``TrainState`` too; a leaf without a shape (a step count) gets ()."""
    return _map_paths(lambda p, x: _leaf_specs(rules, p, x), params)


def slice_for(mesh: Mesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's piece of a full (logical) tensor under ``spec``: a copy,
    so the full tensor can be freed."""
    out = x
    for d, entry in enumerate(spec):
        n = 1 if entry is None else mesh_axis_size(
            mesh, *((entry,) if isinstance(entry, str) else entry))
        if n == 1:
            continue
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split {n} ways ({spec})")
        step = out.shape[d] // n
        out = out.narrow(d, mesh.axis_index(entry) * step, step)
    return out.clone() if out is not x else out


def shard_tree(rules: ShardingRules, mesh: Mesh, tree: Any,
               spec_fn: Optional[Callable[[str, Tuple[int, ...], Spec], Spec]] = None) -> Any:
    """This rank's piece of every leaf of ``tree`` under ``rules``: each
    dimension a spec entry names is cut to this rank's slice (JAX places
    the same slices with ``shardings_for_tree`` + ``device_put``).
    ``spec_fn(path, shape, spec)`` may replace a leaf's rule spec (a
    ``Packed`` leaf's words and exponent are asked for at ``<path>/0`` and
    ``<path>/1``).  Leaves without a shape pass through; a whole
    ``TrainState`` is walked with JAX's path names."""

    def spec(path, shape):
        s = rules.pspec_for(path, shape)
        return spec_fn(path, shape, s) if spec_fn is not None else s

    def one(path, leaf):
        from repro_torch.core.packing import Packed

        if is_packed(leaf):
            return Packed(data=slice_for(mesh, leaf.data, spec(f"{path}/0", tuple(leaf.data.shape))),
                          n_bits=leaf.n_bits,
                          f=slice_for(mesh, leaf.f, spec(f"{path}/1", tuple(leaf.f.shape))))
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return slice_for(mesh, leaf, spec(path, tuple(leaf.shape)))

    return _map_paths(one, tree)
