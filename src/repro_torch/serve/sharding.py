"""Mesh placement for the serving stack (the port's counterpart of
``repro/serve/sharding.py``).

One place decides where every serving array lives on a ``(data, model)``
mesh:

  * packed/float **param** leaves follow the repo's path-based logical
    rules (``nn/sharding.py``) and the plan's own slices (``leaf_spec``:
    biases, mamba2's shared B / C / conv / norm), read by the
    tensor-parallel executor's plan (``make_tp_plan``): a piece (a layer's
    attention, its MLP, an SSD or RG-LRU block, the embedding, the head,
    the expert stacks) shards only when all of its split leaves do, else it
    replicates whole — the model code runs on local shapes, so a piece is
    either sharded end to end or not at all;
  * paged KV **pool data leaves** shard their KV-head axis over the rules'
    ``kv_heads`` mapping — each model shard holds its head slice of every
    physical block, so pool capacity scales with the mesh;
  * **scale leaves** (per-(block, KV-head) SYMOG exponents), **block
    tables** and all resident per-slot state are **replicated**: every
    rank runs the same scheduler (SPMD), so the host bookkeeping is the
    same on every rank;
  * MLA rank-space pools (``c_kv``/``k_rope`` — no KV-head axis) replicate.

The ``data`` axis of a serving mesh replicates: every rank runs the same
batch (2-D expert parallelism still splits the experts over it).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import TPPlan
from repro_torch.nn.sharding import Mesh, ShardingRules, Spec, mesh_axis_size
from repro_torch.nn.tree import flatten_with_paths, is_packed


def pool_head_shards(rules: ShardingRules, shape: Sequence[int], axis: int) -> int:
    """How many ways a paged data-pool leaf's KV-head axis shards under
    ``rules`` (1 = replicated).  ``shape`` is the pool leaf shape —
    ``(n_blocks, block, K, hd)`` at ``axis``=0, one leading layer dim at
    ``axis``=1; MLA rank-space leaves carry a single feature dim and never
    shard.  Applies the same divisibility fallback as the param rules."""
    feat = tuple(shape[axis + 2:])
    if len(feat) != 2:
        return 1  # MLA c_kv/k_rope: (r,) — no KV-head axis
    mapped = rules.axis_map.get("kv_heads")
    if mapped is None:
        return 1
    axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
    size = math.prod(rules.mesh.shape[a] for a in axes)
    return size if size > 1 and feat[0] % size == 0 else 1


def pool_pspec(rules: ShardingRules, shape: Sequence[int], axis: int) -> Spec:
    """Spec for one paged data-pool leaf: KV-head axis over the
    ``kv_heads`` mesh mapping when it divides, replicated (()) otherwise."""
    if pool_head_shards(rules, shape, axis) == 1:
        return ()
    mapped = rules.axis_map["kv_heads"]
    spec = [None] * len(shape)
    spec[axis + 2] = mapped if isinstance(mapped, str) else tuple(mapped)
    return tuple(spec)


def pool_bytes_per_device(engine, block_size: int, n_blocks: int, *,
                          model_shards: int = 0) -> Tuple[int, int]:
    """(total pool bytes, per-device resident pool bytes) for ``engine``'s
    paged-pool geometry — data leaves divided by their head-shard count,
    scale leaves counted replicated.  With ``model_shards`` > 0 the
    head-shard count is modeled for a hypothetical mesh of that size
    instead of the engine's own plan.  Shapes come from the engine's whole
    (unsharded) config, as JAX's come from its global ``eval_shape``."""
    from repro_torch.models.lm import PAGED_CACHE_LEAVES, init_caches, scan_groups

    cfg = getattr(engine, "global_cfg", engine.cfg)
    specs = init_caches(cfg, 1, engine.max_len, engine.compute_dtype, device="meta",
                        prefill=True)
    qbits = engine.kv_quant_bits
    n_phys = n_blocks + 1
    plan = getattr(engine, "tp", None)
    total = per_dev = 0
    for g in scan_groups(cfg):
        axis = 1 if g.stacked else 0
        for j in range(len(g.unit)):
            for name, sd in specs[g.name][f"sub{j}"].items():
                if not (g.paged[j] and name in PAGED_CACHE_LEAVES):
                    continue
                feat = tuple(sd.shape[axis + 2:])
                lead = tuple(sd.shape[:axis])
                if qbits and len(feat):
                    if qbits == 4:
                        feat = feat[:-1] + (feat[-1] // 2,)
                    data_b = math.prod(lead + (n_phys, block_size) + feat)  # int8 words
                    scale_b = math.prod(lead + (n_phys,) + feat[:-1]) * 4
                else:
                    data_b = math.prod(lead + (n_phys, block_size) + feat) * sd.dtype.itemsize
                    scale_b = 0
                if model_shards:
                    K = feat[0] if len(feat) == 2 else 1
                    shards = model_shards if (len(feat) == 2 and K % model_shards == 0) else 1
                else:
                    shards = plan.size if (plan is not None and plan.attn and len(feat) == 2) else 1
                total += data_b + scale_b
                per_dev += data_b // shards + scale_b
    return total, per_dev


# ---------------------------------------------------------------------------
# the tensor-parallel executor's plan and its param slices
# ---------------------------------------------------------------------------
_PIECES = (
    ("attn", re.compile(r"(^|/)(cross_)?attn/")),
    ("mlp", re.compile(r"(^|/)mlp/")),
    ("experts", re.compile(r"(^|/)moe/experts/")),
    ("shared", re.compile(r"(^|/)moe/shared/")),
    ("ssd", re.compile(r"(^|/)ssd/")),
    ("rglru", re.compile(r"(^|/)rglru/")),
    ("embed", re.compile(r"^embed/")),
    ("head", re.compile(r"^lm_head/")),
)
# Leaves the plan places itself, not the rules (which replicate every bias,
# and split every SSD projection and its conv over 'model'):
#  * a column-parallel bias splits with its outputs (dim -2: q / k / v's
#    heads; dim -1: fc1 / gate / up's d_ff);
#  * a row-parallel bias stays whole, added once after the reduce
#    (``layers.split_row_bias``);
#  * mamba2's B / C projections (one group, read by every head), its conv
#    kernel over [x, B, C] and its gated norm's scale stay whole: each rank
#    slices its channels inside the forward (``models.ssd``) and, training,
#    enters them through Megatron's f;
#  * a packed mamba2 ``in_proj_dt`` whose words do not split whole over the
#    ranks (a 2-bit word holds 4 heads' columns) stays whole the same way:
#    each rank takes its heads' columns of the output (``models.ssd``), as
#    JAX's rules replicate that one leaf (``repro/nn/sharding.py:154-161``).
_COL_BIAS = ((re.compile(r"(^|/)(q_proj|k_proj|v_proj)/bias$"), -2),
             (re.compile(r"(^|/)(fc1|gate_proj|up_proj)/bias$"), -1))
_ROW_BIAS = re.compile(r"(^|/)(o_proj|down_proj|fc2)/bias$")
_SSD_WHOLE = re.compile(r"(^|/)ssd/(in_proj_B/kernel|in_proj_C/kernel|conv1d/kernel|norm/scale)$")
_SSD_DT = re.compile(r"(^|/)ssd/in_proj_dt/kernel/0$")  # packed words: whole when they do not split


def _piece(path: str) -> Optional[str]:
    if path.startswith("mtp/") and not path.startswith("mtp/block/"):
        return None  # the MTP module's norms and projection (its block, which
    # only the training loss runs, splits as a layer does)
    for name, pat in _PIECES:
        if pat.search(path):
            return name
    return None


def _model_entries(spec: Spec) -> Tuple[Any, ...]:
    """The spec with every mesh axis but 'model' dropped (serving keeps the
    data axis replicated)."""
    out = []
    for e in spec:
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        out.append("model" if "model" in axes else None)
    return tuple(out)


def _paths_and_shapes(params):
    for path, leaf in flatten_with_paths(params):
        if is_packed(leaf):
            yield f"{path}/0", tuple(leaf.data.shape)
            yield f"{path}/1", tuple(leaf.f.shape)
        elif hasattr(leaf, "shape"):
            yield path, tuple(leaf.shape)


def leaf_spec(rules: ShardingRules, path: str, shape: Tuple[int, ...]) -> Optional[Spec]:
    """The 'model' entries a param leaf (a ``Packed`` leaf's words at
    ``<param>/0``) takes when its piece splits: None for a leaf that stays
    whole on every rank (one the rules never split, and the plan's own
    whole leaves above); a spec without 'model' for one that cannot split
    on this mesh (its piece then stays whole)."""
    param = re.sub(r"/0$", "", path)
    if _ROW_BIAS.search(param) or _SSD_WHOLE.search(param):
        return None
    m = mesh_axis_size(rules.mesh, "model")
    if _SSD_DT.search(path) and shape[-1] % m:
        return None
    for pat, dim in _COL_BIAS:
        if pat.search(param):
            out = [None] * len(shape)
            if shape[dim] % m == 0:
                out[len(shape) + dim] = "model"
            return tuple(out)
    if not any(_model_entries((rules.axis_map.get(n) if n else None,))[0]
               for n in rules.logical_axes_for(path, shape)):
        return None
    return _model_entries(rules.pspec_for(path, shape))


def _whole_key(piece: str, path: str) -> str:
    """A whole leaf's name under its piece's key (``q_norm/scale`` under
    ``attn/`` or ``cross_attn/``, ``conv1d/kernel`` under ``ssd/``)."""
    return re.sub(r"/0$", "", path).rsplit(f"{piece}/", 1)[1]


def make_tp_plan(cfg: ModelConfig, params: Any, mesh: Mesh, rules: ShardingRules) -> TPPlan:
    """Decide which pieces of ``cfg``'s model shard over ``mesh``'s model
    axis.  A piece shards iff every one of its leaves that ``leaf_spec``
    splits (float or ``Packed`` words: a 2-bit word holds 4 columns, so
    only whole words split) gets 'model'; attention also needs K % m == 0
    (H % m for MLA) — the test ``pool_head_shards`` applies to the pool.
    A piece that cannot split stays whole on every rank, for any family:
    the families' single-KV-head attention (recurrentgemma, paligemma).  (A
    packed ``in_proj_dt`` whose words do not divide by m stays whole inside
    a split SSD piece.)  Expert
    stacks split over ``cfg.ep_axes`` when ``moe_impl='ep'`` is active on
    the mesh.  The plan names the leaves a sharded piece keeps whole
    (``whole``: qk norms, MLA's compressions, mamba2's B / C / conv / norm
    and such a packed ``in_proj_dt``),
    for training's ``tp_enter_leaves``."""
    from repro_torch.models.blocks import _ep_active

    m = mesh_axis_size(mesh, "model")
    sharded: Dict[str, bool] = {}
    whole: Dict[str, set] = {}
    for path, shape in _paths_and_shapes(params):
        piece = _piece(path)
        if piece is None or piece == "experts" or path.endswith("/1"):
            continue  # exponents are per leaf (or per layer): replicated
        spec = leaf_spec(rules, path, shape)
        if spec is None:
            if not _ROW_BIAS.search(path):  # a row-parallel bias's grad is whole already
                whole.setdefault(piece, set()).add(_whole_key(piece, path))
            continue
        sharded[piece] = sharded.get(piece, True) and "model" in spec
    heads = cfg.n_heads if cfg.use_mla else cfg.n_kv_heads
    on = {k: m > 1 and sharded.get(k, False) for k in ("attn", "mlp", "embed", "ssd", "rglru")}
    on["attn"] = on["attn"] and heads % m == 0
    on["ssd"] = on["ssd"] and cfg.ssm_heads % m == 0
    on["rglru"] = on["rglru"] and cfg.rnn_heads % m == 0
    ep = cfg.moe and cfg.moe_impl == "ep" and _ep_active(cfg, mesh)
    return TPPlan(
        mesh=mesh, group=mesh.group("model"), size=m, index=mesh.axis_index("model"),
        head=m > 1 and (sharded.get("head", False) if not cfg.tie_lm_head
                        else sharded.get("embed", False)),
        ep=ep,
        shared=ep and m > 1 and sharded.get("shared", False),
        whole={k: frozenset(v) for k, v in whole.items() if on.get(k)},
        **on,
    )


def local_config(cfg: ModelConfig, plan: TPPlan) -> ModelConfig:
    """The per-rank config the model code runs on: H/m query heads and K/m
    KV heads where attention is sharded (MLA: H/m), d_inner/m and H/m SSD
    heads, d_rnn/m and H/m RG-LRU heads.  Caches and pools built from it
    (``init_caches``) come out at the rank's shapes."""
    m, rep = plan.size, {}
    if plan.attn:
        rep["n_heads"] = cfg.n_heads // m
        if not cfg.use_mla:
            rep["n_kv_heads"] = cfg.n_kv_heads // m
    if plan.ssd:
        rep.update(d_inner=cfg.d_inner // m, ssm_heads=cfg.ssm_heads // m)
    if plan.rglru:
        rep.update(d_rnn=cfg.d_rnn // m, rnn_heads=cfg.rnn_heads // m)
    return dataclasses.replace(cfg, **rep) if rep else cfg


def piece_on(plan: TPPlan) -> Dict[str, bool]:
    """Which pieces (``_piece``'s names, the expert stacks aside) run split
    over the model axis under ``plan``."""
    return {"attn": plan.attn, "mlp": plan.mlp, "embed": plan.embed, "head": plan.head,
            "shared": plan.shared, "ssd": plan.ssd, "rglru": plan.rglru}


def serve_spec_fn(cfg: ModelConfig, plan: TPPlan, rules: ShardingRules):
    """``shard_tree``'s ``spec_fn`` for a serving engine: a leaf keeps the
    'model' entries of its rule spec iff its piece is sharded under
    ``plan`` (``leaf_spec``); expert stacks split their expert axis over ``cfg.ep_axes``
    (words and per-expert exponents alike) when EP is on; everything else
    replicates.  A tied head shards with the embedding table."""
    on = piece_on(plan)

    def spec_fn(path: str, shape: Tuple[int, ...], spec: Spec) -> Spec:
        piece = _piece(path)
        if piece == "experts":
            # the expert axis: dim -3 of the words (E, K, N/per) under any
            # stacked lead, the last dim of a per-expert exponent (…, E)
            return expert_spec(cfg, plan, shape, len(shape) - 1 if path.endswith("/1")
                               else len(shape) - 3)
        if piece is None or not on.get(piece, False) or path.endswith("/1"):
            return ()
        return leaf_spec(rules, path, shape) or ()

    return spec_fn


def expert_spec(cfg: ModelConfig, plan: TPPlan, shape: Tuple[int, ...], d: int) -> Spec:
    """An expert stack's (or its per-expert exponent's) spec: dim ``d``, the
    expert axis, split over the mesh's ``cfg.ep_axes`` under EP; replicated
    otherwise."""
    if not plan.ep or d < 0 or shape[d] != cfg.n_experts:
        return ()
    ep_axes = tuple(a for a in plan.mesh.axis_names if a in cfg.ep_axes)
    out: list = [None] * len(shape)
    out[d] = ep_axes if len(ep_axes) > 1 else ep_axes[0]
    return tuple(out)
