"""Primitive layers: projections, norms, embeddings, RoPE, activations
(mirrors ``repro/models/layers.py``; params are plain dicts of tensors with
the JAX package's names).

Initializers draw from an explicit ``torch.Generator`` on the target device;
``lead`` prepends stacked-layer dims, so a scan group is drawn in one call.

Tensor parallelism: a serving engine on a mesh whose ``model`` axis has m
ranks runs the model code unchanged on local shapes (H/m query heads, K/m
KV heads, d_ff/m, vocab/m) under a ``TPPlan``, set per thread around its
calls as the dispatch backends are.  The plan says which pieces are
sharded; the collectives are ``tp_reduce`` after a row-parallel
projection (attention's ``o_proj``, the MLP's ``down_proj`` / ``fc2``, an
SSD or RG-LRU block's ``out_proj``), the masked vocab-parallel embedding
lookup, the all-gather of vocab-parallel logits and, in mamba2's gated
norm, the sum of squares over d_inner (``ssd.py``).  A row-parallel
projection's bias (whisper's ``o_proj`` / ``fc2``) is added once, after the
reduce (``split_row_bias``): added to each partial it would count m times.  A piece whose dimensions do
not divide by m stays replicated and runs no collective.

Training runs the same executor with Megatron's f / g pair: ``tp_enter``
(the identity, its backward the sum of the grad over the model axis) on
every replicated tensor that enters a column-parallel piece — the normed
input of q/k/v, of gate/up, of an SSD / RG-LRU block's projections, of
whisper's cross k / v (the encoder's output) and of the vocab-parallel
head, and the leaves a sharded piece keeps whole (qk-norm scales, MLA's
compressions; mamba2's B / C projections, conv kernel and norm scale) —
and ``tp_reduce`` (the sum, its backward the identity) at
the row-parallel exit.  So the grad of every replicated tensor is whole,
and the same, on every model rank.  A plan with ``fsdp`` leaves holds
those params split over the FSDP axes as well: ``fsdp_gather`` joins them
where they are used (a layer's inside its remat region), its backward the
reduce-scatter sum of the grad.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.quantized import as_dense, is_packed, packed_dense_apply, packed_take


@dataclasses.dataclass(frozen=True, eq=False)
class TPPlan:
    """Which pieces of a model run sharded over a mesh's ``model`` axis
    (``serve.sharding.make_tp_plan`` decides): ``attn`` (q/k/v
    column-parallel, ``o_proj`` row-parallel, the pool at K/m heads; MLA on
    H/m heads; whisper's encoder and cross-attention too), ``mlp`` (gate/up
    or fc1 column-, down or fc2 row-parallel), ``embed`` / ``head``
    (vocab-parallel table / read-out), ``ep`` (MoE layers expert parallel,
    ``models.moe_ep``; else an MoE block replicates), ``shared`` (under
    ``ep``, the shared experts' d_ff split over the model axis), ``ssd``
    (mamba2's SSD heads: z / x / dt column-parallel, ``out_proj``
    row-parallel, the state at H/m heads) and ``rglru`` (the RG-LRU block's
    heads and channels).  ``group`` is the model axis's process group,
    ``index`` this rank's place on it."""

    mesh: Any
    group: Any
    size: int
    index: int
    attn: bool = False
    mlp: bool = False
    embed: bool = False
    head: bool = False
    ep: bool = False
    shared: bool = False  # under ``ep``: the shared experts' d_ff split over 'model'
    ssd: bool = False
    rglru: bool = False
    # training: {piece: the names (under the piece's key) of the leaves a
    # sharded piece keeps whole}, the mesh axes the batch rows are split over
    # (serving: none, every rank holds the whole batch), and the params split
    # over the FSDP axes: {param path: (dim of the stored leaf, its size
    # there)}, joined over ``fsdp_group``
    whole: Optional[Dict[str, frozenset]] = None
    dp_axes: Tuple[str, ...] = ()
    fsdp: Optional[Dict[str, Tuple[int, int]]] = None
    fsdp_group: Any = None


class _TPLocal(threading.local):
    plan: Optional[TPPlan] = None


_tp = _TPLocal()


def set_tp(plan: Optional[TPPlan]) -> Optional[TPPlan]:
    """Set the thread's tensor-parallel plan (None: one rank holds every
    piece); returns the previous one, to restore."""
    prev, _tp.plan = _tp.plan, plan
    return prev


def current_tp() -> Optional[TPPlan]:
    """The thread's tensor-parallel plan (None: one rank holds every piece)."""
    return _tp.plan


def tp_enter(x: torch.Tensor, piece: str) -> torch.Tensor:
    """Megatron's f for a replicated tensor entering ``piece`` when it is
    sharded: the identity, whose backward sums the grad over the model axis
    (each rank's grad covers its own heads / columns / vocab rows only).
    Without autograd it is the identity and runs nothing."""
    plan = _tp.plan
    if plan is None or not getattr(plan, piece) or not getattr(x, "requires_grad", False):
        return x  # (a ``Packed`` leaf is served, never trained)
    from repro_torch.distributed.collectives import EnterReplicas

    return EnterReplicas.apply(x, plan.group)


def tp_enter_leaves(p: Dict[str, Any], piece: str = "attn") -> Dict[str, Any]:
    """``p`` (the params of ``piece``: an attention's, an SSD block's) with
    ``tp_enter`` on each leaf a sharded ``piece`` keeps whole (the plan's
    ``whole``)."""
    plan = _tp.plan
    names = plan.whole.get(piece) if plan is not None and plan.whole else None
    if not names or not getattr(plan, piece) or not torch.is_grad_enabled():
        return p
    from repro_torch.nn.tree import tree_map_with_path

    return tree_map_with_path(lambda path, w: tp_enter(w, piece) if path in names else w, p)


# the row-parallel projection of each piece with a biased form (whisper's):
# its bias is added after the reduce
_ROW_OUT = {"attn": ("o_proj",), "mlp": ("down_proj", "fc2")}


def split_row_bias(p: Dict[str, Any], piece: str) -> Tuple[Dict[str, Any], Any]:
    """(``p``, None), or, under a plan that splits ``piece``, (``p`` with its
    row-parallel projection's bias taken out, that bias): the caller passes
    the bias to ``tp_reduce``, which adds it once to the sum (each rank adding
    it to its partial would give m·b)."""
    plan = _tp.plan
    if plan is None or not getattr(plan, piece):
        return p, None
    for name in _ROW_OUT[piece]:
        if name in p and "bias" in p[name]:
            q = dict(p)
            q[name] = {k: v for k, v in p[name].items() if k != "bias"}
            return q, p[name]["bias"]
    return p, None


def fsdp_gather(tree: Any, prefix: str, lead: int = 0) -> Any:
    """``tree`` (the params at ``prefix``; a view of one layer of a stacked
    group when ``lead`` is 1) with every leaf the plan splits over the FSDP
    axes joined whole along its dim (``collectives.GatherShards``); a leaf
    joined already passes through."""
    plan = _tp.plan
    if plan is None or not plan.fsdp:
        return tree
    from repro_torch.distributed.collectives import GatherShards
    from repro_torch.nn.tree import tree_map_with_path

    def one(path, leaf):
        d, size = plan.fsdp.get(f"{prefix}/{path}", (None, None))
        if d is None or leaf.shape[d - lead] != size:
            return leaf
        return GatherShards.apply(leaf, plan.fsdp_group, d - lead)

    return tree_map_with_path(one, tree)


def tp_reduce(y: torch.Tensor, piece: str, bias: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Sum the row-parallel partials of ``piece`` ('attn', 'mlp', 'ssd',
    'rglru') over the model axis: in fp32, plus ``bias`` (``split_row_bias``'s:
    None unless the piece is split and biased), rounded once to y's dtype
    (summing bf16 partials would round twice and can flip a greedy token)."""
    plan = _tp.plan
    if plan is None or not getattr(plan, piece):
        return y
    from repro_torch.distributed.collectives import ReduceSum

    out = ReduceSum.apply(y.to(torch.float32), plan.group)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(y.dtype)


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    # scaled in place: one full-size temporary, not two (a deepseek-v3 expert
    # stack is 15 GB in fp32)
    return torch.randn(tuple(shape), generator=gen, device=gen.device).mul_(std).to(dtype)


def dense_init(gen, in_dims: Sequence[int], out_dims: Sequence[int], *, bias: bool = False,
               stddev: Optional[float] = None, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """General projection: kernel shape (*lead, *in_dims, *out_dims)."""
    in_dims, out_dims = tuple(in_dims), tuple(out_dims)
    std = stddev if stddev is not None else 1.0 / math.sqrt(math.prod(in_dims))
    p = {"kernel": _normal(gen, lead + in_dims + out_dims, std, dtype)}
    if bias:
        p["bias"] = torch.zeros(lead + out_dims, dtype=dtype, device=gen.device)
    return p


# On the card a float matmul runs at a multiple of ROW_TILE rows, zero
# rows appended: cuBLAS picks its kernel, and with it each row's rounding,
# from the row count, so without this a decode or verify row's bits would
# depend on how many slots share the step (and a sampled stream on the slot
# count).  A row's output then depends on its own row alone.
ROW_TILE = 64


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with rows batch-invariant on the card."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    M = x2.shape[0]
    pad = -M % ROW_TILE if x2.is_cuda else 0
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    return torch.matmul(x2, w)[:M].reshape(*lead, w.shape[-1])


def dense_apply(p, x, *, n_in: int = 1, compute_dtype=None):
    """Contract the last ``n_in`` dims of x with the first n_in of the kernel.
    A ``Packed`` kernel dispatches to the fixed-point matmul."""
    k = p["kernel"]
    if is_packed(k):
        return packed_dense_apply(p, x, n_in=n_in, compute_dtype=compute_dtype)
    if compute_dtype is not None:
        x, k = x.to(compute_dtype), k.to(compute_dtype)
    in_dims, out_dims = k.shape[:n_in], k.shape[n_in:]
    y = matmul_rows(x.reshape(*x.shape[: x.ndim - n_in], math.prod(in_dims)),
                    k.reshape(math.prod(in_dims), math.prod(out_dims)))
    y = y.reshape(*y.shape[:-1], *out_dims)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def rmsnorm_init(dim: int, dtype=torch.float32, device=None, lead: Tuple[int, ...] = ()):
    return {"scale": torch.zeros(lead + (dim,), dtype=dtype, device=device)}  # (1+scale)


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None, lead: Tuple[int, ...] = ()):
    return {
        "scale": torch.ones(lead + (dim,), dtype=dtype, device=device),
        "bias": torch.zeros(lead + (dim,), dtype=dtype, device=device),
    }


def layernorm_apply(p, x, *, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(x.dtype)


def embed_init(gen, vocab: int, dim: int, *, stddev: float = 0.02, dtype=torch.float32):
    return {"embedding": _normal(gen, (vocab, dim), stddev, dtype)}


def _take(e, ids, compute_dtype):
    if is_packed(e):  # gather packed rows, dequantize only those
        return packed_take(e, ids, dtype=compute_dtype)
    if compute_dtype is not None:
        e = e.to(compute_dtype)
    return e[ids]


def embed_apply(p, ids, *, compute_dtype=None):
    """Row lookup.  Under a plan with ``embed`` the table holds this rank's
    vocab / m rows: ids outside them read row 0 and are zeroed, and the sum
    over the model axis (one nonzero term a token: exact) gives every rank
    the whole lookup."""
    e = p["embedding"]
    plan = _tp.plan
    if plan is None or not plan.embed:
        return _take(e, ids, compute_dtype)
    from repro_torch.distributed.collectives import ReduceSum

    rows = e.shape[0]
    local = ids - plan.index * rows
    mine = (local >= 0) & (local < rows)
    x = _take(e, torch.where(mine, local, 0), compute_dtype)
    x = x * mine[..., None].to(x.dtype)
    return ReduceSum.apply(x.to(torch.float32), plan.group).to(x.dtype)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel logits (..., vocab / m) -> the whole vocabulary on
    every rank (the plan's ``head``)."""
    plan = _tp.plan
    if plan is None or not plan.head:
        return logits
    from repro_torch.distributed.collectives import AllGather

    return AllGather.apply(logits.contiguous(), plan.group, logits.ndim - 1)


def embed_logits(p, x):
    """Tied read-out x @ E^T in fp32.  A Packed table is dequantized whole on
    every call, as in the JAX package (92544x2048 fp32 at full width)."""
    e = as_dense(p["embedding"], torch.float32)
    return matmul_rows(x.to(torch.float32), e.t())


def _table_cache(fn):
    """Cache a host-built table per argument tuple, and separately per active
    ``FakeTensorMode`` (the dry run's trace): no fake tensor outlives its
    mode or meets a real one, and a trace keeps each table alive as the
    real program's cache does."""
    cached = functools.lru_cache(maxsize=64)(fn)
    per_mode: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    @functools.wraps(fn)
    def get(*args):
        mode = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
        if mode is None:
            return cached(*args)
        tables = per_mode.setdefault(mode, {})
        if args not in tables:
            tables[args] = fn(*args)
        return tables[args]

    get.cache_clear = cached.cache_clear
    return get


@_table_cache
def _sin_divisors(dim: int, device: torch.device, reciprocal: bool = False) -> torch.Tensor:
    """(dim // 2,) fp32 divisors 10000^(2i/dim) of ``sinusoidal_pos`` (or
    their fp32 reciprocals), with the bits the JAX package's jitted traces
    give them: XLA folds ``/ dim`` into a product with f32(1/dim), and its
    power is the C library's ``powf``, which the fp64 power rounded once to
    fp32 reproduces at the configs' widths (32, 1280;
    tests/test_torch_encdec_vlm.py).  Built on the host once per (width,
    device), as ``_rope_freq`` is."""
    y = (2 * np.arange(dim // 2, dtype=np.float32)) * np.float32(1.0 / dim)
    div = np.power(10000.0, y.astype(np.float64)).astype(np.float32)
    if reciprocal:
        div = np.float32(1.0) / div
    return torch.from_numpy(div).to(device)


def sinusoidal_angles(positions: torch.Tensor, dim: int, *, reciprocal: bool = False
                      ) -> torch.Tensor:
    """(..., dim) fp32 absolute position embedding [sin, cos] of the angles
    positions / 10000^(2i/dim), i < dim / 2 (``positions`` (...) of any
    dtype).  ``reciprocal``: the angle as positions · f32(1 / divisor), the
    form XLA compiles the JAX decode step's embedding to (its divisors are
    constants there); the quotient and the product may round an ulp apart."""
    div = _sin_divisors(dim, positions.device, reciprocal)
    p = positions.to(torch.float32)[..., None]
    ang = p * div if reciprocal else p / div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_pos(seq_len: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(seq_len, dim) table of ``sinusoidal_angles`` at positions 0..seq_len-1
    (whisper's encoder, and its decoder over a prompt)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    return sinusoidal_angles(pos, dim).to(dtype)


@_table_cache
def _rope_freq(base: float, half: int, device: torch.device) -> torch.Tensor:
    """exp(-ln(base)·i/half) in fp32, as the JAX package computes it; built
    on the device once per (base, width) — every layer of every step reuses it."""
    lb = torch.log(torch.full((), base, dtype=torch.float32, device=device))
    return torch.exp(-lb * (torch.arange(half, dtype=torch.float32, device=device) / half))


def rope_table(positions: torch.Tensor, base, hd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos2, sin2), each (..., T, 1, hd): [cos, cos] and [-sin, sin] of the
    angles positions·freq.  Every layer with this base shares one table."""
    half = hd // 2
    ang = positions[..., None].to(torch.float32) * _rope_freq(float(base), half, positions.device)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base, table=None) -> torch.Tensor:
    """x: (..., T, H, hd); positions broadcastable to (..., T).  ``table``
    is ``rope_table(positions, base, hd)`` when the caller shares one.

    [x1·cos - x2·sin, x2·cos + x1·sin] in fp32, written as
    x·[cos, cos] + [x2, x1]·[-sin, sin] — the same IEEE operations (a - b is
    a + (-b) exactly), so the result equals the JAX package's bit for bit."""
    hd = x.shape[-1]
    half = hd // 2
    cos2, sin2 = table if table is not None else rope_table(positions, base, hd)
    xf = x.to(torch.float32)
    rot = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos2 + rot * sin2).to(x.dtype)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu,
        "relu": F.relu,
    }[name]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style logit soft capping: cap·tanh(x/cap)."""
    return (cap * torch.tanh(logits.to(torch.float32) / cap)).to(logits.dtype)
