"""Training step factory (mirrors ``repro/train/trainer.py``): grads (with
optional microbatch accumulation) → SYMOG regularizer gradient (Alg. 1 l.15)
→ optimizer → weight clipping (l.17).

SYMOG integration is exactly the paper's update:
    w ← w − η(∂C/∂w + λ(step)·∂R/∂w) ;  w ← Clip(w, ±Δ(2^{N-1}−1))
with λ on its exponential schedule.  ``symog_cfg=None`` gives the float
baseline trainer.  ``make_train_step`` trains every family
``lm_train_loss`` takes: a batch carries ``tokens`` and, for whisper and
paligemma, ``frames`` (B, encoder_len, D) / ``patches`` (B, prefix_len, D),
moved to the params' device and split into microbatches along B with the
tokens.

Two routes compute the update (``kernels.dispatch.set_update_backend``):

  'composed' — the JAX trainer's order on whole trees: g + λ·reg_grad,
               ``tx.update``, ``apply_updates``, ``clip_tree``; new tensors.
  'fused'    — for the paper's optimizer only (``optim.sgd`` Nesterov, no
               weight decay, fp32 momentum, alone or as
               ``chain(clip_by_global_norm(c), sgd(...))``) with clipping
               on: ONE ``symog_update`` per quantizable leaf, λ_eff = λ·2/M_l
               with M_l the whole (layer-stacked) leaf's count, updating w
               and its momentum IN PLACE; the leaves SYMOG excludes (norm
               scales, biases, the SSD's ``A_log`` / ``dt_bias`` /
               ``ssm_D``, the RG-LRU's ``a_param``) take the same SGD math
               in torch.  With the clip, a norm pass comes first: ONE
               ``symog_sqnorm`` per quantizable leaf sums (g + λ_eff·(w − q))²
               (the regularizer at the pre-update w, as JAX adds it before
               ``tx.update``), torch sums g² of the other leaves, and the clip
               scale s = min(1, c/(√Σ + 1e-9)) stays on the device: the
               kernel scales its total gradient by s, the other leaves take
               s·g.

'auto' takes 'fused' on the card when the optimizer allows it, 'composed'
otherwise; asking for 'fused' with another optimizer raises.  On the fused
route the state passed to the step is consumed: its tensors are updated.
An MoE expert stack's per-expert f goes to the kernel as a Δ per (layer,
expert) group.  The CNN half (``make_cnn_train_step``, ``make_cnn_eval``)
trains the paper's CNNs through the same update; BN's running stats ride
along in the state.

Distribution (``make_train_step(..., mesh=)``): the state is placed by
``train.sharding`` (``shard_train_state`` on a whole ``TrainState``, after
``symog_init`` ran on the whole leaves).  Every rank runs the same program
on its share of the global batch (rows split over the (pod, data) axes),
under the layout's ``TPPlan`` and ``with mesh:``: pieces split over a
``model`` axis > 1 run tensor-parallel on local shapes (Megatron's f / g,
``models.layers``), the loss is the vocab-parallel cross entropy, an FSDP
profile's params are joined where they are used, and MoE layers under
``moe_impl='ep'`` route expert-parallel when the mesh's EP axes multiply
past 1.  The gradients are mean-reduced over the data axes in fp32 (the
FSDP-split leaves' sums come from the reduce-scatter of their join's
backward); a leaf replicated over ``model`` comes out equal on every model
rank.  The update then reads whole-leaf quantities on the shards: λ_eff
from the leaf's whole M_l (``layout.numel``), the clip's norm and
``grad_norm`` from per-leaf partials summed over the ranks each leaf spans
(``layout.sum_over_shards``), so every rank applies the same clip scale.
An expert stack's Δ per (layer, expert) group is this rank's slice of the
groups.  Every family runs on a ``model`` axis: mamba2's SSD heads and
recurrentgemma's RG-LRU heads split, and whisper's encoder, self- and
cross-attention, their biases placed by the plan (``serve.sharding``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import SymogConfig, SymogState, clip_tree, lambda_at, reg_grad, symog_init
from repro_torch.core.quantizer import delta_from_f
from repro_torch.kernels import dispatch
from repro_torch.kernels.symog_update import symog_sqnorm, symog_update
from repro_torch.models.cnn import CNNConfig, cnn_apply, fp32_convs
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import set_tp
from repro_torch.models.lm import lm_train_loss
from repro_torch.nn.tree import flatten_with_paths, tree_leaves, tree_map, tree_map_with_path
from repro_torch.optim import GradientTransformation, apply_updates, global_norm
from repro_torch.optim.transform import set_norm_shards


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    symog: Optional[SymogState]
    step: int


def init_train_state(params, tx: GradientTransformation,
                     symog_cfg: Optional[SymogConfig] = None) -> TrainState:
    return TrainState(
        params=params,
        opt_state=tx.init(params),
        symog=symog_init(params, symog_cfg) if symog_cfg else None,
        step=0,
    )


def _loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, grads) of one (micro)batch: autograd through detached
    views of the params, so the caller's tensors never carry a graph."""
    paths = [p for p, _ in flatten_with_paths(params)]
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live, batch)
    grads = dict(zip(paths, torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                                 materialize_grads=True)))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_map_with_path(lambda path, _: grads[path], params)


def _accum_grads(loss_fn, params, batch, accum: int):
    """Microbatch gradient accumulation: a sequential loop over ``accum``
    slices of the batch along B (every entry: tokens, frames, patches, a
    loss mask), activation memory of one microbatch, summed in fp32 and
    scaled by 1/accum, as the JAX package's ``lax.scan``."""
    if accum <= 1:
        return _loss_and_grads(loss_fn, params, batch)
    B = next(iter(batch.values())).shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} microbatches")
    mb = B // accum
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    loss, metrics = 0.0, None
    for i in range(accum):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l_i, m_i, g_i = _loss_and_grads(loss_fn, params, part)
        grads = tree_map(torch.add, grads, g_i)
        loss = loss + l_i
        metrics = m_i if metrics is None else {k: metrics[k] + m_i[k] for k in metrics}
    scale = 1.0 / accum
    return (loss * scale, {k: v * scale for k, v in metrics.items()},
            tree_map(lambda g: g * scale, grads))


def _check_fusable(tx: GradientTransformation, symog_cfg: Optional[SymogConfig]) -> Optional[str]:
    """Why the fused update cannot compute this step, or None if it can."""
    if symog_cfg is None or not symog_cfg.clip:
        return "the fused update needs a SymogConfig with clip=True"
    if tx.paper_sgd is None:
        return ("the fused update computes the paper's optimizer only: optim.sgd with "
                "nesterov=True, weight_decay=0 and fp32 momentum, alone or as "
                "chain(clip_by_global_norm(c), sgd(...))")
    return None


def _clip_scale(c: float, norm: torch.Tensor) -> torch.Tensor:
    """min(1, c/(norm + 1e-9)), ``optim.clip_by_global_norm``'s scale."""
    return torch.clamp(c / (norm + 1e-9), max=1.0)


def composed_update(params, grads, opt_state, symog: Optional[SymogState],
                    symog_cfg: Optional[SymogConfig], tx: GradientTransformation, *,
                    lr: float, lam: Optional[float], stats: Optional[Dict[str, Any]] = None,
                    shards=None):
    """The JAX trainer's update on whole trees: returns (params, opt_state).
    ``stats``, if given, receives the clip scale as ``clip_scale`` when ``tx``
    clips (one more norm of the total grads).  ``shards`` (a
    ``train.sharding`` layout): the trees hold this rank's shards; M_l and
    the norms are the whole leaves' (``tx`` sees the layout through
    ``optim.transform.set_norm_shards``)."""
    if symog_cfg is not None:
        rg = reg_grad(params, symog, symog_cfg, shards)
        grads = tree_map(lambda g, r: g + lam * r.to(g.dtype), grads, rg)
    if stats is not None and tx.clip_norm is not None:
        stats["clip_scale"] = _clip_scale(tx.clip_norm, global_norm(grads, shards))
    prev = set_norm_shards(shards)
    try:
        updates, opt_state = tx.update(grads, opt_state, params, lr=lr)
    finally:
        set_norm_shards(prev)
    params = apply_updates(params, updates)
    if symog_cfg is not None and symog_cfg.clip:
        params = clip_tree(params, symog, symog_cfg)
    return params, opt_state


def fused_update(params, grads, opt_state, symog: SymogState, symog_cfg: SymogConfig,
                 tx: GradientTransformation, *, lr: float, lam: float,
                 deltas: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
                 stats: Optional[Dict[str, Any]] = None, shards=None):
    """One ``symog_update`` per quantizable leaf, SGD-Nesterov in torch for
    the rest, all in place on the params and their momentum: returns the same
    (params, opt_state).  With ``clip_by_global_norm`` chained before the SGD,
    a ``symog_sqnorm`` per quantizable leaf first (the module docstring).  An
    expert stack's f (one per leading (layer, expert) index) goes to the
    kernels as its Δ tensor, one Δ per group; λ_eff stays λ·2/M_l over the
    whole leaf, JAX's ``layer_reg_grad``.  ``deltas`` caches each leaf's fp32
    Δ by path, keyed on the identity of its f, so Δ is made on the device
    once per run; ``stats`` receives ``clip_scale``, as ``composed_update``.
    ``shards`` (a ``train.sharding`` layout): the trees hold this rank's
    shards; λ_eff takes the whole leaf's M_l and the clip's norm sums each
    leaf's ``symog_sqnorm`` partial over the ranks its shards span."""
    why = _check_fusable(tx, symog_cfg)
    if why:
        raise ValueError(why)
    mu = tx.paper_sgd
    deltas = {} if deltas is None else deltas
    f_by_path = dict(flatten_with_paths(symog.f))
    momentum = opt_state[1] if tx.clip_norm is not None else opt_state
    v_by_path = dict(flatten_with_paths(momentum))
    g_by_path = dict(flatten_with_paths(grads))

    leaves = []  # (path, w, g, v, Δ or None for the leaves SYMOG excludes, λ_eff)
    for path, w in flatten_with_paths(params):
        delta = None
        if symog.mask[path]:
            f = f_by_path[path]  # 0-d, or one f per (layer, expert) of an expert stack
            cached = deltas.get(path)
            if cached is None or cached[0] is not f:
                cached = deltas[path] = (f, delta_from_f(f, device=w.device))
            delta = cached[1]
        m_l = w.numel() if shards is None else shards.numel(path)
        leaves.append((path, w, g_by_path[path].contiguous(), v_by_path[path], delta,
                       lam * 2.0 / m_l))

    with torch.no_grad():
        scale = 1.0
        if tx.clip_norm is not None:  # the sorted-path order of JAX's global norm
            sq = {path: torch.sum(torch.square(g)) if d is None else
                  symog_sqnorm(w, g, delta=d, lam_eff=lam_eff, n_bits=symog_cfg.n_bits)
                  for path, w, g, _, d, lam_eff in leaves}
            total = sum(sq.values()) if shards is None else shards.sum_over_shards(sq)
            scale = _clip_scale(tx.clip_norm, torch.sqrt(total))
            if stats is not None:
                stats["clip_scale"] = scale
        for _, w, g, v, delta, lam_eff in leaves:
            if delta is None:  # norm scales: the same SGD-Nesterov math
                g = g * scale if tx.clip_norm is not None else g
                v.mul_(mu).add_(g)
                w.sub_(lr * (g + mu * v))
                continue
            symog_update(w, g, v, delta=delta, lam_eff=lam_eff, lr=lr, mu=mu,
                         n_bits=symog_cfg.n_bits, gscale=scale)
    return params, opt_state


def _make_update(tx: GradientTransformation, lr_schedule: Callable[[int], float],
                 symog_cfg: Optional[SymogConfig]):
    """The step's update with its backend pinned now (``dispatch``):
    ``update(params, grads, opt_state, symog, step) -> (params, opt_state,
    lr, λ, stats)``, fused or composed as the module docstring says; stats
    holds ``clip_scale`` when ``tx`` clips."""
    backend = dispatch.get_update_backend()
    why = _check_fusable(tx, symog_cfg)
    if backend == "fused" and why:
        raise ValueError(why)
    deltas: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def update(params, grads, opt_state, symog, step: int, shards=None):
        lr = lr_schedule(step)
        lam = lambda_at(symog_cfg, step) if symog_cfg is not None else None
        dev = tree_leaves(params)[0].device
        stats: Dict[str, Any] = {}
        if dispatch.resolve_update_backend(dev, backend) == "fused" and not why:
            # ('auto' with another optimizer composes)
            params, opt_state = fused_update(params, grads, opt_state, symog, symog_cfg, tx,
                                             lr=lr, lam=lam, deltas=deltas, stats=stats,
                                             shards=shards)
        else:
            with torch.no_grad():
                params, opt_state = composed_update(params, grads, opt_state, symog, symog_cfg,
                                                    tx, lr=lr, lam=lam, stats=stats,
                                                    shards=shards)
        return params, opt_state, lr, lam, stats

    return update


def _on_device(batch, params):
    dev = tree_leaves(params)[0].device
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _my_rows(batch, n: int, i: int):
    """Rank i's rows of every batch entry (split along B into n shares)."""
    if n == 1:
        return batch
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} data ranks")
    b = B // n
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def _mean_over_data(tree, layout, split=()):
    """Mean of every leaf over the layout's data ranks, summed in fp32; the
    leaves at paths in ``split`` (FSDP-split grads, already summed over the
    data ranks by their join's backward) are only scaled."""
    from repro_torch.distributed.collectives import all_reduce

    if layout is None or layout.n_data == 1:
        return tree
    group, n = layout.mesh.group(layout.data_axes), layout.n_data

    def one(path, g):
        g = g.to(torch.float32)
        return (g if path in split else all_reduce(g, group)) / n

    return tree_map_with_path(one, tree)


def make_train_step(
    cfg: ModelConfig,
    tx: GradientTransformation,
    lr_schedule: Callable[[int], float],
    *,
    symog_cfg: Optional[SymogConfig] = None,
    accum_steps: int = 1,
    compute_dtype=torch.bfloat16,
    loss_fn: Optional[Callable] = None,
    mb_constraint: Optional[Callable] = None,
    act_pspec=None,
    cast_params: bool = False,
    mesh=None,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (state, metrics)``; batch values
    (``tokens``, and ``frames`` / ``patches`` for whisper / paligemma) may be
    numpy arrays or tensors.  metrics: ``lm_train_loss``'s (``loss``, ``ce``;
    ``moe_aux_loss``, ``moe_z_loss`` on an MoE config; ``mtp_ce`` with MTP)
    and ``grad_norm`` (0-d tensors on the params' device), ``lr`` and
    ``symog_lambda`` (floats); with ``chain(clip_by_global_norm(c), ...)``
    also ``clip_scale`` (0-d, the port's own: the scale the clip applied to
    g + λ·∂R/∂w).  The update backend is pinned here
    (``dispatch.get_update_backend``).

    ``mesh`` (an ``nn.sharding.Mesh`` of (pod,) data and model axes): the
    state is ``train.sharding.shard_train_state``'s for this mesh and
    ``cfg.sharding_profile``, as the module docstring says; the step takes
    the GLOBAL batch (the same on every rank) and trains on this rank's
    rows of it, and ``loss`` and the other loss metrics are means over the
    data ranks (equal on the model ranks).  A ``loss_fn`` of the caller's
    runs on the per-rank shapes.  ``mb_constraint`` and ``act_pspec`` are
    JAX's signature (``act_pspec`` from ``ShardingRules.act_pspec``): they
    pin GSPMD layouts, which the port's explicit per-rank layout does not
    have, so they are accepted and not read."""
    from repro_torch.train.sharding import train_layout

    del mb_constraint, act_pspec
    layout = train_layout(cfg, mesh) if mesh is not None else None
    n_data, my = (layout.n_data, layout.data_index) if layout is not None else (1, 0)
    fsdp_paths = frozenset(layout.plan.fsdp or ()) if layout is not None else frozenset()
    run_cfg = layout.cfg if layout is not None else cfg
    update = _make_update(tx, lr_schedule, symog_cfg)
    if loss_fn is None:
        def loss_fn(params, batch):  # noqa: F811 — default LM loss
            return lm_train_loss(params, batch, run_cfg, compute_dtype=compute_dtype)

    if cast_params:
        # mixed precision: fp32 master weights, a compute-dtype copy made
        # once per step for the forward/backward (grads come back fp32)
        base_loss_fn = loss_fn

        def loss_fn(params, batch):  # noqa: F811
            cparams = tree_map(lambda p: p.to(compute_dtype)
                               if p.dtype == torch.float32 and p.ndim >= 1 else p, params)
            return base_loss_fn(cparams, batch)

    def grads_of(params, batch):
        if layout is None:
            return _accum_grads(loss_fn, params, batch, accum_steps)
        prev = set_tp(layout.plan)
        try:
            with layout.mesh:  # MoE layers read it to route expert-parallel
                return _accum_grads(loss_fn, params, batch, accum_steps)
        finally:
            set_tp(prev)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        batch = _my_rows(_on_device(batch, state.params), n_data, my)
        _, metrics, grads = grads_of(state.params, batch)
        grads = _mean_over_data(grads, layout, fsdp_paths)
        metrics = dict(_mean_over_data(metrics, layout))
        metrics["grad_norm"] = global_norm(grads, layout)
        params, opt_state, lr, lam, stats = update(state.params, grads, state.opt_state,
                                                   state.symog, state.step, layout)
        metrics.update(stats)
        metrics["lr"] = lr
        if symog_cfg is not None:
            metrics["symog_lambda"] = lam
        return TrainState(params, opt_state, state.symog, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# CNN variant (the paper's models: BN state rides along, images/labels loss)
# ---------------------------------------------------------------------------
class CNNTrainState(NamedTuple):
    params: Any
    bn_state: Any
    opt_state: Any
    symog: Optional[SymogState]
    step: int


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of integer labels, in fp32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].to(torch.int64)))


def _accuracy(logits, labels) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


def make_cnn_train_step(cnn_cfg: CNNConfig, tx: GradientTransformation,
                        lr_schedule: Callable[[int], float], *,
                        symog_cfg: Optional[SymogConfig] = None):
    """``train_step(state, batch) -> (state, metrics)`` for a ``CNNTrainState``;
    batch ``images`` (B, H, W, C) and ``labels`` (B,).  metrics: ``loss``,
    ``acc`` (0-d tensors) and, with SYMOG, ``symog_lambda``, as JAX's.  The
    update runs as ``make_train_step``'s: on the card one ``symog_update``
    per quantizable leaf; BN's new running stats come back in the state."""
    update = _make_update(tx, lr_schedule, symog_cfg)

    def train_step(state: CNNTrainState, batch) -> Tuple[CNNTrainState, Dict[str, Any]]:
        batch = _on_device(batch, state.params)
        box = {}

        def loss_fn(params, batch):
            logits, box["bn"] = cnn_apply(params, state.bn_state, batch["images"], cnn_cfg,
                                          train=True)
            loss = softmax_xent(logits, batch["labels"])
            return loss, {"loss": loss, "acc": _accuracy(logits, batch["labels"])}

        with fp32_convs():  # the backward's convolutions too
            _, metrics, grads = _loss_and_grads(loss_fn, state.params, batch)
        params, opt_state, _, lam, stats = update(state.params, grads, state.opt_state,
                                                  state.symog, state.step)
        metrics.update(stats)
        if symog_cfg is not None:
            metrics["symog_lambda"] = lam
        return CNNTrainState(params, box["bn"], opt_state, state.symog, state.step + 1), metrics

    return train_step


def make_cnn_eval(cnn_cfg: CNNConfig):
    """``eval_step(params, bn_state, batch) -> accuracy`` (a 0-d tensor),
    BN on its running stats."""

    @torch.no_grad()
    def eval_step(params, bn_state, batch):
        batch = _on_device(batch, params)
        logits, _ = cnn_apply(params, bn_state, batch["images"], cnn_cfg, train=False)
        return _accuracy(logits, batch["labels"])

    return eval_step
