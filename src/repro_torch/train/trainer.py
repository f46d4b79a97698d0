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

Data parallelism (``make_train_step(..., mesh=)``, a mesh whose ``model``
axis is 1): every rank runs the same program on its share of the global
batch (rows split over the (pod, data) axes), the gradients are
mean-all-reduced in fp32 over the data group before the update, the clip's
global norm is taken once from the reduced gradients, and the update then
runs the same on every rank: the parameters stay replicated.  MoE layers
take the capacity dispatch there (the trainer enters no mesh).  A ``model``
axis > 1 is tensor-parallel training, not ported yet.
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
from repro_torch.models.lm import lm_train_loss
from repro_torch.nn.tree import flatten_with_paths, tree_leaves, tree_map, tree_map_with_path
from repro_torch.optim import GradientTransformation, apply_updates, global_norm


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
                    lr: float, lam: Optional[float], stats: Optional[Dict[str, Any]] = None):
    """The JAX trainer's update on whole trees: returns (params, opt_state).
    ``stats``, if given, receives the clip scale as ``clip_scale`` when ``tx``
    clips (one more norm of the total grads)."""
    if symog_cfg is not None:
        rg = reg_grad(params, symog, symog_cfg)
        grads = tree_map(lambda g, r: g + lam * r.to(g.dtype), grads, rg)
    if stats is not None and tx.clip_norm is not None:
        stats["clip_scale"] = _clip_scale(tx.clip_norm, global_norm(grads))
    updates, opt_state = tx.update(grads, opt_state, params, lr=lr)
    params = apply_updates(params, updates)
    if symog_cfg is not None and symog_cfg.clip:
        params = clip_tree(params, symog, symog_cfg)
    return params, opt_state


def fused_update(params, grads, opt_state, symog: SymogState, symog_cfg: SymogConfig,
                 tx: GradientTransformation, *, lr: float, lam: float,
                 deltas: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
                 stats: Optional[Dict[str, Any]] = None):
    """One ``symog_update`` per quantizable leaf, SGD-Nesterov in torch for
    the rest, all in place on the params and their momentum: returns the same
    (params, opt_state).  With ``clip_by_global_norm`` chained before the SGD,
    a ``symog_sqnorm`` per quantizable leaf first (the module docstring).  An
    expert stack's f (one per leading (layer, expert) index) goes to the
    kernels as its Δ tensor, one Δ per group; λ_eff stays λ·2/M_l over the
    whole leaf, JAX's ``layer_reg_grad``.  ``deltas`` caches each leaf's fp32
    Δ by path, keyed on the identity of its f, so Δ is made on the device
    once per run; ``stats`` receives ``clip_scale``, as ``composed_update``."""
    why = _check_fusable(tx, symog_cfg)
    if why:
        raise ValueError(why)
    mu = tx.paper_sgd
    deltas = {} if deltas is None else deltas
    f_by_path = dict(flatten_with_paths(symog.f))
    momentum = opt_state[1] if tx.clip_norm is not None else opt_state
    v_by_path = dict(flatten_with_paths(momentum))
    g_by_path = dict(flatten_with_paths(grads))

    leaves = []  # (w, g, v, Δ or None for the leaves SYMOG excludes, λ_eff)
    for path, w in flatten_with_paths(params):
        delta = None
        if symog.mask[path]:
            f = f_by_path[path]  # 0-d, or one f per (layer, expert) of an expert stack
            cached = deltas.get(path)
            if cached is None or cached[0] is not f:
                cached = deltas[path] = (f, delta_from_f(f, device=w.device))
            delta = cached[1]
        leaves.append((w, g_by_path[path].contiguous(), v_by_path[path], delta,
                       lam * 2.0 / w.numel()))

    with torch.no_grad():
        scale = 1.0
        if tx.clip_norm is not None:  # the sorted-path order of JAX's global norm
            sq = sum(torch.sum(torch.square(g)) if d is None else
                     symog_sqnorm(w, g, delta=d, lam_eff=lam_eff, n_bits=symog_cfg.n_bits)
                     for w, g, _, d, lam_eff in leaves)
            scale = _clip_scale(tx.clip_norm, torch.sqrt(sq))
            if stats is not None:
                stats["clip_scale"] = scale
        for w, g, v, delta, lam_eff in leaves:
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

    def update(params, grads, opt_state, symog, step: int):
        lr = lr_schedule(step)
        lam = lambda_at(symog_cfg, step) if symog_cfg is not None else None
        dev = tree_leaves(params)[0].device
        stats: Dict[str, Any] = {}
        if dispatch.resolve_update_backend(dev, backend) == "fused" and not why:
            # ('auto' with another optimizer composes)
            params, opt_state = fused_update(params, grads, opt_state, symog, symog_cfg, tx,
                                             lr=lr, lam=lam, deltas=deltas, stats=stats)
        else:
            with torch.no_grad():
                params, opt_state = composed_update(params, grads, opt_state, symog, symog_cfg,
                                                    tx, lr=lr, lam=lam, stats=stats)
        return params, opt_state, lr, lam, stats

    return update


def _on_device(batch, params):
    dev = tree_leaves(params)[0].device
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


_DATA_AXES = ("pod", "data")


def _data_parallel(mesh):
    """(group, ranks, this rank's index) of the mesh's data axes; refuses a
    model axis > 1."""
    from repro_torch.nn.sharding import mesh_axis_size

    if mesh is None:
        return None, 1, 0
    if mesh_axis_size(mesh, "model") > 1:
        raise NotImplementedError(
            "tensor-parallel training (a mesh whose model axis is > 1) is not ported yet: "
            "ROADMAP Queue 1 item 5 (distribution); train on a Dx1 mesh")
    return mesh.group(_DATA_AXES), mesh_axis_size(mesh, *_DATA_AXES), mesh.axis_index(_DATA_AXES)


def _my_rows(batch, n: int, i: int):
    """Rank i's rows of every batch entry (split along B into n shares)."""
    if n == 1:
        return batch
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} data ranks")
    b = B // n
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def _mean_over(tree, group, n: int):
    """Mean of every leaf over the data ranks, summed in fp32."""
    from repro_torch.distributed.collectives import all_reduce

    if n == 1:
        return tree
    return tree_map(lambda g: all_reduce(g.to(torch.float32), group) / n, tree)


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

    ``mesh`` (a Dx1 ``nn.sharding.Mesh``): data-parallel, as the module
    docstring says; the step takes the GLOBAL batch (the same on every
    rank) and trains on this rank's rows of it, and ``loss`` and the other
    loss metrics are means over the ranks.  ``mb_constraint`` and
    ``act_pspec`` are JAX's signature (``act_pspec`` from
    ``ShardingRules.act_pspec``): they pin GSPMD layouts, which the port's
    explicit per-rank layout does not have, so they are accepted and not
    read."""
    del mb_constraint, act_pspec
    group, n_data, my = _data_parallel(mesh)
    update = _make_update(tx, lr_schedule, symog_cfg)
    if loss_fn is None:
        def loss_fn(params, batch):  # noqa: F811 — default LM loss
            return lm_train_loss(params, batch, cfg, compute_dtype=compute_dtype)

    if cast_params:
        # mixed precision: fp32 master weights, a compute-dtype copy made
        # once per step for the forward/backward (grads come back fp32)
        base_loss_fn = loss_fn

        def loss_fn(params, batch):  # noqa: F811
            cparams = tree_map(lambda p: p.to(compute_dtype)
                               if p.dtype == torch.float32 and p.ndim >= 1 else p, params)
            return base_loss_fn(cparams, batch)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        batch = _my_rows(_on_device(batch, state.params), n_data, my)
        _, metrics, grads = _accum_grads(loss_fn, state.params, batch, accum_steps)
        grads = _mean_over(grads, group, n_data)
        metrics = dict(_mean_over(metrics, group, n_data))
        metrics["grad_norm"] = global_norm(grads)
        params, opt_state, lr, lam, stats = update(state.params, grads, state.opt_state,
                                                   state.symog, state.step)
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
