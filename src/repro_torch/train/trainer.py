"""Training step factory (mirrors ``repro/train/trainer.py``): grads (with
optional microbatch accumulation) → SYMOG regularizer gradient (Alg. 1 l.15)
→ optimizer → weight clipping (l.17).

SYMOG integration is exactly the paper's update:
    w ← w − η(∂C/∂w + λ(step)·∂R/∂w) ;  w ← Clip(w, ±Δ(2^{N-1}−1))
with λ on its exponential schedule.  ``symog_cfg=None`` gives the float
baseline trainer.

Two routes compute the update (``kernels.dispatch.set_update_backend``):

  'composed' — the JAX trainer's order on whole trees: g + λ·reg_grad,
               ``tx.update``, ``apply_updates``, ``clip_tree``; new tensors.
  'fused'    — for the paper's optimizer only (``optim.sgd`` Nesterov, no
               weight decay, fp32 momentum, nothing chained) with clipping
               on: ONE ``symog_update`` per quantizable leaf, λ_eff = λ·2/M_l
               with M_l the whole (layer-stacked) leaf's count, updating w
               and its momentum IN PLACE; the other leaves (norm scales)
               take the same SGD math in torch.

'auto' takes 'fused' on the card when the optimizer allows it, 'composed'
otherwise; asking for 'fused' with another optimizer raises.  On the fused
route the state passed to the step is consumed: its tensors are updated.
Remat, the sharding hooks (``mb_constraint``, ``act_pspec``) and the CNN
trainer are not ported yet (ROADMAP).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import SymogConfig, SymogState, clip_tree, lambda_at, reg_grad, symog_init
from repro_torch.core.quantizer import delta_from_f
from repro_torch.kernels import dispatch
from repro_torch.kernels.symog_update import symog_update
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
    slices of the batch (activation memory of one microbatch), summed in
    fp32 and scaled by 1/accum, as the JAX package's ``lax.scan``."""
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
                "nesterov=True, weight_decay=0, fp32 momentum and nothing chained")
    return None


def composed_update(params, grads, opt_state, symog: Optional[SymogState],
                    symog_cfg: Optional[SymogConfig], tx: GradientTransformation, *,
                    lr: float, lam: Optional[float]):
    """The JAX trainer's update on whole trees: returns (params, opt_state)."""
    if symog_cfg is not None:
        rg = reg_grad(params, symog, symog_cfg)
        grads = tree_map(lambda g, r: g + lam * r.to(g.dtype), grads, rg)
    updates, opt_state = tx.update(grads, opt_state, params, lr=lr)
    params = apply_updates(params, updates)
    if symog_cfg is not None and symog_cfg.clip:
        params = clip_tree(params, symog, symog_cfg)
    return params, opt_state


def fused_update(params, grads, opt_state, symog: SymogState, symog_cfg: SymogConfig,
                 tx: GradientTransformation, *, lr: float, lam: float,
                 deltas: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None):
    """One ``symog_update`` per quantizable leaf, SGD-Nesterov in torch for
    the rest, all in place on the params and their momentum: returns the same
    (params, opt_state).  ``deltas`` caches each leaf's fp32 Δ by path, keyed on the
    identity of its f, so Δ is made on the device once per run."""
    why = _check_fusable(tx, symog_cfg)
    if why:
        raise ValueError(why)
    mu = tx.paper_sgd
    deltas = {} if deltas is None else deltas
    f_by_path = dict(flatten_with_paths(symog.f))
    v_by_path = dict(flatten_with_paths(opt_state))
    g_by_path = dict(flatten_with_paths(grads))

    with torch.no_grad():
        for path, w in flatten_with_paths(params):
            g, v = g_by_path[path].contiguous(), v_by_path[path]
            if not symog.mask[path]:  # norm scales: the same SGD-Nesterov math
                v.mul_(mu).add_(g)
                w.sub_(lr * (g + mu * v))
                continue
            f = f_by_path[path]
            if f.ndim != 0:
                raise NotImplementedError("per-expert Δ form of symog_update (ROADMAP Next (a))")
            cached = deltas.get(path)
            if cached is None or cached[0] is not f:
                cached = deltas[path] = (f, delta_from_f(f, device=w.device))
            symog_update(w, g, v, delta=cached[1], lam_eff=lam * 2.0 / w.numel(), lr=lr, mu=mu,
                         n_bits=symog_cfg.n_bits)
    return params, opt_state


def make_train_step(
    cfg: ModelConfig,
    tx: GradientTransformation,
    lr_schedule: Callable[[int], float],
    *,
    symog_cfg: Optional[SymogConfig] = None,
    accum_steps: int = 1,
    compute_dtype=torch.bfloat16,
    loss_fn: Optional[Callable] = None,
    cast_params: bool = False,
) -> Callable[[TrainState, Dict[str, Any]], Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (state, metrics)``; batch values may be
    numpy arrays or tensors.  metrics: ``loss``, ``ce``, ``grad_norm`` (0-d
    tensors on the params' device), ``lr`` and ``symog_lambda`` (floats).
    The update backend is pinned here (``dispatch.get_update_backend``)."""
    backend = dispatch.get_update_backend()
    why = _check_fusable(tx, symog_cfg)
    if backend == "fused" and why:
        raise ValueError(why)
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

    deltas: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        dev = tree_leaves(state.params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        _, metrics, grads = _accum_grads(loss_fn, state.params, batch, accum_steps)
        lr = lr_schedule(state.step)
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads)
        metrics["lr"] = lr
        lam = None
        if symog_cfg is not None:
            lam = lambda_at(symog_cfg, state.step)
            metrics["symog_lambda"] = lam
        route = dispatch.resolve_update_backend(dev, backend)
        if route == "fused" and not why:  # 'auto' with another optimizer composes
            params, opt_state = fused_update(state.params, grads, state.opt_state, state.symog,
                                             symog_cfg, tx, lr=lr, lam=lam, deltas=deltas)
        else:
            with torch.no_grad():
                params, opt_state = composed_update(state.params, grads, state.opt_state,
                                                    state.symog, symog_cfg, tx, lr=lr, lam=lam)
        return TrainState(params, opt_state, state.symog, state.step + 1), metrics

    return train_step
