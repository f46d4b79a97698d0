"""Training launcher of the port: the end-to-end entry point (the counterpart of
``repro/launch/train.py``, same flags and report, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internlm2-1.8b --reduced --device cpu --steps 300 --symog \\
        --ckpt-dir /tmp/run1 [--resume]

Without ``--device`` it runs on the card (and refuses to start without one).
Wires together: config registry → synthetic data (checkpointable) → train
step (SYMOG on/off) → async checkpoints → straggler monitor.  The optimizer
is JAX's, ``chain(clip_by_global_norm(1.0), sgd(momentum=0.9,
nesterov=True))``: with ``--symog`` on the card its update is the fused
route, one norm pass and one ``symog_update`` per quantizable leaf a step
(``train/trainer.py``).  Compute is fp32 with ``--reduced``, bf16 without.

A checkpoint holds the whole ``TrainState`` and ``{"data": <stream
state>}`` in the JAX package's format, so either launcher resumes from the
other's ``--ckpt-dir``.  ``--mesh DxM`` trains on D·M ranks started by
``torchrun`` (``python -m torch.distributed.run --nproc-per-node D·M -m
repro_torch.launch.train ... --mesh DxM``), as JAX's launcher places its
state with ``state_shardings``: every rank builds the whole seeded state
(``symog_init`` on the whole leaves), keeps its pieces under
``cfg.sharding_profile`` (``train.sharding``: tensor-parallel pieces over
the M model ranks, FSDP's ``embed`` split over the D data ranks under
``fsdp_tp``, experts over the EP axes), draws the same global batch and
trains on its data rank's rows; rank 0 prints and writes the checkpoints
(each leaf gathered to it, JAX's format), and a resume cuts them again.
The weights are the port's own seeded init (``models.init_lm``), not the
JAX package's; a resumed run continues from the checkpoint's.  whisper's
and paligemma's steps add stub frames / patches (the serve launcher's:
N(0, 0.01) at d_model, from a ``torch.Generator`` seeded ``--seed`` + 1 +
the step, so a resumed run draws the same ones); JAX's launcher has no
frontend stubs and trains the token-only families alone.

Each step is timed to the card's completion (a synchronize before the
monitor stops), so the straggler monitor sees device time.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import core, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.data import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import StepTimeMonitor, collectives
from repro_torch.launch.mesh import close_distributed, make_host_mesh, world_from_env
from repro_torch.models import init_lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.sharding import shard_train_state, train_layout


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--symog", action="store_true", help="enable SYMOG QAT")
    ap.add_argument("--n-bits", type=int, default=2)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM (data, model) mesh of D·M torchrun ranks")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the card (required)")
    return ap


def _frontend_stub(cfg: ModelConfig, batch: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """``batch`` with whisper's frames / paligemma's patches for its rows,
    drawn from ``seed`` (the other families' batches as they are)."""
    stub = {"encdec": ("frames", cfg.encoder_len), "vlm": ("patches", cfg.prefix_len)}
    if cfg.family not in stub:
        return batch
    name, n = stub[cfg.family]
    rows = next(iter(batch.values())).shape[0]
    gen = torch.Generator().manual_seed(seed)
    return dict(batch, **{name: (torch.randn((rows, n, cfg.d_model), generator=gen) * 0.1)
                          .numpy()})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: ModelConfig, args: argparse.Namespace,
        on_step: Optional[Callable[[int, Any, Dict[str, Any]], None]] = None,
        mesh=None) -> Dict[str, Any]:
    """The launcher's body on ``cfg`` (a registry config, or one cut in depth
    by the caller).  Prints JAX's lines; returns ``losses``, ``step_s`` (each
    step to the card's completion), ``clip_scales`` and ``state`` of the
    steps this call ran, ``start`` (the resumed step, else 0), the
    collectives a step ran (``collectives_per_step`` /
    ``collective_bytes_per_step``, by kind) and ``peak_bytes`` (the card's
    peak allocation of this process; 0 on the CPU).  Under torchrun rank 0
    also prints every rank's step ms and peak bytes and the collectives.
    ``on_step(i, state, metrics)`` runs after each step (``state`` holds
    this rank's pieces).  ``mesh``: the (data, model) mesh of the ranks."""
    dev = resolve_device(args.device)
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
    ))
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    lr_sched = core.linear_lr(args.lr, args.lr / 10, args.steps)
    symog_cfg = (core.SymogConfig(n_bits=args.n_bits, total_steps=args.steps)
                 if args.symog else None)
    compute_dtype = torch.float32 if args.reduced else torch.bfloat16
    step_fn = make_train_step(cfg, tx, lr_sched, symog_cfg=symog_cfg, accum_steps=args.accum,
                              compute_dtype=compute_dtype, mesh=mesh)

    # the whole state first: f from the whole leaves, as JAX's
    state = init_train_state(init_lm(args.seed, cfg, device=dev), tx, symog_cfg)
    layout = train_layout(cfg, mesh) if mesh is not None else None
    place = {} if layout is None else {"mesh": mesh, "rules": layout.rules,
                                       "spec_fn": layout.spec_fn}
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, meta, start = ckpt.restore(state, device=dev, **place)
        data.load_state_dict(meta["data"])
        print(f"resumed from step {start}")
    elif layout is not None:
        state = shard_train_state(state, layout)
    save_kw = {} if layout is None else {"mesh": mesh, "spec_fn": layout.spec_fn}

    out: Dict[str, Any] = {"losses": [], "step_s": [], "clip_scales": [], "start": start}
    mon = StepTimeMonitor()
    calls0, bytes0 = dict(collectives.stats["calls"]), dict(collectives.stats["bytes"])
    for i in range(start, args.steps):
        batch = _frontend_stub(cfg, next(data), args.seed + 1 + i)
        mon.start()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
        slow = mon.stop()
        out["losses"].append(float(metrics["loss"]))
        out["clip_scales"].append(float(metrics["clip_scale"]))
        if on_step is not None:
            on_step(i, state, metrics)
        if i % args.log_every == 0 or i == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f}"
                  + (f" λ {m['symog_lambda']:.1f}" if "symog_lambda" in m else "")
                  + (" [straggler]" if slow else ""), flush=True)
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, state, metadata={"data": data.state_dict()}, **save_kw)
    n = max(1, args.steps - start)
    out["collectives_per_step"] = {
        kind: (c - calls0.get(kind, 0)) / n for kind, c in collectives.stats["calls"].items()}
    out["collective_bytes_per_step"] = {
        kind: (b - bytes0.get(kind, 0)) / n for kind, b in collectives.stats["bytes"].items()}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if ckpt:
        ckpt.save(args.steps, state, metadata={"data": data.state_dict()}, blocking=True,
                  **save_kw)

    if symog_cfg is not None:
        qm = core.quant_error_metrics(state.params, state.symog, symog_cfg, shards=layout)
        print(f"final rel quant error: {float(qm['rel_quant_error']):.2e} "
              f"(ce floor {data.ce_floor():.3f})")
    print(f"straggler fraction: {mon.straggler_fraction():.3f}")
    out["state"] = state
    return out


def main(argv=None) -> Dict[str, Any]:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        d, m = (int(v) for v in args.mesh.lower().split("x"))
    except ValueError:
        ap.error(f"--mesh must be DxM (e.g. 2x1), got {args.mesh!r}")
    rank, world, _, _ = world_from_env()
    if d * m != world:
        ap.error(f"--mesh {d}x{m} needs {d * m} devices, have {world}")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if world == 1:
        return run(cfg, args)
    mesh = make_host_mesh((d, m), device=args.device)
    # every rank trains; rank 0 alone prints
    out = contextlib.nullcontext() if rank == 0 else contextlib.redirect_stdout(io.StringIO())
    with out:
        res = run(cfg, args, mesh=mesh)
    import torch.distributed as dist

    every = [None] * world
    dist.all_gather_object(every, (res["losses"], res["step_s"], res["peak_bytes"]))
    if rank == 0:
        print(f"ranks' losses equal: {all(e[0] == every[0][0] for e in every)}")
        print("ranks' step ms: " + json.dumps([[round(1e3 * t, 1) for t in e[1]] for e in every]))
        print("ranks' peak bytes: " + json.dumps([e[2] for e in every]))
        print("collectives per step: " + json.dumps(
            {k: {"calls": v, "bytes": res["collective_bytes_per_step"][k]}
             for k, v in sorted(res["collectives_per_step"].items()) if v}))
    close_distributed()
    return res


if __name__ == "__main__":
    main()
