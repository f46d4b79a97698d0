"""End-to-end LM training with SYMOG QAT as a first-class feature
(the counterpart of ``examples/train_lm_symog.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm_symog [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm_symog --params100m --steps 300

Wraps the launcher's pieces: config → synthetic data → train step (SYMOG
on, ``chain(clip_by_global_norm(1.0), sgd(momentum=0.9))``; on the card
one norm pass and one ``symog_update`` per quantizable leaf a step) →
async checkpoints → resume.  The default ~10M-parameter model runs the same
code path as the 100M one at a CPU-friendly width.  ``--ckpt-dir``
defaults to ``symog_lm_run`` under the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import core, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import StepTimeMonitor
from repro_torch.models import init_lm
from repro_torch.models.config import ModelConfig
from repro_torch.nn.tree import tree_size
from repro_torch.train import init_train_state, make_train_step


def small_lm(params100m: bool) -> ModelConfig:
    if params100m:  # ~100M params
        return ModelConfig(name="lm100m", family="decoder", n_layers=8,
                           d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                           d_ff=2048, vocab_size=32000, remat=False)
    return ModelConfig(name="lm10m", family="decoder", n_layers=4,
                       d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
                       d_ff=1024, vocab_size=4096, remat=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params100m", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "symog_lm_run"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the card (required)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = small_lm(args.params100m)
    params = init_lm(0, cfg, device=dev)
    print(f"model: {cfg.name} ({tree_size(params)/1e6:.1f}M params)")

    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, noise=0.05))
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9))
    scfg = core.SymogConfig(n_bits=2, total_steps=args.steps)  # λ0=10 (paper)
    step = make_train_step(cfg, tx, core.constant(0.05), symog_cfg=scfg,
                           compute_dtype=torch.float32)

    state = init_train_state(params, tx, scfg)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, meta, start = ckpt.restore(state, device=dev)
        data.load_state_dict(meta["data"])
        print(f"resumed from step {start}")

    mon = StepTimeMonitor()
    t0 = time.time()
    losses = []
    for i in range(start, args.steps):
        batch = next(data)
        mon.start()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))  # reads the loss: the step has finished
        mon.stop()
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"λ {float(metrics['symog_lambda']):.1f}", flush=True)
        if (i + 1) % 100 == 0:
            ckpt.save(i + 1, state, metadata={"data": data.state_dict()})
    ckpt.save(args.steps, state, metadata={"data": data.state_dict()}, blocking=True)

    qm = core.quant_error_metrics(state.params, state.symog, scfg)
    print(f"done in {time.time()-t0:.0f}s — rel quant error "
          f"{float(qm['rel_quant_error']):.2e} (stream CE floor {data.ce_floor():.3f}); "
          f"stragglers {mon.straggler_fraction():.2%}")
    return {"losses": losses, "rel_quant_error": float(qm["rel_quant_error"]), "state": state}


if __name__ == "__main__":
    main()
