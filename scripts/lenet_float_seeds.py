"""Float stage of tests/test_system.py's LeNet-5 recipe in the port, once per
init seed: SGD-Nesterov (momentum 0.9), linear lr 0.02 -> 0.002 over 220
steps, 120 steps of batch 64 from SyntheticImages (28x28x1, snr 0.6, data
seed 1).  Prints one JSON line per seed (the loss at a few steps, the
largest loss, held-out accuracy) and a summary line.  Says whether the
recipe's float stage is stable across draws of the init; its counterpart
from the JAX package's init is scripts/lenet_float_seeds_jax.py.

    PYTHONPATH=src python scripts/lenet_float_seeds.py --device cpu --seeds 8
    PYTHONPATH=src python scripts/lenet_float_seeds.py --device cuda --seeds 8

A draw of ``cnn_init(seed)`` depends on the generator's device: seed s on
the card is not seed s on the CPU."""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

FLOAT_STEPS, TOTAL, SHOW = 120, 220, (1, 10, 30, 60, 120)
CHANCE = math.log(10.0)  # a 10-way loss at chance


def float_stage(seed: int, device: str) -> dict:
    from repro_torch import core, optim
    from repro_torch.data import SyntheticImages, SyntheticImagesConfig
    from repro_torch.models import PAPER_CNNS, cnn_init
    from repro_torch.train import CNNTrainState, make_cnn_eval, make_cnn_train_step

    cfg = PAPER_CNNS["lenet5"]
    data = SyntheticImages(SyntheticImagesConfig(n_classes=10, hw=28, channels=1,
                                                 global_batch=64, snr=0.6, seed=1))
    params, bn = cnn_init(seed, cfg, device=device)
    tx = optim.sgd(momentum=0.9, nesterov=True)
    step = make_cnn_train_step(cfg, tx, core.linear_lr(0.02, 0.002, TOTAL))
    st = CNNTrainState(params, bn, tx.init(params), None, 0)
    losses = []
    for _ in range(FLOAT_STEPS):
        st, m = step(st, next(data))
        losses.append(float(m["loss"]))
    ev = make_cnn_eval(cfg)
    acc = float(np.mean([ev(st.params, st.bn_state, data.peek(50_000 + i)).item()
                         for i in range(10)]))
    return {"seed": seed, "device": device,
            "loss_at": {s: losses[s - 1] for s in SHOW}, "loss_max": max(losses),
            "acc_float": acc, "diverged": not losses[-1] < 0.5 * CHANCE}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=8, help="seeds 0 .. n-1")
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(2)
    rows = [float_stage(s, args.device) for s in range(args.seeds)]
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"impl": "torch", "device": args.device, "seeds": args.seeds,
                      "diverged": [r["seed"] for r in rows if r["diverged"]]}))


if __name__ == "__main__":
    main()
