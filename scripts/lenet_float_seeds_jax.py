"""The float stage of scripts/lenet_float_seeds.py from the JAX package's
own init (``cnn_init(jax.random.PRNGKey(seed))``), as tests/test_system.py
runs it, jitted, on the CPU.  The same data, optimizer and schedule; the
same JSON lines.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lenet_float_seeds_jax.py --seeds 8"""
from __future__ import annotations

import argparse
import json
import math

import jax
import jax.numpy as jnp
import numpy as np

from repro import core, optim
from repro.data import SyntheticImages, SyntheticImagesConfig
from repro.models.cnn import CNNConfig, cnn_init
from repro.train import CNNTrainState, make_cnn_eval, make_cnn_train_step

FLOAT_STEPS, TOTAL, SHOW = 120, 220, (1, 10, 30, 60, 120)
CHANCE = math.log(10.0)


def float_stage(seed: int) -> dict:
    cfg = CNNConfig("lenet", "lenet5", in_channels=1, n_classes=10, input_hw=28)
    data = SyntheticImages(SyntheticImagesConfig(n_classes=10, hw=28, channels=1,
                                                 global_batch=64, snr=0.6, seed=1))
    params, bn = cnn_init(jax.random.PRNGKey(seed), cfg)
    tx = optim.sgd(momentum=0.9, nesterov=True)
    step = jax.jit(make_cnn_train_step(cfg, tx, core.linear_lr(0.02, 0.002, TOTAL)))
    st = CNNTrainState(params, bn, tx.init(params), None, jnp.zeros((), jnp.int32))
    losses = []
    for _ in range(FLOAT_STEPS):
        st, m = step(st, next(data))
        losses.append(float(m["loss"]))
    ev = make_cnn_eval(cfg)
    acc = float(np.mean([ev(st.params, st.bn_state, data.peek(50_000 + i))
                         for i in range(10)]))
    return {"seed": seed, "device": "cpu",
            "loss_at": {s: losses[s - 1] for s in SHOW}, "loss_max": max(losses),
            "acc_float": acc, "diverged": not losses[-1] < 0.5 * CHANCE}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8, help="seeds 0 .. n-1")
    args = ap.parse_args()
    rows = [float_stage(s) for s in range(args.seeds)]
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"impl": "jax", "device": "cpu", "seeds": args.seeds,
                      "diverged": [r["seed"] for r in rows if r["diverged"]]}))


if __name__ == "__main__":
    main()
