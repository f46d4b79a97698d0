"""chip_smoke.py phase 12c's VGG7 recipe in the JAX package, jitted, on the
CPU: VGG7 at full width on CIFAR-shaped synthetic images (32x32x3, 10
classes, snr 0.6, data seed 1), 120 float steps of SGD-Nesterov (momentum
0.9) then 220 SYMOG 2-bit steps, linear lr 0.02 -> 0.002 over the SYMOG
steps, from ``cnn_init(jax.random.PRNGKey(seed))``.  Prints one JSON line:
the losses every 10 / 20 steps, the three accuracies on 10 held-out
batches and the relative quantization errors.  ``--save-init`` writes the
init as .npz for scripts/vgg7_recipe.py's ``--init-npz``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/vgg7_recipe_jax.py --batch 32 \\
        --save-init /tmp/vgg7_init.npz"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro import core, optim
from repro.data import SyntheticImages, SyntheticImagesConfig
from repro.models.cnn import PAPER_CNNS, cnn_init
from repro.train import CNNTrainState, make_cnn_eval, make_cnn_train_step

FLOAT_STEPS, SYMOG_STEPS = 120, 220


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-init", default="")
    args = ap.parse_args()
    cfg = PAPER_CNNS["vgg7"]
    data = SyntheticImages(SyntheticImagesConfig(n_classes=10, hw=32, channels=3,
                                                 global_batch=args.batch, snr=0.6, seed=1))
    params, bn = cnn_init(jax.random.PRNGKey(args.seed), cfg)
    if args.save_init:
        np.savez(args.save_init, **{f"{kind}/{layer}/{name}": np.asarray(v)
                                    for kind, tree in (("params", params), ("bn", bn))
                                    for layer, leaves in tree.items()
                                    for name, v in leaves.items()})
    tx = optim.sgd(momentum=0.9, nesterov=True)
    lr = core.linear_lr(0.02, 0.002, SYMOG_STEPS)
    t0 = time.time()
    step_f = jax.jit(make_cnn_train_step(cfg, tx, lr))
    st = CNNTrainState(params, bn, tx.init(params), None, jnp.zeros((), jnp.int32))
    fl = []
    for _ in range(FLOAT_STEPS):
        st, m = step_f(st, next(data))
        fl.append(float(m["loss"]))
    scfg = core.SymogConfig(n_bits=2, total_steps=SYMOG_STEPS)
    sst = core.symog_init(st.params, scfg)
    step_s = jax.jit(make_cnn_train_step(cfg, tx, lr, symog_cfg=scfg))
    st2 = CNNTrainState(st.params, st.bn_state, tx.init(st.params), sst,
                        jnp.zeros((), jnp.int32))
    sl = []
    for _ in range(SYMOG_STEPS):
        st2, m = step_s(st2, next(data))
        sl.append(float(m["loss"]))
    ev = make_cnn_eval(cfg)

    def acc(p, b):
        return float(np.mean([float(ev(p, b, data.peek(50_000 + i))) for i in range(10)]))

    naive = core.symog_init(st.params, scfg)
    print(json.dumps({
        "impl": "jax", "batch": args.batch, "seed": args.seed,
        "float_loss_every_10": fl[::10] + [fl[-1]], "symog_loss_every_20": sl[::20] + [sl[-1]],
        "acc_float": acc(st.params, st.bn_state),
        "acc_symog_2bit": acc(core.quantize_tree(st2.params, sst, scfg), st2.bn_state),
        "acc_naive_postquant": acc(core.quantize_tree(st.params, naive, scfg), st.bn_state),
        "rel_quant_error": float(core.quant_error_metrics(st2.params, sst, scfg)
                                 ["rel_quant_error"]),
        "rel_quant_error_float": float(core.quant_error_metrics(st.params, naive, scfg)
                                       ["rel_quant_error"]),
        "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
