"""chip_smoke.py phase 12c's VGG7 recipe in the port, on the CPU or the card:
the schedule of scripts/vgg7_recipe_jax.py (120 float steps, 220 SYMOG
2-bit steps, linear lr 0.02 -> 0.002, VGG7 at full width, 32x32x3
synthetic images, snr 0.6, data seed 1), from ``cnn_init(seed)`` or, with
``--init-npz``, from the JAX package's init that script saved.  Prints the
same JSON line.

    PYTHONPATH=src python scripts/vgg7_recipe.py --device cpu --batch 32 \\
        --init-npz /tmp/vgg7_init.npz"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

FLOAT_STEPS, SYMOG_STEPS = 120, 220


def main():
    from repro_torch import core, optim
    from repro_torch.data import SyntheticImages, SyntheticImagesConfig
    from repro_torch.models import PAPER_CNNS, cnn_init
    from repro_torch.nn.tree import tree_map
    from repro_torch.train import CNNTrainState, make_cnn_eval, make_cnn_train_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-npz", default="")
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(4)
    cfg = PAPER_CNNS["vgg7"]
    data = SyntheticImages(SyntheticImagesConfig(n_classes=10, hw=32, channels=3,
                                                 global_batch=args.batch, snr=0.6, seed=1))
    params, bn = cnn_init(args.seed, cfg, device=args.device)
    if args.init_npz:
        z = np.load(args.init_npz)
        for key in z.files:
            kind, layer, name = key.split("/")
            tree = params if kind == "params" else bn
            tree[layer][name] = torch.from_numpy(z[key].copy()).to(args.device)
    tx = optim.sgd(momentum=0.9, nesterov=True)
    lr = core.linear_lr(0.02, 0.002, SYMOG_STEPS)
    t0 = time.time()
    step_f = make_cnn_train_step(cfg, tx, lr)
    st = CNNTrainState(params, bn, tx.init(params), None, 0)
    fl = []
    for _ in range(FLOAT_STEPS):
        st, m = step_f(st, next(data))
        fl.append(float(m["loss"]))
    scfg = core.SymogConfig(n_bits=2, total_steps=SYMOG_STEPS)
    sst = core.symog_init(st.params, scfg)
    step_s = make_cnn_train_step(cfg, tx, lr, symog_cfg=scfg)
    p = tree_map(torch.clone, st.params)  # the fused update writes in place
    st2 = CNNTrainState(p, st.bn_state, tx.init(p), sst, 0)
    sl = []
    for _ in range(SYMOG_STEPS):
        st2, m = step_s(st2, next(data))
        sl.append(float(m["loss"]))
    ev = make_cnn_eval(cfg)

    def acc(p, b):
        return float(np.mean([ev(p, b, data.peek(50_000 + i)).item() for i in range(10)]))

    naive = core.symog_init(st.params, scfg)
    print(json.dumps({
        "impl": "torch", "device": args.device, "batch": args.batch, "seed": args.seed,
        "init": "jax npz" if args.init_npz else "cnn_init",
        "float_loss_every_10": fl[::10] + [fl[-1]], "symog_loss_every_20": sl[::20] + [sl[-1]],
        "acc_float": acc(st.params, st.bn_state),
        "acc_symog_2bit": acc(core.quantize_tree(st2.params, sst, scfg), st2.bn_state),
        "acc_naive_postquant": acc(core.quantize_tree(st.params, naive, scfg), st.bn_state),
        "rel_quant_error": core.quant_error_metrics(st2.params, sst, scfg)[
            "rel_quant_error"].item(),
        "rel_quant_error_float": core.quant_error_metrics(st.params, naive, scfg)[
            "rel_quant_error"].item(),
        "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
