"""Quickstart: the paper's Algorithm 1 end to end (the counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Pretrains a float LeNet-5 on a synthetic MNIST-like stream, runs SYMOG
(2-bit) fine-tuning, and compares float / SYMOG-quantized / naively
quantized test accuracy: the Table-1 experiment in miniature.  On the card
each SYMOG step is one ``symog_update`` launch per quantizable leaf.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import core, optim
from repro_torch.data import SyntheticImages, SyntheticImagesConfig
from repro_torch.device import resolve_device
from repro_torch.models.cnn import PAPER_CNNS, cnn_init
from repro_torch.nn.tree import flatten_with_paths, tree_map
from repro_torch.train import CNNTrainState, make_cnn_eval, make_cnn_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the card (required)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PAPER_CNNS["lenet5"]
    data = SyntheticImages(SyntheticImagesConfig(
        n_classes=10, hw=28, channels=1, global_batch=64, snr=0.6))
    params, bn = cnn_init(0, cfg, device=dev)
    tx = optim.sgd(momentum=0.9, nesterov=True)  # the paper's optimizer
    TOTAL = 250
    lr = core.linear_lr(0.02, 0.002, TOTAL)  # paper §3.5: linear 0.01→0.001

    # 1) float pretrain (Alg.1 input: "pretrained model M_Θ")
    step = make_cnn_train_step(cfg, tx, lr)
    st = CNNTrainState(params, bn, tx.init(params), None, 0)
    for _ in range(120):
        st, m = step(st, next(data))
    print(f"float pretrain acc: {float(m['acc']):.3f}")

    # 2) SYMOG fine-tune: Δ_l search → λ·∂R/∂w → clip, every step
    scfg = core.SymogConfig(n_bits=2, total_steps=TOTAL, lambda0=10.0, alpha=9.0)
    sst = core.symog_init(st.params, scfg)  # Alg.1 l.2-5
    print("per-layer f (Δ=2^-f):",
          {p: int(f.max()) for p, f in flatten_with_paths(sst.f) if sst.mask[p]})
    qstep = make_cnn_train_step(cfg, tx, lr, symog_cfg=scfg)
    # the fused update writes the params in place: SYMOG trains a copy
    st2 = CNNTrainState(tree_map(torch.clone, st.params), st.bn_state, tx.init(st.params), sst, 0)
    for _ in range(TOTAL):
        st2, m = qstep(st2, next(data))
    qm = core.quant_error_metrics(st2.params, sst, scfg)
    print(f"after SYMOG: acc {float(m['acc']):.3f}, "
          f"rel quant error {float(qm['rel_quant_error']):.2e}")

    # 3) hard post-quantization (Alg.1 l.21-23) + comparison
    ev = make_cnn_eval(cfg)
    test = [data.peek(10_000 + i) for i in range(16)]

    def acc(p, b):
        return float(np.mean([float(ev(p, b, t)) for t in test]))

    q_symog = core.quantize_tree(st2.params, sst, scfg)
    q_naive = core.quantize_tree(st.params, core.symog_init(st.params, scfg), scfg)
    out = {"float": acc(st.params, st.bn_state), "symog": acc(q_symog, st2.bn_state),
           "naive": acc(q_naive, st.bn_state), "rel_quant_error": float(qm["rel_quant_error"])}
    print(f"test acc — float: {out['float']:.3f}  SYMOG 2-bit: {out['symog']:.3f}  "
          f"naive 2-bit: {out['naive']:.3f}")
    return out


if __name__ == "__main__":
    main()
