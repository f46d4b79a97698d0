"""Shared scaffolding of the paper's experiments: the paper's protocol at
reduced scale (the counterpart of ``benchmarks/common.py``).

Every Table-1 experiment runs the three-way comparison the paper runs:
  float baseline  vs  SYMOG N-bit (train→post-quantize)  vs  naive post-quant
on a deterministic synthetic stand-in for the dataset.  The numbers are
RELATIVE reproductions: the ordering / gap pattern is the claim under test,
not absolute CIFAR error rates.  ``emit`` prints JAX's CSV line,
``name,us_per_call,derived``, and keeps it in ``EMITTED``; nothing is
written to disk and nothing is gated here.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import core, optim
from repro_torch.data import SyntheticImages, SyntheticImagesConfig
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNNConfig, cnn_init
from repro_torch.nn.tree import tree_map
from repro_torch.train import CNNTrainState, make_cnn_eval, make_cnn_train_step

EMITTED: List[Tuple[str, float, str]] = []


def run_symog_protocol(
    cnn_cfg: CNNConfig,
    *,
    data_cfg: SyntheticImagesConfig,
    pretrain_steps: int,
    symog_steps: int,
    n_bits: int = 2,
    lr0: float = 0.02,
    seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Returns error rates: float / symog_quantized / naive_quantized, the
    relative quantization errors and wall time, as JAX's; and the losses of
    both stages, ``losses_float`` / ``losses_symog``.  The weights are the
    port's ``cnn_init(seed)``.  On the card each SYMOG step is one
    ``symog_update`` per quantizable leaf (the float stage composes)."""
    dev = resolve_device(device)
    t0 = time.time()
    data = SyntheticImages(data_cfg)
    params, bn = cnn_init(seed, cnn_cfg, device=dev)
    tx = optim.sgd(momentum=0.9, nesterov=True)
    lr = core.linear_lr(lr0, lr0 / 10, pretrain_steps + symog_steps)

    # 1) float pretrain (paper: "initialize with an accurate fp model")
    step_f = make_cnn_train_step(cnn_cfg, tx, lr)
    st = CNNTrainState(params, bn, tx.init(params), None, 0)
    losses_f = []
    for _ in range(pretrain_steps):
        st, m = step_f(st, next(data))
        losses_f.append(m["loss"])

    # 2) SYMOG finetune (Alg. 1), on a copy: the fused update writes in place
    scfg = core.SymogConfig(n_bits=n_bits, total_steps=symog_steps)
    sst = core.symog_init(st.params, scfg)
    step_s = make_cnn_train_step(cnn_cfg, tx, lr, symog_cfg=scfg)
    p = tree_map(torch.clone, st.params)
    st2 = CNNTrainState(p, st.bn_state, tx.init(p), sst, 0)
    losses_s = []
    for _ in range(symog_steps):
        st2, m = step_s(st2, next(data))
        losses_s.append(m["loss"])

    # 3) evaluate: float vs SYMOG-post-quant vs naive-post-quant
    ev = make_cnn_eval(cnn_cfg)
    test = [data.peek(100_000 + i) for i in range(16)]

    def err(p, b):
        return 1.0 - float(np.mean([float(ev(p, b, t)) for t in test]))

    q_symog = core.quantize_tree(st2.params, sst, scfg)
    naive_sst = core.symog_init(st.params, scfg)
    q_naive = core.quantize_tree(st.params, naive_sst, scfg)

    qm_symog = core.quant_error_metrics(st2.params, sst, scfg)
    qm_naive = core.quant_error_metrics(st.params, naive_sst, scfg)
    return {
        "err_float": err(st.params, st.bn_state),
        "err_symog_q": err(q_symog, st2.bn_state),
        "err_naive_q": err(q_naive, st.bn_state),
        "rel_qerr_symog": float(qm_symog["rel_quant_error"]),
        "rel_qerr_naive": float(qm_naive["rel_quant_error"]),
        "seconds": time.time() - t0,
        "losses_float": [float(x) for x in losses_f],
        "losses_symog": [float(x) for x in losses_s],
    }


def emit(name: str, us_per_call: float, derived: str) -> None:
    """The CSV contract of the JAX package's benchmarks: name,us_per_call,derived."""
    EMITTED.append((name, us_per_call, derived))
    print(f"{name},{us_per_call:.1f},{derived}")


def experiment_main(run: Callable, argv=None) -> None:
    """``python -m repro_torch.experiments.<name> [--device cpu]``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the card (required)")
    run(device=ap.parse_args(argv).device)
