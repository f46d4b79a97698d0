"""Paper Figure 4: mode-switch rate per step, with vs without clipping (the
counterpart of ``benchmarks/fig4_adaptation.py``).

The paper reports ~22% early switch rate WITH clipping vs ~8% without
(Layer-7, VGG11/CIFAR-100): clipping promotes self-reliant adaptation.
We measure mean switch rates over the first and second half of SYMOG
training for both settings.  On the card the clipped arm is one
``symog_update`` per quantizable leaf a step; the unclipped one composes
(the fused update computes the clipped step only).

    PYTHONPATH=src python -m repro_torch.experiments.fig4_adaptation [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import core, optim
from repro_torch.data import SyntheticImages, SyntheticImagesConfig
from repro_torch.device import resolve_device
from repro_torch.experiments.common import emit, experiment_main
from repro_torch.models.cnn import cnn_init, reduced_cnn
from repro_torch.nn.tree import flatten_with_paths, tree_map
from repro_torch.train import CNNTrainState, make_cnn_train_step


def run(device=None) -> None:
    dev = resolve_device(device)
    # Figure 4 is measured on VGG11 / CIFAR-100: a hard task with live
    # gradients throughout training (a solved task has no task-gradient
    # pressure and weights never leave their modes).  Reduced-width VGG11
    # on the 100-class stream.
    cfg = reduced_cnn("vgg11", 0.125)
    data = SyntheticImages(
        SyntheticImagesConfig(n_classes=100, hw=32, channels=3, global_batch=32, snr=1.0, seed=51)
    )
    params, bn = cnn_init(0, cfg, device=dev)
    tx = optim.sgd(momentum=0.9, nesterov=True)
    TOTAL = 120
    lr = core.constant(0.01)

    # paper protocol: Figure 4 is recorded during SYMOG training that is
    # INITIALIZED from a pretrained float model
    pre = make_cnn_train_step(cfg, tx, lr)
    st0 = CNNTrainState(params, bn, tx.init(params), None, 0)
    for _ in range(60):
        st0, _ = pre(st0, next(data))
    params, bn = st0.params, st0.bn_state

    def measure(clip: bool):
        scfg = core.SymogConfig(n_bits=2, total_steps=TOTAL, clip=clip)
        sst = core.symog_init(params, scfg)
        step = make_cnn_train_step(cfg, tx, lr, symog_cfg=scfg)
        p = tree_map(torch.clone, params)  # the fused update writes in place
        st = CNNTrainState(p, bn, tx.init(p), sst, 0)
        prev = core.mode_tree(st.params, sst, scfg)
        rates = []
        for _ in range(TOTAL):
            st, _ = step(st, next(data))
            cur = core.mode_tree(st.params, sst, scfg)
            r = core.tree_switch_rates(prev, cur)
            rates.append(torch.stack([v for _, v in flatten_with_paths(r)]))
            prev = cur
        rates = [float(np.mean(x.cpu().numpy(), dtype=np.float64)) for x in rates]
        half = TOTAL // 2
        return float(np.mean(rates[:half])), float(np.mean(rates[half:]))

    early_c, late_c = measure(True)
    early_n, late_n = measure(False)
    emit("fig4_switch_rate_clip_early", 0.0, f"rate={early_c:.4f}")
    emit("fig4_switch_rate_clip_late", 0.0, f"rate={late_c:.4f}")
    emit("fig4_switch_rate_noclip_early", 0.0, f"rate={early_n:.4f}")
    emit("fig4_switch_rate_noclip_late", 0.0, f"rate={late_n:.4f}")
    emit(
        "fig4_claim_C3",
        0.0,
        f"clip_gt_noclip={early_c > early_n};ratio={early_c / max(early_n, 1e-9):.2f}",
    )


if __name__ == "__main__":
    experiment_main(run)
