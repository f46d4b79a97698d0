"""Paper Figure 3: weight-distribution evolution under SYMOG (the
counterpart of ``benchmarks/fig3_distributions.py``).

Tracks per-mode (count, std) of a LeNet-5 layer at several steps: initially
unimodal around 0, converging to 3 separated Gaussians at {-Δ, 0, +Δ} whose
stds shrink as λ grows exponentially.

    PYTHONPATH=src python -m repro_torch.experiments.fig3_distributions [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import core, optim
from repro_torch.data import SyntheticImages, SyntheticImagesConfig
from repro_torch.device import resolve_device
from repro_torch.experiments.common import emit, experiment_main
from repro_torch.models.cnn import PAPER_CNNS, cnn_init
from repro_torch.nn.tree import tree_map
from repro_torch.train import CNNTrainState, make_cnn_train_step


def run(device=None) -> None:
    dev = resolve_device(device)
    cfg = PAPER_CNNS["lenet5"]
    data = SyntheticImages(
        SyntheticImagesConfig(n_classes=10, hw=28, channels=1, global_batch=64, snr=0.5, seed=41)
    )
    params, bn = cnn_init(0, cfg, device=dev)
    tx = optim.sgd(momentum=0.9, nesterov=True)
    TOTAL = 300
    lr = core.linear_lr(0.02, 0.002, TOTAL)

    # pretrain float (unimodal init, as in the paper: weight decay pretrain)
    step_f = make_cnn_train_step(cfg, tx, lr)
    st = CNNTrainState(params, bn, tx.init(params), None, 0)
    for _ in range(120):
        st, _ = step_f(st, next(data))

    scfg = core.SymogConfig(n_bits=2, total_steps=TOTAL)
    sst = core.symog_init(st.params, scfg)
    step_s = make_cnn_train_step(cfg, tx, lr, symog_cfg=scfg)
    p = tree_map(torch.clone, st.params)  # the fused update writes in place
    st2 = CNNTrainState(p, st.bn_state, tx.init(p), sst, 0)

    layer = "conv2/kernel"
    f = sst.f["conv2"]["kernel"]
    delta = float(core.delta_from_f(f))
    snapshots = {0: st2.params["conv2"]["kernel"].clone()}
    for i in range(TOTAL):
        st2, _ = step_s(st2, next(data))
        if i + 1 in (TOTAL // 4, TOTAL // 2, TOTAL):
            snapshots[i + 1] = st2.params["conv2"]["kernel"].clone()

    for step, w in snapshots.items():
        s = core.mode_stats(w, delta, 2)
        counts = [int(c) for c in s["count"].cpu().tolist()]
        stds = np.round(np.asarray(s["std"].cpu()), 4).tolist()
        emit(
            f"fig3_{layer.replace('/', '_')}_step{step}",
            0.0,
            f"delta={delta};counts={counts};stds={stds}",
        )
    final_std = float(core.mode_stats(st2.params["conv2"]["kernel"], delta, 2)["std"].max())
    emit(
        "fig3_modes_collapsed",
        0.0,
        f"max_mode_std={final_std:.5f};delta={delta};pass={final_std < delta / 8}",
    )


if __name__ == "__main__":
    experiment_main(run)
