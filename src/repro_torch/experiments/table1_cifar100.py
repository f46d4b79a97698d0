"""Paper Table 1, CIFAR-100 rows: VGG11 at reduced width (the counterpart of
``benchmarks/table1_cifar100.py``; VGG16 shares the code path).

Paper: VGG11 float 31.42% vs SYMOG 32.05% at 1/3 the training epochs of
BR/TWN.  The reduced-scale synthetic reproduction tests the ordering with a
100-class stream.

    PYTHONPATH=src python -m repro_torch.experiments.table1_cifar100 [--device cpu]
"""
from __future__ import annotations

from repro_torch.data import SyntheticImagesConfig
from repro_torch.experiments.common import emit, experiment_main, run_symog_protocol
from repro_torch.models.cnn import reduced_cnn


def run(device=None) -> None:
    cfg = reduced_cnn("vgg11", 0.125)
    r = run_symog_protocol(
        cfg,
        data_cfg=SyntheticImagesConfig(
            n_classes=100, hw=32, channels=3, global_batch=16, snr=1.5, seed=31
        ),
        pretrain_steps=120,
        symog_steps=320,
        lr0=0.01,
        device=device,
    )
    emit("table1_cifar100_vgg11_float_err", r["seconds"] * 1e6, f"err={r['err_float']:.4f}")
    emit(
        "table1_cifar100_vgg11_symog2bit_err",
        r["seconds"] * 1e6,
        f"err={r['err_symog_q']:.4f};rel_qerr={r['rel_qerr_symog']:.2e}",
    )
    emit(
        "table1_cifar100_vgg11_naive2bit_err",
        r["seconds"] * 1e6,
        f"err={r['err_naive_q']:.4f};rel_qerr={r['rel_qerr_naive']:.2e}",
    )


if __name__ == "__main__":
    experiment_main(run)
