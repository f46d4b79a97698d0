"""Paper Table 1, CIFAR-10 rows: VGG7 and DenseNet at reduced width (the
counterpart of ``benchmarks/table1_cifar10.py``).

Paper: VGG7 float 5.52% vs SYMOG 5.71%; DenseNet float 5.72% vs SYMOG 5.96%
— SYMOG within ~0.2-0.3% of float, far ahead of TWN/VNQ.  The reduced-scale
synthetic reproduction tests the same ordering.

    PYTHONPATH=src python -m repro_torch.experiments.table1_cifar10 [--device cpu]
"""
from __future__ import annotations

from repro_torch.data import SyntheticImagesConfig
from repro_torch.experiments.common import emit, experiment_main, run_symog_protocol
from repro_torch.models.cnn import reduced_cnn


def run(device=None) -> None:
    # densenet: the paper itself flags DenseNet as "difficult to quantize"
    # (few redundancies): it needs the longest SYMOG schedule of the set.
    for name, wm, steps, qsteps in (
        ("vgg7", 0.0625, 100, 160),
        ("densenet", 1.0, 120, 320),
    ):
        cfg = reduced_cnn(name, wm)
        r = run_symog_protocol(
            cfg,
            data_cfg=SyntheticImagesConfig(
                n_classes=10, hw=32, channels=3, global_batch=16, snr=0.8, seed=21
            ),
            pretrain_steps=steps,
            symog_steps=qsteps,
            lr0=0.01,
            device=device,
        )
        emit(f"table1_cifar10_{name}_float_err", r["seconds"] * 1e6, f"err={r['err_float']:.4f}")
        emit(
            f"table1_cifar10_{name}_symog2bit_err",
            r["seconds"] * 1e6,
            f"err={r['err_symog_q']:.4f};rel_qerr={r['rel_qerr_symog']:.2e}",
        )
        emit(
            f"table1_cifar10_{name}_naive2bit_err",
            r["seconds"] * 1e6,
            f"err={r['err_naive_q']:.4f};rel_qerr={r['rel_qerr_naive']:.2e}",
        )


if __name__ == "__main__":
    experiment_main(run)
