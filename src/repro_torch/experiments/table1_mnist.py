"""Paper Table 1, MNIST row: LeNet-5, 2-bit SYMOG vs float vs naive (the
counterpart of ``benchmarks/table1_mnist.py``).

Paper numbers (real MNIST): float 0.70%, SYMOG 0.63%, i.e. SYMOG ≈ float.
Here: synthetic MNIST-like stream; the claim under test is the ORDERING
err_symog ≈ err_float ≪ err_naive and the collapse of quantization error.

    PYTHONPATH=src python -m repro_torch.experiments.table1_mnist [--device cpu]
"""
from __future__ import annotations

from repro_torch.data import SyntheticImagesConfig
from repro_torch.experiments.common import emit, experiment_main, run_symog_protocol
from repro_torch.models.cnn import PAPER_CNNS


def run(device=None) -> None:
    r = run_symog_protocol(
        PAPER_CNNS["lenet5"],
        data_cfg=SyntheticImagesConfig(
            n_classes=10, hw=28, channels=1, global_batch=64, snr=0.5, seed=11
        ),
        pretrain_steps=150,
        symog_steps=250,
        device=device,
    )
    emit("table1_mnist_float_err", r["seconds"] * 1e6, f"err={r['err_float']:.4f}")
    emit(
        "table1_mnist_symog2bit_err",
        r["seconds"] * 1e6,
        f"err={r['err_symog_q']:.4f};rel_qerr={r['rel_qerr_symog']:.2e}",
    )
    emit(
        "table1_mnist_naive2bit_err",
        r["seconds"] * 1e6,
        f"err={r['err_naive_q']:.4f};rel_qerr={r['rel_qerr_naive']:.2e}",
    )
    ok = (r["err_symog_q"] <= r["err_naive_q"]) and (r["err_symog_q"] <= r["err_float"] + 0.05)
    emit("table1_mnist_claim_C1", 0.0, f"pass={ok}")


if __name__ == "__main__":
    experiment_main(run)
