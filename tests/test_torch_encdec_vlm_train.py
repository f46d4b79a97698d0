"""Port parity, SYMOG training of the encoder-decoder and VLM families
(repro_torch vs the JAX package) on the CPU (the checks are
tests/torch_train_parity.py's), on REDUCED whisper-large-v3 (2
encoder + 2 decoder layers with cross-attention, rank-2 attention biases,
sinusoidal positions, 12 frames) and paligemma-3b (3 layers, MQA, an
8-patch image prefix under the prefix-LM mask).  The float trees are the
port's seeded ``init_lm`` carried into JAX arrays; the tokens (4 x 12) and
the frames / patches (N(0, 0.01)) are numpy from a seed, as
tests/test_models_smoke.py draws them.

  - ``lm_train_loss`` (ce, loss) and the grads of every leaf (the
    encoder's, the cross-attention's, the biases') against ``jax.grad`` of
    JAX's at fp32 rtol 1e-5 (grads rtol 1e-4 / atol 1e-6, as
    tests/test_torch_train.py);
  - three ``make_train_step`` steps on the 'composed' and 'fused' routes
    against JAX's jitted step: losses and metrics at rtol 1e-5, params and
    momentum at STEP_TOL (momentum at the leaf's own scale, as
    tests/test_torch_moe_train.py);
  - remat on and off: the same loss and grads, bit for bit, with whisper's
    encoder layers recomputed as its decoder's;
  - a step accumulated over 2 microbatches against JAX's jitted step with
    ``accum_steps=2``: the loss sees the frames / patches split with the
    tokens, rows 0-1 then 2-3;
  - ``symog_init``'s mask and f equal to JAX's."""
import pytest

torch = pytest.importorskip("torch")

from torch_train_parity import check_accumulated_step, check_loss_and_grads  # noqa: E402
from torch_train_parity import check_remat, check_symog_mask  # noqa: E402
from torch_train_parity import check_train_step, one_thread, to_np  # noqa: E402, F401

ARCHS = ["whisper-large-v3", "paligemma-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_loss_and_grads_match_jax(arch):
    grads = check_loss_and_grads(arch)
    if arch == "whisper-large-v3":  # the encoder, the cross blocks and the biases train
        for part in ("encoder/", "cross", "bias"):
            assert any(part in p and float(abs(to_np(grads[p])).max()) > 0 for p in grads), part


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    check_remat(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_symog_init_mask_matches_jax(arch):
    quant, _ = check_symog_mask(arch)
    if arch == "whisper-large-v3":
        assert any(p.startswith("encoder/") for p in quant)
        assert any("cross" in p for p in quant)


@pytest.mark.parametrize("route", ["composed", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, route):
    check_train_step(arch, route)


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulated_step_splits_the_extras(arch):
    """accum_steps=2: the frames / patches split with their tokens, rows
    0-1 then 2-3, and the step equals JAX's."""
    check_accumulated_step(arch)
