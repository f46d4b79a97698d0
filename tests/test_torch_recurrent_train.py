"""Port parity, SYMOG training of the recurrent families (repro_torch vs the
JAX package) on the CPU (the training checks are
tests/torch_train_parity.py's), on REDUCED mamba2-2.7b (SSD blocks, chunk 8) and
recurrentgemma-2b (an RG-LRU, RG-LRU, local-attention unit and an unrolled
RG-LRU pair as its tail, window 8).  The float trees are the port's seeded
``init_lm`` carried into JAX arrays; the tokens are numpy from a seed, 16 a
row (two SSD chunks, twice the local window).

  - ``lm_train_loss`` (ce, loss) and the grads of every leaf against
    ``jax.grad`` of JAX's at fp32 rtol 1e-5 (grads rtol 1e-4 / atol 1e-6,
    as tests/test_torch_train.py);
  - three ``make_train_step`` steps on the 'composed' and 'fused' routes
    against JAX's jitted step: losses and metrics at rtol 1e-5, params and
    momentum at STEP_TOL (momentum at the leaf's own scale, as
    tests/test_torch_moe_train.py);
  - remat on and off: the same loss and grads, bit for bit, one
    checkpointed call a layer (kinds 'M' and 'R' included);
  - a step accumulated over 2 microbatches against JAX's jitted step with
    ``accum_steps=2``, each microbatch the batch's rows in order;
  - ``symog_init``'s mask and f equal to JAX's;
  - ``ssd_scan_ref`` at inputs whose upper-triangle exponents lie in
    (100, 600): the forward bit-identical to the select-after-exp formula
    (the JAX package's order), JAX's own fp32 grads non-finite, the port's
    finite and within rtol 1e-4 of an fp64 evaluation of that formula
    (tests/test_torch_cuda.py's, which the card runs), where nothing
    overflows.

RG-LRU ties: the gate's ``clamp(1 - a², min=1e-12)`` and JAX's
``maximum`` differ in their grads only where 1 - a² sits on the floor;
``test_rglru_gate_stays_off_the_clamp`` shows these inputs never do."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssd import ssd_scan_ref as j_ssd_scan  # noqa: E402
from repro_torch.models import lm_train_loss  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models.ssd import ssd_scan_ref  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths as t_flatten  # noqa: E402
from test_torch_cuda import _ssd_select_after_exp as select_after_exp  # noqa: E402
from torch_train_parity import check_accumulated_step, check_loss_and_grads  # noqa: E402
from torch_train_parity import check_remat, check_symog_mask, check_train_step  # noqa: E402
from torch_train_parity import one_thread, setup, tbatch, to_np  # noqa: E402, F401

ARCHS = ["mamba2-2.7b", "recurrentgemma-2b"]


# ---------------------------------------------------------------------------
# the training loss and its grads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    check_remat(arch)


def test_rglru_gate_stays_off_the_clamp():
    """The RG-LRU's 1 - a² never reaches the 1e-12 floor on the parity
    inputs, so the clamp's grads (torch: the whole grad at a tie, JAX's
    ``maximum``: half) are never compared at a tie."""
    _, tcfg, _, tparams, batches = setup("recurrentgemma-2b")
    seen = []
    inner = trglru._gates

    def gates(p, xc, H, compute_dtype):
        a, gx = inner(p, xc, H, compute_dtype)
        seen.append(float(torch.min(1.0 - a * a)))
        return a, gx

    trglru._gates = gates
    try:
        for b in batches:
            lm_train_loss(tparams(), tbatch(b), tcfg, compute_dtype=torch.float32)
    finally:
        trglru._gates = inner
    assert len(seen) == 3 * tcfg.layer_kinds().count("R") and min(seen) > 1e-6, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_symog_init_mask_matches_jax(arch):
    _, excluded = check_symog_mask(arch)
    want = {"a_log", "dt_bias", "ssm_d"} if arch == "mamba2-2.7b" else {"a_param", "bias"}
    assert {w for w in want if any(w in p.lower() for p in excluded)} == want


# ---------------------------------------------------------------------------
# make_train_step against JAX's jitted step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["composed", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, route):
    check_train_step(arch, route)


@pytest.mark.parametrize("arch", ARCHS)
def test_accumulated_step_matches_jax(arch):
    """accum_steps=2: each microbatch is the batch's rows in order (the
    loss sees rows 0-1, then 2-3), and the step equals JAX's."""
    check_accumulated_step(arch)


# ---------------------------------------------------------------------------
# ssd_scan_ref where the upper triangle's exponents overflow fp32's exp
# ---------------------------------------------------------------------------
def _overflow_inputs(seed=0):
    """B 2, T 32 (two chunks of 16), H 2, P 4, N 3; dt in (0.6, 1.4) and A
    (-0.9, -40): the upper triangle's largest exponents Σ dt·|A| over 15
    steps reach ~13 and ~600."""
    rng = np.random.default_rng(seed)
    B, T, H, P, N = 2, 32, 2, 4, 3
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.6, 1.4, (B, T, H)).astype(np.float32)
    A = np.array([-0.9, -40.0], np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    ct = rng.standard_normal((B, T, H, P)).astype(np.float32)
    cs = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), ct, cs


def _objective(y, h, ct, cs):
    return (y * ct).sum() + (h * cs).sum()


def test_ssd_scan_masks_before_the_exp():
    (x, dt, A, Bm, Cm), ct, cs = _overflow_inputs()
    Q = 16
    cum = np.cumsum((dt * A).reshape(2, 2, Q, 2), axis=2)
    upper = cum[:, :, 0] - cum[:, :, -1]  # the largest exponent above the diagonal
    assert 100 < upper.max() < 600 and upper[..., 1].min() > 88.72  # fp32's exp limit

    # the forward: the same bits as exp-then-select
    ins = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, h = ssd_scan_ref(*ins, chunk=Q)
    y0, h0 = select_after_exp(*ins, chunk=Q)
    assert torch.equal(y, y0) and torch.equal(h, h0)

    # JAX's fp32 grads (the select after the exp) are not finite here
    jg = jax.grad(lambda *a: _objective(*j_ssd_scan(*a, chunk=Q), ct, cs),
                  argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    assert not all(np.all(np.isfinite(np.asarray(g))) for g in jg)
    assert not np.all(np.isfinite(np.asarray(jg[1])))  # dt's

    # the port's are finite and equal fp64's, where nothing overflows
    live = [t.clone().requires_grad_(True) for t in ins]
    tg = torch.autograd.grad(_objective(*ssd_scan_ref(*live, chunk=Q), *map(torch.from_numpy,
                                                                            (ct, cs))), live)
    live64 = [t.double().requires_grad_(True) for t in ins]
    ref = torch.autograd.grad(_objective(*select_after_exp(*live64, chunk=Q),
                                         *(torch.from_numpy(a).double() for a in (ct, cs))),
                              live64)
    assert all(bool(torch.isfinite(r).all()) for r in ref)
    for name, g, r in zip(("x", "dt", "A", "Bm", "Cm"), tg, ref):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(to_np(g), r.numpy(), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(r.abs().max())), err_msg=name)


def test_ssd_overflow_leaves_the_mamba2_block_grads_finite():
    """A reduced mamba2 layer driven into the overflowing regime (dt ~ 1,
    A down to -40, chunk 16): every param's grad is finite."""
    from repro_torch.models.ssd import SSDConfig, ssd_block_apply, ssd_init

    cfg = SSDConfig(d_model=16, d_inner=32, n_heads=2, head_dim=16, d_state=4, chunk=16)
    gen = torch.Generator().manual_seed(0)
    p = ssd_init(gen, cfg)
    p["A_log"] = torch.log(torch.tensor([0.9, 40.0]))
    p["dt_bias"] = torch.full((2,), math.log(math.expm1(1.0)))  # softplus^-1(1)
    leaves = [t.requires_grad_(True) for _, t in t_flatten(p)]
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, 16)).astype(np.float32))
    y, _ = ssd_block_apply(p, u, cfg=cfg, compute_dtype=torch.float32)
    grads = torch.autograd.grad((y * y).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
