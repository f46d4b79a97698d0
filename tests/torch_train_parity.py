"""Shared checks of the training parity files for the recurrent,
encoder-decoder and VLM families (tests/test_torch_recurrent_train.py,
tests/test_torch_encdec_vlm_train.py): repro_torch against the JAX package
on the CPU, on the REDUCED configs.  The float trees are the port's seeded
``init_lm`` carried into JAX arrays; the tokens are numpy from a seed, and
whisper's frames / paligemma's patches N(0, 0.01) after each batch's tokens,
as tests/test_models_smoke.py draws them.

  - ``check_loss_and_grads``: ``lm_train_loss`` (ce, loss) and the grads of
    every leaf against ``jax.grad`` of JAX's at fp32 rtol 1e-5 (grads rtol
    1e-4 / atol 1e-6, as tests/test_torch_train.py), JAX's grads finite;
  - ``check_train_step``: three ``make_train_step`` steps on one update
    route against JAX's jitted step: losses and metrics at rtol 1e-5,
    params and momentum at STEP_TOL (momentum at the leaf's own scale, as
    tests/test_torch_moe_train.py);
  - ``check_remat``: remat on and off give the same loss and grads bit for
    bit, with one checkpointed call a layer (whisper's encoder layers too);
  - ``check_accumulated_step``: a step over 2 microbatches against JAX's
    jitted step with ``accum_steps=2``, each microbatch the batch's rows in
    order, every batch entry (frames / patches too) split with the tokens;
  - ``check_symog_mask``: ``symog_init``'s mask and f equal to JAX's, norms
    and biases excluded."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro import optim as joptim
from repro.models.lm import lm_train_loss as j_loss
from repro.nn.tree import flatten_with_paths as j_flatten
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import configs as tconfigs
from repro_torch import core as tcore
from repro_torch import optim as toptim
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.models import init_lm, lm_train_loss
from repro_torch.nn.tree import flatten_with_paths as t_flatten
from repro_torch.train import init_train_state, make_train_step

STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_train.py
LOSS_KEYS = {"ce", "loss"}
# (numpy seed, tokens a row): the recurrent archs two SSD chunks / twice the
# local window of their reduced configs
DATA = {"mamba2-2.7b": (5, 16), "recurrentgemma-2b": (5, 16), "whisper-large-v3": (6, 12),
        "paligemma-3b": (6, 12)}
_TREES = {}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _extras(cfg, rng):
    """A batch's frontend outputs: whisper's frames, paligemma's patches."""
    width = {"encdec": ("frames", cfg.encoder_len), "vlm": ("patches", cfg.prefix_len)}.get(
        cfg.family)
    if width is None:
        return {}
    return {width[0]: (rng.standard_normal((4, width[1], cfg.d_model)) * 0.1).astype(np.float32)}


def setup(arch):
    """(jax cfg, port cfg, jax tree, port-tree factory, 3 numpy batches), once
    per arch: the port's seeded init carried into JAX arrays."""
    if arch not in _TREES:
        tcfg = tconfigs.get_reduced(arch)
        npp = jax.tree_util.tree_map(lambda t: t.numpy(), init_lm(0, tcfg, device="cpu"))
        seed, seq = DATA[arch]
        rng = np.random.default_rng(seed)
        batches = []
        for _ in range(3):
            tokens = rng.integers(0, tcfg.vocab_size, (4, seq)).astype(np.int32)
            batches.append({"tokens": tokens, **_extras(tcfg, rng)})
        _TREES[arch] = (jconfigs.get_reduced(arch), tcfg,
                        jax.tree_util.tree_map(jnp.asarray, npp), npp, batches)
    jcfg, tcfg, jp, npp, batches = _TREES[arch]
    return jcfg, tcfg, jp, (lambda: params_from_numpy(npp)), batches


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the training loss and its grads
# ---------------------------------------------------------------------------
def check_loss_and_grads(arch):
    """Returns the port's grads by path."""
    jcfg, tcfg, jp, tparams, batches = setup(arch)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss(p, b, jcfg, compute_dtype=jnp.float32), has_aux=True))(
        jp, _jbatch(batches[0]))
    tp = tparams()
    paths = [p for p, _ in t_flatten(tp)]
    leaves = [t.requires_grad_(True) for _, t in t_flatten(tp)]
    tl, tm = lm_train_loss(tp, tbatch(batches[0]), tcfg, compute_dtype=torch.float32)
    assert set(tm) == set(jm) == LOSS_KEYS
    for key in jm:
        np.testing.assert_allclose(to_np(tm[key]), np.asarray(jm[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-5)
    grads = dict(zip(paths, torch.autograd.grad(tl, leaves)))
    jgrads = dict(j_flatten(jg))
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        assert np.all(np.isfinite(np.asarray(jgrads[path]))), path
        np.testing.assert_allclose(to_np(g), np.asarray(jgrads[path]), rtol=1e-4, atol=1e-6,
                                   err_msg=path)
    return grads


def check_remat(arch):
    """Bit for bit, and every layer checkpointed once: whisper's encoder
    layers as well as its decoder's."""
    _, tcfg, _, tparams, batches = setup(arch)
    inner, calls = torch.utils.checkpoint.checkpoint, []

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    out = []
    torch.utils.checkpoint.checkpoint = counted
    try:
        for remat in (False, True):
            tp = tparams()
            leaves = [t.requires_grad_(True) for _, t in t_flatten(tp)]
            loss, m = lm_train_loss(tp, tbatch(batches[1]),
                                    dataclasses.replace(tcfg, remat=remat),
                                    compute_dtype=torch.float32)
            out.append((loss, m, torch.autograd.grad(loss, leaves)))
    finally:
        torch.utils.checkpoint.checkpoint = inner
    assert len(calls) == tcfg.n_layers + tcfg.n_encoder_layers
    (l0, m0, g0), (l1, m1, g1) = out
    assert torch.equal(l0, l1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def check_symog_mask(arch):
    """Returns the port's quantizable and excluded paths."""
    _, _, jp, tparams, _ = setup(arch)
    js = jcore.symog_init(jp, jcore.SymogConfig(n_bits=2))
    ts = tcore.symog_init(tparams(), tcore.SymogConfig(n_bits=2))
    assert ts.mask == dict(j_flatten(js.mask))
    jf = dict(j_flatten(js.f))
    for path, f in t_flatten(ts.f):
        np.testing.assert_array_equal(to_np(f), np.asarray(jf[path]), err_msg=path)
    quant = {p for p, m in ts.mask.items() if m}
    assert not any("bias" in p or "norm" in p for p in quant)
    return quant, set(ts.mask) - quant


# ---------------------------------------------------------------------------
# make_train_step against JAX's jitted step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_run(arch, accum=1):
    """Metrics per step, params and momentum after 3 JAX steps (1 when
    accumulating)."""
    jcfg, _, jp, _, batches = setup(arch)
    tx = joptim.sgd(momentum=0.9)
    scfg = jcore.SymogConfig(n_bits=2, total_steps=3)
    step = jax.jit(j_make_step(jcfg, tx, jcore.linear_lr(0.01, 0.001, 3), symog_cfg=scfg,
                               accum_steps=accum, compute_dtype=jnp.float32))
    st = j_init_state(jp, tx, scfg)
    metrics = []
    for b in batches[: 3 if accum == 1 else 1]:
        st, m = step(st, _jbatch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, dict(j_flatten(st.params)), dict(j_flatten(st.opt_state))


def _port_run(arch, route, accum=1, loss_fn=None):
    _, tcfg, _, tparams, batches = setup(arch)
    tx = toptim.sgd(momentum=0.9)
    scfg = tcore.SymogConfig(n_bits=2, total_steps=3)
    dispatch.set_update_backend(route)
    try:
        step = make_train_step(tcfg, tx, tcore.linear_lr(0.01, 0.001, 3), symog_cfg=scfg,
                               accum_steps=accum, compute_dtype=torch.float32, loss_fn=loss_fn)
    finally:
        dispatch.set_update_backend("auto")
    st = init_train_state(tparams(), tx, scfg)
    metrics = []
    for b in batches[: 3 if accum == 1 else 1]:
        st, m = step(st, b)
        metrics.append(m)
    return st, metrics


def _check_run(st, metrics, j_metrics, j_params, j_mom):
    for m, jm in zip(metrics, j_metrics):
        assert set(m) == set(jm) == LOSS_KEYS | {"grad_norm", "lr", "symog_lambda"}
        for key in LOSS_KEYS | {"grad_norm"}:
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-5, err_msg=key)
    for path, leaf in t_flatten(st.params):
        assert np.all(np.isfinite(to_np(leaf))), path
        np.testing.assert_allclose(to_np(leaf), np.asarray(j_params[path]), **STEP_TOL,
                                   err_msg=path)
    for path, leaf in t_flatten(st.opt_state):
        want = np.asarray(j_mom[path])
        np.testing.assert_allclose(to_np(leaf), want, rtol=STEP_TOL["rtol"],
                                   atol=STEP_TOL["atol"] * max(1.0, np.abs(want).max()),
                                   err_msg=path)


def check_train_step(arch, route):
    st, metrics = _port_run(arch, route)
    _check_run(st, metrics, *_jax_run(arch))
    assert st.step == 3


def check_accumulated_step(arch):
    """accum_steps=2: each microbatch holds the batch's rows in order (the
    loss sees rows 0-1, then 2-3), every entry split with the tokens, and
    the step equals JAX's."""
    _, tcfg, _, _, batches = setup(arch)
    seen = []

    def loss_fn(p, b):
        seen.append({k: to_np(v).copy() for k, v in b.items()})
        return lm_train_loss(p, b, tcfg, compute_dtype=torch.float32)

    st, metrics = _port_run(arch, "fused", accum=2, loss_fn=loss_fn)
    assert len(seen) == 2
    for i, part in enumerate(seen):
        assert set(part) == set(batches[0])
        for k, v in part.items():
            np.testing.assert_array_equal(v, batches[0][k][2 * i: 2 * i + 2], err_msg=k)
    _check_run(st, metrics, *_jax_run(arch, accum=2))
