"""Port parity, the paper's CNNs (repro_torch vs the JAX package) on the CPU:
LeNet-5, VGG-7/11/16 and DenseNet at ``reduced_cnn`` width (DenseNet depth
22), the port's seeded ``cnn_init`` carried into JAX arrays (and, for the
bridge, JAX's own init carried into the port), numpy images from a seed.

  - ``cnn_apply`` in train and eval mode against JAX's: logits and the new
    BN running stats at rtol = atol = 1e-4, tests/test_torch_lm.py's logit
    bar (fp32 convolutions in other summation orders; JAX's NHWC flatten,
    population variance, VALID pools);
  - three ``make_cnn_train_step`` steps with SYMOG (2 bits, the default
    1,000-step λ schedule; width 0.125, batch 4, DenseNet depth 10) on the
    'composed' and 'fused' routes against JAX's jitted step, each step from
    JAX's state before it: loss and accuracy, params at rtol = atol = 1e-5,
    BN stats and momentum at the same bar scaled by the leaf's largest value;
  - ``make_cnn_eval`` and ``softmax_xent`` against JAX's;
  - ``quantize_ste``: JAX's values bit for bit, the identity gradient;
  - ``params_from_numpy`` carries JAX's (params, bn_state) unchanged;
  - (``slow``) tests/test_system.py's LeNet-5 recipe on the port: 120 float
    steps, 220 SYMOG steps; the relative quantization error, the trimodal
    conv2 and the clipping claim the JAX suite asserts.

Two discontinuities set the step test's sizes.  A ReLU input within fp32
noise (~1e-7) of 0 takes the other side in one framework: its gradient then
moves by O(1) through BN's batch statistics.  At width 0.25, batch 8 the
deep nets hold ~1e5 ReLU inputs and meet one every few steps (the port's
fp32 grads stay within 2e-6 of its fp64 ones there, JAX's fp32 ones move up
to 12%), so the steps run smaller, each from JAX's own state.  And a weight
that the two frameworks' one-ulp apart values round to different modes
moves its update by ~lr·λ·2/M_l·Δ: under the bar at the default schedule's
λ ≈ λ_0, not at a 3-step schedule's λ_0·e^6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.nn.tree import flatten_with_paths as j_flatten  # noqa: E402
from repro.train import CNNTrainState as JState  # noqa: E402
from repro.train import make_cnn_eval as j_make_eval  # noqa: E402
from repro.train import make_cnn_train_step as j_make_step  # noqa: E402
from repro.train import softmax_xent as j_xent  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import SyntheticImages, SyntheticImagesConfig  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.symog_update import ops as sops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths as t_flatten  # noqa: E402
from repro_torch.train import (  # noqa: E402
    CNNTrainState,
    make_cnn_eval,
    make_cnn_train_step,
    softmax_xent,
)

NAMES = list(tcnn.PAPER_CNNS)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)  # logits, tests/test_torch_lm.py
STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_train.py
_TREES = {}



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it and
    these many small ops then wait on each other's thread pools (the LeNet
    recipe took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(name):
    """(jax cfg, port cfg, numpy (params, bn), 3 numpy batches of 8), once."""
    if name not in _TREES:
        tcfg = tcnn.reduced_cnn(name)
        params, bn = tcnn.cnn_init(0, tcfg, device="cpu")
        to_np = (lambda tree: jax.tree_util.tree_map(lambda t: t.numpy(), tree))
        data = SyntheticImages(SyntheticImagesConfig(
            n_classes=tcfg.n_classes, hw=tcfg.input_hw, channels=tcfg.in_channels,
            global_batch=8, seed=5))
        _TREES[name] = (jcnn.reduced_cnn(name), tcfg, (to_np(params), to_np(bn)),
                        [next(data) for _ in range(3)])
    return _TREES[name]


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, tol, what, scaled=False):
    for path, leaf in t_flatten(got):
        w = np.asarray(dict(j_flatten(want))[path])
        atol = tol["atol"] * (max(1.0, np.abs(w).max()) if scaled else 1.0)
        np.testing.assert_allclose(_np(leaf), w, rtol=tol["rtol"], atol=atol,
                                   err_msg=f"{what} {path}")


def _jax_apply(jcfg, train):
    return jax.jit(lambda p, s, x: jcnn.cnn_apply(p, s, x, jcfg, train=train))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_cnn_apply_matches_jax(name, train):
    jcfg, tcfg, (npp, nbn), batches = _setup(name)
    x = batches[0]["images"]
    if not train and nbn:  # eval reads running stats: take them from a train pass
        _, nbn = _jax_apply(jcfg, True)(_jax(npp), _jax(nbn), jnp.asarray(batches[1]["images"]))
        nbn = jax.tree_util.tree_map(np.asarray, nbn)
    jl, jbn = _jax_apply(jcfg, train)(_jax(npp), _jax(nbn), jnp.asarray(x))
    tl, tbn = tcnn.cnn_apply(params_from_numpy(npp), params_from_numpy(nbn),
                             torch.from_numpy(x), tcfg, train=train)
    assert tuple(tl.shape) == (8, tcfg.n_classes)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD_TOL)
    assert set(tbn) == set(jbn)
    _close(tbn, jbn, FWD_TOL, "bn")
    if train and nbn:
        assert not np.allclose(_np(tbn[next(iter(tbn))]["mean"]), 0.0)


@pytest.mark.parametrize("name", ["lenet5", "vgg7"])
def test_bridge_carries_jax_params_and_bn_state(name):
    """JAX's own init (jax.random) bridged through numpy: same keys, shapes
    (HWIO convs, (in, out) fcs) and the same forward."""
    jcfg, tcfg, _, batches = _setup(name)
    jp, jbn = jcnn.cnn_init(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    tbn = params_from_numpy(jax.tree_util.tree_map(np.asarray, jbn))
    for ttree, jtree in ((tp, jp), (tbn, jbn)):
        for (tpath, t), (jpath, j) in zip(t_flatten(ttree), j_flatten(jtree), strict=True):
            assert tpath == jpath and tuple(t.shape) == j.shape and t.dtype == torch.float32
    x = batches[2]["images"]
    jl, _ = _jax_apply(jcfg, True)(jp, jbn, jnp.asarray(x))
    tl, _ = tcnn.cnn_apply(tp, tbn, torch.from_numpy(x), tcfg, train=True)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD_TOL)


_JAX_RUNS = {}
STEP_WIDTH, STEP_BATCH = 0.125, 4


def _jax_run(name):
    """JAX's numpy state before each of 3 jitted SYMOG steps and after the
    last, its metrics per step; at width 0.125, batch 4."""
    if name not in _JAX_RUNS:
        jcfg = jcnn.reduced_cnn(name, width_mult=STEP_WIDTH, densenet_depth=10)
        tcfg = tcnn.reduced_cnn(name, width_mult=STEP_WIDTH, densenet_depth=10)
        params, bn = tcnn.cnn_init(1, tcfg, device="cpu")
        data = SyntheticImages(SyntheticImagesConfig(
            n_classes=tcfg.n_classes, hw=tcfg.input_hw, channels=tcfg.in_channels,
            global_batch=STEP_BATCH, seed=7))
        batches = [next(data) for _ in range(3)]
        tx = joptim.sgd(momentum=0.9)
        scfg = jcore.SymogConfig(n_bits=2)
        step = jax.jit(j_make_step(jcfg, tx, jcore.linear_lr(0.01, 0.001, 3), symog_cfg=scfg))
        p = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
        st = JState(p, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), bn), tx.init(p),
                    jcore.symog_init(p, scfg), jnp.zeros((), jnp.int32))
        states, metrics = [], []
        for b in batches:
            states.append(jax.tree_util.tree_map(np.asarray, st))
            st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        states.append(jax.tree_util.tree_map(np.asarray, st))
        _JAX_RUNS[name] = (tcfg, batches, states, metrics)
    return _JAX_RUNS[name]


@pytest.mark.parametrize("route", ["composed", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_cnn_train_steps_match_jax(name, route):
    """Each of 3 steps starts from JAX's state before it (params, BN stats,
    momentum, f), bridged: a deep net's BN and ReLUs turn one step's fp32
    noise into larger moves at the next, which this keeps out of the bar."""
    tcfg, batches, states, j_metrics = _jax_run(name)
    tx = toptim.sgd(momentum=0.9)
    scfg = tcore.SymogConfig(n_bits=2)
    dispatch.set_update_backend(route)
    try:
        step = make_cnn_train_step(tcfg, tx, tcore.linear_lr(0.01, 0.001, 3), symog_cfg=scfg)
    finally:
        dispatch.set_update_backend("auto")
    symog = None
    for i, (b, jm) in enumerate(zip(batches, j_metrics)):
        js = states[i]
        if symog is None:
            symog = tcore.symog_init(params_from_numpy(js.params), scfg)
            assert symog.mask == js.symog.mask and sum(symog.mask.values()) > 0
            for path, f in t_flatten(symog.f):
                np.testing.assert_array_equal(_np(f), np.asarray(dict(j_flatten(js.symog.f))[path]))
        st = CNNTrainState(params_from_numpy(js.params), params_from_numpy(js.bn_state),
                           params_from_numpy(js.opt_state), symog, i)
        st, m = step(st, b)
        assert set(m) == set(jm) == {"loss", "acc", "symog_lambda"}
        np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-5)
        assert float(m["acc"]) == jm["acc"]
        np.testing.assert_array_max_ulp(np.float32(m["symog_lambda"]),
                                        np.float32(jm["symog_lambda"]), maxulp=8)
        assert st.step == i + 1
        nxt = states[i + 1]
        _close(st.params, nxt.params, STEP_TOL, f"step {i} params")
        _close(st.bn_state, nxt.bn_state, STEP_TOL, f"step {i} bn", scaled=True)
        _close(st.opt_state, nxt.opt_state, STEP_TOL, f"step {i} momentum", scaled=True)


def test_convolutions_run_in_fp32_forward_and_backward(monkeypatch):
    """cuDNN's TF32 is off at every convolution of a train step, forward and
    backward, and of an eval; the flag is back as it was afterwards (on the
    card TF32 moved table1_mnist's SYMOG result off the paper's)."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def recording(*a, **k):
        seen.append(("fwd", torch.backends.cudnn.allow_tf32))
        out = conv2d(*a, **k)
        if out.requires_grad:
            out.register_hook(lambda g: seen.append(("bwd", torch.backends.cudnn.allow_tf32)))
        return out

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = tcnn.PAPER_CNNS["lenet5"]
    params, bn = tcnn.cnn_init(0, cfg, device="cpu")
    batch = next(SyntheticImages(SyntheticImagesConfig(n_classes=10, hw=28, channels=1,
                                                       global_batch=2, seed=1)))
    tx = toptim.sgd(momentum=0.9)
    step = make_cnn_train_step(cfg, tx, tcore.constant(0.01))
    step(CNNTrainState(params, bn, tx.init(params), None, 0), batch)
    make_cnn_eval(cfg)(params, bn, batch)
    assert {k for k, _ in seen} == {"fwd", "bwd"} and len(seen) == 2 * 2 + 2
    assert not any(flag for _, flag in seen)
    assert torch.backends.cudnn.allow_tf32 is True


def test_cnn_eval_and_softmax_xent_match_jax():
    jcfg, tcfg, (npp, nbn), batches = _setup("vgg7")
    b = batches[1]
    acc = make_cnn_eval(tcfg)(params_from_numpy(npp), params_from_numpy(nbn), b)
    jacc = j_make_eval(jcfg)(_jax(npp), _jax(nbn), {k: jnp.asarray(v) for k, v in b.items()})
    assert float(acc) == float(jacc)
    logits = np.random.default_rng(6).standard_normal((8, 10)).astype(np.float32)
    np.testing.assert_allclose(
        _np(softmax_xent(torch.from_numpy(logits), torch.from_numpy(b["labels"]))),
        np.asarray(j_xent(jnp.asarray(logits), jnp.asarray(b["labels"]))), rtol=1e-6)


@pytest.mark.parametrize("n_bits", [2, 4])
def test_quantize_ste_matches_jax(n_bits):
    x = (np.random.default_rng(n_bits).standard_normal((37, 5)) * 0.4).astype(np.float32)
    ct = np.random.default_rng(9).standard_normal((37, 5)).astype(np.float32)
    jv, jvjp = jax.vjp(lambda a: jcore.quantize_ste(a, 0.125, n_bits), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tv = tcore.quantize_ste(tx, 0.125, n_bits)
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(_np(tv), _np(tcore.quantize(tx, 0.125, n_bits)))
    (g,) = torch.autograd.grad(tv, tx, torch.from_numpy(ct))
    np.testing.assert_array_equal(_np(g), np.asarray(jvjp(jnp.asarray(ct))[0]))
    np.testing.assert_array_equal(_np(g), ct)


@pytest.mark.slow
def test_lenet_symog_recipe_on_the_port():
    """tests/test_system.py's recipe and claims, on the port's CPU path (the
    fused route's plain version), from the JAX suite's own init
    (``PRNGKey(0)``, bridged) and data: float pretrain, SYMOG finetune; quant
    error collapses, conv2 is trimodal, clipping speeds up adaptation."""
    cfg = tcnn.PAPER_CNNS["lenet5"]
    data = SyntheticImages(SyntheticImagesConfig(n_classes=10, hw=28, channels=1,
                                                 global_batch=64, snr=0.6, seed=1))
    jp, jbn = jcnn.cnn_init(jax.random.PRNGKey(0), jcnn.PAPER_CNNS["lenet5"])
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    bn = params_from_numpy(jbn)
    tx = toptim.sgd(momentum=0.9, nesterov=True)
    lr = tcore.linear_lr(0.02, 0.002, 220)
    step_f = make_cnn_train_step(cfg, tx, lr)
    st = CNNTrainState(params, bn, tx.init(params), None, 0)
    for _ in range(120):
        st, _ = step_f(st, next(data))
    float_st = st
    scfg = tcore.SymogConfig(n_bits=2, total_steps=220)
    sst = tcore.symog_init(float_st.params, scfg)
    dispatch.set_update_backend("fused")
    try:
        step_s = make_cnn_train_step(cfg, tx, lr, symog_cfg=scfg)
    finally:
        dispatch.set_update_backend("auto")
    clone = (lambda tree: {k: (clone(v) if isinstance(v, dict) else v.clone())
                           for k, v in tree.items()})
    st2 = CNNTrainState(clone(float_st.params), float_st.bn_state,
                        tx.init(float_st.params), sst, 0)
    before = sops.launches
    for _ in range(220):
        st2, _ = step_s(st2, next(data))
    assert sops.launches == before  # the CPU path launches no kernel
    qm = tcore.quant_error_metrics(st2.params, sst, scfg)
    assert float(qm["rel_quant_error"]) < 0.05
    qm0 = tcore.quant_error_metrics(float_st.params, tcore.symog_init(float_st.params, scfg),
                                    scfg)
    assert float(qm0["rel_quant_error"]) > 10 * float(qm["rel_quant_error"])
    w, f = st2.params["conv2"]["kernel"], sst.f["conv2"]["kernel"]
    delta = float(tcore.delta_from_f(f))
    stats = tcore.mode_stats(w, delta, 2)
    assert int(stats["count"].sum()) == w.numel() and bool((stats["count"] > 0).all())
    assert bool((stats["std"] < delta / 8).all()), stats["std"]

    def switch_rate(clip: bool, steps=50):
        scfg_c = tcore.SymogConfig(n_bits=2, total_steps=200, clip=clip)
        s_c = tcore.symog_init(float_st.params, scfg_c)
        step = make_cnn_train_step(cfg, tx, tcore.constant(0.02), symog_cfg=scfg_c)
        p = clone(float_st.params)
        stc = CNNTrainState(p, float_st.bn_state, tx.init(p), s_c, 0)
        prev, rates = tcore.mode_tree(stc.params, s_c, scfg_c), []
        for _ in range(steps):
            stc, _ = step(stc, next(data))
            cur = tcore.mode_tree(stc.params, s_c, scfg_c)
            rates.append(np.mean([float(v) for _, v in
                                  t_flatten(tcore.tree_switch_rates(prev, cur))]))
            prev = cur
        return float(np.mean(rates))

    assert switch_rate(True) > switch_rate(False)
