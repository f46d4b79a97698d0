"""Port parity, training (repro_torch core/optim/data/train vs the JAX
package) on REDUCED internlm2-1.8b with JAX-initialized params bridged
through numpy and numpy inputs from a seed.

Bars: integer results (modes, counts, batches) and the linear/constant
schedules are bit-exact against the JAX schedules; λ (exp) and the cosine
schedule are within 2 fp32 ulps, since torch's and XLA's fp32 exp/cos differ
in the last bits; against a jitted JAX schedule (XLA's jit rewrites x/c as
x·(1/c), and exp amplifies that by its argument, up to 9) within 8 ulps; the
rest is fp32 allclose.  Three ``make_train_step`` steps at fp32 compute
on the 'composed' and the 'fused' update route (the fused kernel's plain
version on the CPU) track JAX's jitted step: loss at rtol 1e-5, params and
momentum at rtol = atol = 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import SyntheticImages as JImages  # noqa: E402
from repro.data import SyntheticImagesConfig as JImagesConfig  # noqa: E402
from repro.data import SyntheticLM as JLM  # noqa: E402
from repro.data import SyntheticLMConfig as JLMConfig  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models.lm import lm_train_loss as j_loss  # noqa: E402
from repro.nn.tree import flatten_with_paths as j_flatten  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.symog_update import ops as sops  # noqa: E402
from repro_torch.models import lm_train_loss  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths as t_flatten  # noqa: E402
from repro_torch.train import fused_update, init_train_state, make_train_step  # noqa: E402

STEP_TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


_CACHE = {}


def _setup():
    """(cfg, jax params, bridged-params factory, 3 numpy batches), built once."""
    if not _CACHE:
        cfg = jconfigs.get_reduced("internlm2-1.8b")
        jp = j_init(jax.random.PRNGKey(0), cfg)
        npp = jax.tree_util.tree_map(np.asarray, jp)
        data = JLM(JLMConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3))
        _CACHE.update(cfg=cfg, jp=jp, npp=npp, batches=[next(data) for _ in range(3)])
    c = _CACHE
    return c["cfg"], c["jp"], (lambda: params_from_numpy(c["npp"])), c["batches"]


def _weights(shape=(6, 40, 24), seed=0, std=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


# ---------------------------------------------------------------------------
# core: regularizer, schedules, metrics, symog tree functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_bits", [2, 4])
def test_regularizer_matches_jax(n_bits):
    ws = {"a": _weights(seed=1), "b": {"c": _weights((33, 17), seed=2)}}
    ds = {"a": 0.25, "b": {"c": 0.125}}
    jw = jax.tree_util.tree_map(jnp.asarray, ws)
    tw = {"a": torch.from_numpy(ws["a"]), "b": {"c": torch.from_numpy(ws["b"]["c"])}}
    for k in ("a",):
        np.testing.assert_allclose(_np(tcore.layer_reg_value(tw[k], ds[k], n_bits)),
                                   np.asarray(jcore.layer_reg_value(jw[k], ds[k], n_bits)), **F32)
        np.testing.assert_allclose(_np(tcore.layer_reg_grad(tw[k], ds[k], n_bits)),
                                   np.asarray(jcore.layer_reg_grad(jw[k], ds[k], n_bits)), **F32)
    np.testing.assert_allclose(_np(tcore.tree_reg_value(tw, ds, n_bits)),
                               np.asarray(jcore.tree_reg_value(jw, ds, n_bits)), **F32)
    tg = tcore.tree_reg_grad(tw, ds, n_bits)
    jg = jcore.tree_reg_grad(jw, ds, n_bits)
    np.testing.assert_allclose(_np(tg["b"]["c"]), np.asarray(jg["b"]["c"]), **F32)


def test_schedules_match_jax():
    """η (linear, constant) equals the JAX schedule's value bit for bit at
    every step; λ and the cosine schedule agree within 2 fp32 ulps; every
    schedule agrees with its jitted form (XLA's jit rewrites x/c as x·(1/c),
    so jitted and eager JAX differ too) within 8 ulps."""
    total = 37
    pairs = [
        (tcore.linear_lr(0.01, 0.001, total), jcore.linear_lr(0.01, 0.001, total), True),
        (tcore.constant(0.05), jcore.constant(0.05), True),
        (tcore.exponential_lambda(10.0, 9.0, total), jcore.exponential_lambda(10.0, 9.0, total),
         False),
        (tcore.cosine_lr(0.1, 0.001, total, 5), jcore.cosine_lr(0.1, 0.001, total, 5), False),
    ]
    steps = range(total + 3)
    for t_fn, j_fn, exact in pairs:
        got = np.asarray([t_fn(s) for s in steps], np.float32)
        assert all(isinstance(t_fn(s), float) for s in (0, 5))
        eager = np.asarray([j_fn(s) for s in steps], np.float32)
        if exact:
            np.testing.assert_array_equal(got, eager)
        else:
            np.testing.assert_array_max_ulp(got, eager, maxulp=2)
        jit_fn = jax.jit(j_fn)
        np.testing.assert_array_max_ulp(got, np.asarray([jit_fn(s) for s in steps], np.float32),
                                        maxulp=8)
    scfg_t = tcore.SymogConfig(total_steps=total)
    scfg_j = jcore.SymogConfig(total_steps=total)
    np.testing.assert_array_max_ulp(
        np.asarray([tcore.lambda_at(scfg_t, s) for s in range(total + 1)], np.float32),
        np.asarray([jcore.lambda_at(scfg_j, s) for s in range(total + 1)], np.float32), maxulp=2)


@pytest.mark.parametrize("n_bits", [2, 4])
def test_metrics_match_jax(n_bits):
    w = _weights(seed=4, std=0.4)
    w2 = w + _weights(seed=5, std=0.05)
    d = 0.125
    tw, tw2 = torch.from_numpy(w), torch.from_numpy(w2)
    tm, jm = tcore.mode_assignment(tw, d, n_bits), jcore.metrics.mode_assignment(w, d, n_bits)
    assert tm.dtype == torch.int8
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    tm2 = tcore.mode_assignment(tw2, d, n_bits)
    jm2 = jcore.metrics.mode_assignment(w2, d, n_bits)
    assert float(tcore.switch_rate(tm, tm2)) == float(jcore.metrics.switch_rate(jm, jm2))
    rates = tcore.tree_switch_rates({"x": tm}, {"x": tm2})
    assert float(rates["x"]) == float(jcore.metrics.tree_switch_rates({"x": jm}, {"x": jm2})["x"])
    ts, js = tcore.mode_stats(tw, d, n_bits), jcore.metrics.mode_stats(jnp.asarray(w), d, n_bits)
    np.testing.assert_array_equal(_np(ts["count"]), np.asarray(js["count"]))
    np.testing.assert_array_equal(_np(ts["centers"]), np.asarray(js["centers"]))
    for k in ("mean", "std"):
        np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tcore.relative_quant_error(tw, d, n_bits)),
                               np.asarray(jcore.metrics.relative_quant_error(w, d, n_bits)), **F32)


@pytest.mark.parametrize("n_bits", [2, 4])
def test_symog_tree_functions_match_jax(n_bits):
    """reg_value, reg_grad, clip_tree, mode_tree and quant_error_metrics on
    the bridged reduced-model tree (scan-stacked leaves: one f each)."""
    cfg, jp, tparams, _ = _setup()
    tp = tparams()
    jscfg = jcore.SymogConfig(n_bits=n_bits, total_steps=10)
    tscfg = tcore.SymogConfig(n_bits=n_bits, total_steps=10)
    jst, tst = jcore.symog_init(jp, jscfg), tcore.symog_init(tp, tscfg)
    np.testing.assert_allclose(_np(tcore.reg_value(tp, tst, tscfg)),
                               np.asarray(jcore.reg_value(jp, jst, jscfg)), rtol=1e-5)
    jrg = dict(j_flatten(jcore.reg_grad(jp, jst, jscfg)))
    jclip = dict(j_flatten(jcore.clip_tree(jp, jst, jscfg)))
    jmode = dict(j_flatten(jcore.mode_tree(jp, jst, jscfg)))
    tmode = dict(t_flatten(tcore.mode_tree(tp, tst, tscfg)))
    tclip = dict(t_flatten(tcore.clip_tree(tp, tst, tscfg)))
    for path, g in t_flatten(tcore.reg_grad(tp, tst, tscfg)):
        np.testing.assert_allclose(_np(g), np.asarray(jrg[path]), **F32, err_msg=path)
        np.testing.assert_array_equal(_np(tclip[path]), np.asarray(jclip[path]), err_msg=path)
        np.testing.assert_array_equal(_np(tmode[path]), np.asarray(jmode[path]), err_msg=path)
    tq, jq = tcore.quant_error_metrics(tp, tst, tscfg), jcore.quant_error_metrics(jp, jst, jscfg)
    for k in ("rel_quant_error", "reg_value"):
        np.testing.assert_allclose(_np(tq[k]), np.asarray(jq[k]), rtol=1e-5)
    assert tcore.clip_tree(tp, tst, dataclasses.replace(tscfg, clip=False)) is tp


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------
_TXS = {
    "sgd_nesterov": (lambda o: o.sgd(momentum=0.9)),
    "sgd_classical": (lambda o: o.sgd(momentum=0.8, nesterov=False)),
    "sgd_weight_decay": (lambda o: o.sgd(momentum=0.9, weight_decay=1e-2)),
    "chain_clip_sgd": (lambda o: o.chain(o.clip_by_global_norm(0.5), o.sgd(momentum=0.9))),
    "adamw": (lambda o: o.adamw(weight_decay=0.1)),
    "identity": (lambda o: o.identity()),
}


@pytest.mark.parametrize("name", list(_TXS))
def test_optimizers_match_jax_over_3_steps(name):
    params = {"w": _weights((12, 9), seed=6), "n": {"s": _weights((9,), seed=7)}}
    jtx, ttx = _TXS[name](joptim), _TXS[name](toptim)
    jps = jax.tree_util.tree_map(jnp.asarray, params)
    tps = {"w": torch.from_numpy(params["w"]), "n": {"s": torch.from_numpy(params["n"]["s"])}}
    jst, tst = jtx.init(jps), ttx.init(tps)
    for step in range(3):
        g = {"w": _weights((12, 9), seed=10 + step), "n": {"s": _weights((9,), seed=20 + step)}}
        lr = 0.05 / (step + 1)
        ju, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jst, jps, lr=jnp.float32(lr))
        tu, tst = ttx.update({"w": torch.from_numpy(g["w"]),
                              "n": {"s": torch.from_numpy(g["n"]["s"])}}, tst, tps,
                             lr=float(np.float32(lr)))
        jps, tps = joptim.apply_updates(jps, ju), toptim.apply_updates(tps, tu)
        for (path, t), (_, j) in zip(t_flatten(tps), j_flatten(jps)):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6, atol=1e-7, err_msg=path)
    np.testing.assert_allclose(_np(toptim.global_norm(tps)), np.asarray(joptim.global_norm(jps)),
                               **F32)
    assert (ttx.paper_sgd == 0.9) == (name in ("sgd_nesterov", "chain_clip_sgd"))
    assert (ttx.clip_norm == 0.5) == (name == "chain_clip_sgd")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_synthetic_streams_match_jax():
    kw = dict(vocab_size=92544, seq_len=64, global_batch=4, seed=11, n_hosts=2, host_id=1)
    jd, td = JLM(JLMConfig(**kw)), tdata.SyntheticLM(tdata.SyntheticLMConfig(**kw))
    for _ in range(3):
        np.testing.assert_array_equal(next(td)["tokens"], next(jd)["tokens"])
    assert td.state_dict() == jd.state_dict() and td.ce_floor() == jd.ce_floor()
    ikw = dict(n_classes=10, hw=8, global_batch=6, seed=2)
    ji, ti = JImages(JImagesConfig(**ikw)), tdata.SyntheticImages(tdata.SyntheticImagesConfig(**ikw))
    for _ in range(2):
        a, b = next(ti), next(ji)
        np.testing.assert_array_equal(a["images"], b["images"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


# ---------------------------------------------------------------------------
# LM loss and stacked-leaf gradients
# ---------------------------------------------------------------------------
def _leaf_consumers(loss):
    """{id(leaf): [type names of the backward nodes that feed its grad]}."""
    seen, stack, out = set(), [loss.grad_fn], {}
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if nxt is not None and hasattr(nxt, "variable"):
                out.setdefault(id(nxt.variable), []).append(type(fn).__name__)
            stack.append(nxt)
    return out


def test_stacked_leaf_grads_match_jax():
    """Grads of every leaf (the (L, ...) stacked ones included) equal
    jax.grad of lm_train_loss; each stacked leaf is cut once (unbind), never
    indexed per layer, so its backward stacks once."""
    cfg, jp, tparams, batches = _setup()
    batch = batches[0]
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_loss(p, {"tokens": jnp.asarray(batch["tokens"])}, cfg,
                         compute_dtype=jnp.float32), has_aux=True)(jp)
    tp = tparams()
    live = {}

    def mark(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                mark(v, prefix + k + "/")
            else:
                v.requires_grad_(True)
                live[prefix + k] = v

    mark(tp)
    tl, tm = lm_train_loss(tp, {"tokens": torch.from_numpy(batch["tokens"])}, cfg,
                           compute_dtype=torch.float32)
    consumers = _leaf_consumers(tl)
    stacked = [p for p in live if p.startswith("layers0/")]
    assert len(stacked) == 9
    for path in stacked:  # one unbind per stacked leaf, not one select per layer
        assert consumers[id(live[path])] == ["UnbindBackward0"], (path, consumers[id(live[path])])
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(tm["ce"]), np.asarray(jm["ce"]), rtol=1e-5)
    paths = sorted(live)
    grads = dict(zip(paths, torch.autograd.grad(tl, [live[p] for p in paths])))
    jgrads = dict(j_flatten(jg))
    assert set(grads) == set(jgrads) and len(grads) == 11
    for path in paths:
        np.testing.assert_allclose(_np(grads[path]), np.asarray(jgrads[path]), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


def test_lm_train_loss_masked_and_trains_every_family():
    """The masked loss equals JAX's; every family trains: the reduced
    mamba2, recurrentgemma, whisper (with its frames) and paligemma (with
    its patches) each give a finite loss (their losses and grads are held to
    JAX's in tests/test_torch_recurrent_train.py and
    tests/test_torch_encdec_vlm_train.py; MoE and MTP in
    tests/test_torch_moe_train.py)."""
    cfg, jp, tparams, batches = _setup()
    tok = batches[1]["tokens"]
    mask = (np.arange(tok.shape[1])[None] % 3 != 0).repeat(tok.shape[0], 0)
    jl, _ = j_loss(jp, {"tokens": jnp.asarray(tok), "loss_mask": jnp.asarray(mask)}, cfg,
                   compute_dtype=jnp.float32)
    tl, _ = lm_train_loss(tparams(), {"tokens": torch.from_numpy(tok),
                                      "loss_mask": torch.from_numpy(mask)}, cfg,
                          compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    from repro_torch import configs as tconfigs
    from repro_torch.models import init_lm

    rng = np.random.default_rng(2)
    for arch, family in (("mamba2-2.7b", "ssm"), ("recurrentgemma-2b", "hybrid"),
                         ("whisper-large-v3", "encdec"), ("paligemma-3b", "vlm")):
        tcfg = tconfigs.get_reduced(arch)
        assert tcfg.family == family
        batch = {"tokens": torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 8)))}
        if family == "encdec":
            batch["frames"] = torch.from_numpy(
                rng.standard_normal((2, tcfg.encoder_len, tcfg.d_model), dtype=np.float32) * 0.1)
        if family == "vlm":
            batch["patches"] = torch.from_numpy(
                rng.standard_normal((2, tcfg.prefix_len, tcfg.d_model), dtype=np.float32) * 0.1)
        loss, metrics = lm_train_loss(init_lm(0, tcfg, device="cpu"), batch, tcfg,
                                      compute_dtype=torch.float32)
        assert bool(torch.isfinite(loss)) and set(metrics) == {"ce", "loss"}, arch


# ---------------------------------------------------------------------------
# make_train_step against JAX's jitted step
# ---------------------------------------------------------------------------
_JAX_RUNS = {}


def _jax_run(accum, compute):
    """Loss per step, params and momentum after 3 JAX steps (cached)."""
    key = (accum, compute)
    if key not in _JAX_RUNS:
        cfg, jp, _, batches = _setup()
        tx = joptim.sgd(momentum=0.9)
        scfg = jcore.SymogConfig(n_bits=2, total_steps=3)
        dt = jnp.float32 if compute == "float32" else jnp.bfloat16
        step = jax.jit(j_make_step(cfg, tx, jcore.linear_lr(0.01, 0.001, 3), symog_cfg=scfg,
                                   accum_steps=accum, compute_dtype=dt))
        st = j_init_state(jp, tx, scfg)
        losses, metrics = [], []
        for b in batches:
            st, m = step(st, {"tokens": jnp.asarray(b["tokens"])})
            losses.append(float(m["loss"]))
            metrics.append({k: float(v) for k, v in m.items()})
        _JAX_RUNS[key] = (losses, metrics, dict(j_flatten(st.params)),
                          dict(j_flatten(st.opt_state)))
    return _JAX_RUNS[key]


def _port_run(route, accum, compute):
    cfg, _, tparams, batches = _setup()
    tx = toptim.sgd(momentum=0.9)
    scfg = tcore.SymogConfig(n_bits=2, total_steps=3)
    dispatch.set_update_backend(route)
    try:
        step = make_train_step(cfg, tx, tcore.linear_lr(0.01, 0.001, 3), symog_cfg=scfg,
                               accum_steps=accum, compute_dtype=getattr(torch, compute))
    finally:
        dispatch.set_update_backend("auto")
    st = init_train_state(tparams(), tx, scfg)
    metrics = []
    for b in batches:
        st, m = step(st, b)
        metrics.append(m)
    return metrics, st


@pytest.mark.parametrize("route", ["composed", "fused"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(route, accum):
    j_losses, j_metrics, j_params, j_mom = _jax_run(accum, "float32")
    metrics, st = _port_run(route, accum, "float32")
    np.testing.assert_allclose([float(m["loss"]) for m in metrics], j_losses, rtol=1e-5)
    for m, jm in zip(metrics, j_metrics):
        assert set(m) == set(jm) == {"loss", "ce", "grad_norm", "lr", "symog_lambda"}
        np.testing.assert_array_max_ulp(np.float32(m["lr"]), np.float32(jm["lr"]), maxulp=8)
        np.testing.assert_array_max_ulp(np.float32(m["symog_lambda"]),
                                        np.float32(jm["symog_lambda"]), maxulp=8)
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(float(m["ce"]), jm["ce"], rtol=1e-5)
    for path, leaf in t_flatten(st.params):
        np.testing.assert_allclose(_np(leaf), np.asarray(j_params[path]), **STEP_TOL,
                                   err_msg=path)
    for path, leaf in t_flatten(st.opt_state):
        np.testing.assert_allclose(_np(leaf), np.asarray(j_mom[path]), **STEP_TOL, err_msg=path)
    assert st.step == 3


def test_train_step_bf16_compute_matches_jax():
    j_losses, *_ = _jax_run(1, "bfloat16")
    metrics, _ = _port_run("fused", 1, "bfloat16")
    np.testing.assert_allclose([float(m["loss"]) for m in metrics], j_losses, rtol=1e-2)


def test_fused_route_launch_count_and_refusals():
    """On the CPU the fused route runs the kernel's plain version (no launch
    counted); a chained optimizer other than clip + the paper's SGD, or no
    clipping, cannot take it."""
    cfg, _, tparams, batches = _setup()
    scfg = tcore.SymogConfig(n_bits=2, total_steps=3)
    chained = toptim.chain(toptim.clip_by_global_norm(1.0),
                           toptim.sgd(momentum=0.9, nesterov=False))
    dispatch.set_update_backend("fused")
    try:
        make_train_step(cfg, toptim.chain(toptim.clip_by_global_norm(1.0), toptim.sgd()),
                        tcore.constant(0.01), symog_cfg=scfg)
        with pytest.raises(ValueError, match="paper's optimizer"):
            make_train_step(cfg, chained, tcore.constant(0.01), symog_cfg=scfg)
        with pytest.raises(ValueError, match="clip=True"):
            make_train_step(cfg, toptim.sgd(), tcore.constant(0.01),
                            symog_cfg=dataclasses.replace(scfg, clip=False))
        with pytest.raises(ValueError):
            make_train_step(cfg, toptim.sgd(nesterov=False), tcore.constant(0.01),
                            symog_cfg=scfg)
    finally:
        dispatch.set_update_backend("auto")
    tp = tparams()
    st = init_train_state(tp, chained, scfg)
    zeros = {p: torch.zeros_like(v) for p, v in t_flatten(tp)}
    with pytest.raises(ValueError, match="paper's optimizer"):
        fused_update(tp, zeros, st.opt_state, st.symog, scfg, chained, lr=0.01, lam=1.0)
    # 'auto' on the CPU, and 'auto' with a chained optimizer: composed, no launch
    assert dispatch.resolve_update_backend("cpu") == "composed"
    assert dispatch.resolve_update_backend("cuda") == "fused"
    before = sops.launches
    step = make_train_step(cfg, chained, tcore.constant(0.01), symog_cfg=scfg,
                           compute_dtype=torch.float32)
    st, m = step(st, batches[0])
    assert np.isfinite(float(m["loss"])) and sops.launches == before
    with pytest.raises(ValueError):
        dispatch.set_update_backend("triton")


def test_train_then_pack_then_serve_on_cpu():
    """The README chain in the port: SYMOG-train, pack the trained weights,
    serve them through the port's engine."""
    from repro_torch.models import init_lm
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = _setup()[0]
    tx = toptim.sgd(momentum=0.9)
    scfg = tcore.SymogConfig(n_bits=2, total_steps=4)
    st = init_train_state(init_lm(0, cfg, device="cpu"), tx, scfg)
    dispatch.set_update_backend("fused")
    try:
        step = make_train_step(cfg, tx, tcore.linear_lr(0.01, 0.001, 4), symog_cfg=scfg,
                               compute_dtype=torch.float32)
    finally:
        dispatch.set_update_backend("auto")
    data = tdata.SyntheticLM(tdata.SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                     global_batch=4))
    before = tcore.quant_error_metrics(st.params, st.symog, scfg)["rel_quant_error"]
    for _ in range(4):
        st, m = step(st, next(data))
        assert np.isfinite(float(m["loss"]))
    after = tcore.quant_error_metrics(st.params, st.symog, scfg)["rel_quant_error"]
    assert float(after) < float(before)
    eng = ServeEngine.from_symog(cfg, st.params, st.symog, scfg, max_len=32,
                                 compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=L), max_new_tokens=5)
            for L in (6, 9)]
    comps = eng.serve(reqs, ServeConfig(n_slots=2, block_size=4))
    assert [len(c.tokens) for c in comps] == [5, 5]
    assert {c.finish_reason for c in comps} == {"length"}
