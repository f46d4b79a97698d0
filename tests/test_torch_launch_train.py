"""Port parity, the training launcher and what it stands on
(repro_torch.launch.train against repro.launch.train on the CPU).

  - every module of the port imports FIRST in a fresh interpreter (the
    ``nn.tree`` / ``core`` import cycle), jax and repro blocked;
  - a ``TrainState`` checkpoint (reduced internlm2, SYMOG on, the launcher's
    ``chain(clip_by_global_norm(1.0), sgd(nesterov=True))``): the port's
    files and manifest equal the bytes JAX's ``CheckpointManager`` writes
    for the same numpy values (``params/…``, ``opt_state/1/…``, ``symog/0/…``,
    ``step`` int32), and each package restores the other's exactly;
  - the fused clipped update (the plain versions of ``symog_sqnorm`` and
    ``symog_update`` with ``gscale``) against the composed chain over 3
    steps with the clip active, reduced internlm2 and LeNet-5, at TRAIN_TOL
    (rtol 1e-5, tests/test_torch_train.py); the norm pass against fp64;
  - the launchers: the port resumes from JAX's launcher checkpoint and
    JAX's launcher from the port's; the next 3 steps' losses within rtol
    1e-5 of JAX's (tests/torch_train_parity.py's bar); a port-only
    ``--resume`` continues bit for bit; every JAX flag accepted, a ``--mesh``
    with a model axis > 1 (tensor-parallel training) taken, asking for its
    ranks (tests/test_torch_tp_train.py runs it on two);
  - ``nn``: the tree helpers against JAX's, the dtype policies, and each
    initializer held to its law (mean and std within 4 sigma, the ±2σ
    truncation, fans, dtypes; ``jax.random``'s bits are not reproduced).

Reduced configs, fp32, batch 2 x 16 tokens; ~60 s alone."""
import dataclasses
import filecmp
import functools
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.nn import tree as jtree  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import SyntheticImages, SyntheticImagesConfig  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.symog_update import symog_sqnorm  # noqa: E402
from repro_torch.kernels.symog_update.ref import _total_grad  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import PAPER_CNNS, cnn_init, init_lm  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths as t_flatten  # noqa: E402
from repro_torch.train import CNNTrainState, init_train_state  # noqa: E402
from repro_torch.train import make_cnn_train_step, make_train_step  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_train.py
ARCH = "internlm2-1.8b"
JAX_SMALL = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16", "--symog", "--lr",
             "0.05", "--log-every", "1", "--seed", "3"]
SMALL = JAX_SMALL + ["--device", "cpu"]


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


def _chain(o):
    return o.chain(o.clip_by_global_norm(1.0), o.sgd(momentum=0.9, nesterov=True))


# ---------------------------------------------------------------------------
# the import cycle
# ---------------------------------------------------------------------------
def test_every_module_imports_first_in_a_fresh_interpreter():
    """Each module of repro_torch imported first, with every repro_torch
    module dropped from sys.modules before it (``import repro_torch.nn``
    once raised: nn.tree imported core, whose metrics imported nn.tree)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'))\n"
        "failed = []\n"
        "for n in names:\n"
        "    for k in [k for k in sys.modules if k == 'repro_torch' or "
        "k.startswith('repro_torch.')]:\n"
        "        del sys.modules[k]\n"
        "    try:\n"
        "        importlib.import_module(n)\n"
        "    except Exception as e:\n"
        "        failed.append(f'{n}: {type(e).__name__}: {e}')\n"
        "print(len(names))\n"
        "print('\\n'.join(failed))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    count, *failed = out.stdout.strip().split("\n")
    assert int(count) >= 80 and not [f for f in failed if f], failed


# ---------------------------------------------------------------------------
# TrainState checkpoints
# ---------------------------------------------------------------------------
def _states(step=7):
    """The same numpy values as JAX's and the port's TrainState."""
    tcfg = tconfigs.get_reduced(ARCH)
    npp = jax.tree_util.tree_map(lambda t: t.numpy(), init_lm(0, tcfg, device="cpu"))
    rng = np.random.default_rng(1)
    mom = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), npp)
    jtx, ttx = _chain(joptim), _chain(toptim)
    js = j_init_state(jax.tree_util.tree_map(jnp.asarray, npp), jtx, jcore.SymogConfig(n_bits=2))
    js = js._replace(opt_state=((), jax.tree_util.tree_map(jnp.asarray, mom)),
                     step=jnp.asarray(step, jnp.int32))
    ts = init_train_state(params_from_numpy(npp), ttx, tcore.SymogConfig(n_bits=2))
    ts = ts._replace(opt_state=((), params_from_numpy(mom)), step=step)
    return js, ts


def _assert_states_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "TrainState" and a.step == b.step
    assert isinstance(a.step, int) and a.symog.mask == b.symog.mask
    for x, y in ((a.params, b.params), (a.opt_state[1], b.opt_state[1]), (a.symog.f, b.symog.f)):
        fx, fy = t_flatten(x), t_flatten(y)
        assert [p for p, _ in fx] == [p for p, _ in fy]
        for (path, u), (_, v) in zip(fx, fy):
            assert u.dtype == v.dtype and torch.equal(u, v), path


def test_train_state_checkpoint_matches_jax_bytes_and_restores_both_ways(tmp_path):
    js, ts = _states()
    meta = {"data": {"step": 5}}
    JManager(str(tmp_path / "jax")).save(7, js, metadata=meta, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(7, ts, metadata=meta, blocking=True)
    jd, td = str(tmp_path / "jax" / "ckpt_7"), str(tmp_path / "port" / "ckpt_7")
    names = sorted(os.listdir(td))
    assert names == sorted(os.listdir(jd))
    for name in names:
        assert filecmp.cmp(os.path.join(jd, name), os.path.join(td, name), shallow=False), name
    paths = set(_manifest_leaves(td))
    assert "step" in paths and "opt_state/1/embed/embedding" in paths
    assert "symog/0/layers0/sub0/attn/q_proj/kernel" in paths
    assert "params/final_norm/scale" in paths
    assert not any(p.startswith("opt_state/0") for p in paths)
    assert np.load(os.path.join(td, "step.npy")).dtype == np.int32
    # the port restores JAX's files, and JAX the port's
    back, got_meta, step = CheckpointManager(str(tmp_path / "jax")).restore(ts)
    assert step == 7 and got_meta == meta
    _assert_states_equal(back, ts)
    jback, _, _ = JManager(str(tmp_path / "port")).restore(jax.eval_shape(lambda: js))
    for (p, a), (_, b) in zip(jtree.flatten_with_paths(jback), jtree.flatten_with_paths(js)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=p)


def _manifest_leaves(directory):
    import json

    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)["leaves"]


# ---------------------------------------------------------------------------
# the fused clipped update
# ---------------------------------------------------------------------------
def _lm_run(route):
    cfg = tconfigs.get_reduced(ARCH)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
               for _ in range(3)]
    tx = _chain(toptim)
    scfg = tcore.SymogConfig(n_bits=2, total_steps=3)
    dispatch.set_update_backend(route)
    try:
        step = make_train_step(cfg, tx, tcore.linear_lr(0.05, 0.005, 3), symog_cfg=scfg,
                               compute_dtype=torch.float32)
    finally:
        dispatch.set_update_backend("auto")
    st = init_train_state(init_lm(0, cfg, device="cpu"), tx, scfg)
    metrics = []
    for b in batches:
        st, m = step(st, b)
        metrics.append(m)
    return st.params, st.opt_state[1], metrics


def _cnn_run(route):
    cfg = PAPER_CNNS["lenet5"]
    data = SyntheticImages(SyntheticImagesConfig(n_classes=10, hw=28, channels=1,
                                                 global_batch=8, seed=3))
    params, bn = cnn_init(1, cfg, device="cpu")
    tx = _chain(toptim)
    scfg = tcore.SymogConfig(n_bits=2, total_steps=3)
    dispatch.set_update_backend(route)
    try:
        step = make_cnn_train_step(cfg, tx, tcore.constant(0.05), symog_cfg=scfg)
    finally:
        dispatch.set_update_backend("auto")
    st = CNNTrainState(params, bn, tx.init(params), tcore.symog_init(params, scfg), 0)
    metrics = []
    for _ in range(3):
        st, m = step(st, next(data))
        metrics.append(m)
    return st.params, st.opt_state[1], metrics


@pytest.mark.parametrize("model", ["internlm2", "lenet5"])
def test_fused_clipped_update_matches_composed_chain(model):
    """3 steps of ``chain(clip_by_global_norm(1.0), sgd(nesterov=True))``
    with SYMOG on: the fused route (norm pass + ``symog_update`` with the
    clip scale, plain versions on the CPU) against the composed chain; the
    clip is active (scale < 1) at every step."""
    run = _lm_run if model == "internlm2" else _cnn_run
    (cp, cv, cm), (fp, fv, fm) = run("composed"), run("fused")
    for a, b in zip(cm, fm):
        assert set(a) == set(b) and "clip_scale" in a
        assert float(a["clip_scale"]) < 1.0
        np.testing.assert_allclose(float(b["clip_scale"]), float(a["clip_scale"]), rtol=1e-5)
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]), rtol=1e-5)
    for got, want in ((fp, cp), (fv, cv)):
        for (path, x), (_, y) in zip(t_flatten(got), t_flatten(want), strict=True):
            np.testing.assert_allclose(_np(x), _np(y), **TRAIN_TOL, err_msg=path)


@pytest.mark.parametrize("lead", [(), (3, 4)])
def test_norm_pass_plain_version_matches_fp64(lead):
    """``symog_sqnorm`` on the CPU: Σ (g + λ_eff·(w − q))² against fp64, with
    one Δ and with a Δ per leading group; q is the update's own."""
    rng = np.random.default_rng(5)
    shape = lead + (16, 8)
    f = rng.integers(1, 5, size=lead) if lead else np.array(3)
    d = np.exp2(-f.astype(np.float64)).reshape(lead + (1, 1))
    w = (rng.standard_normal(shape) * 1.3 * d).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    delta = torch.from_numpy(np.exp2(-f.astype(np.float32)).reshape(-1))
    got = symog_sqnorm(torch.from_numpy(w), torch.from_numpy(g), delta=delta, lam_eff=0.7)
    q = np.clip(np.round(w / d), -1, 1) * d
    want = np.sum(np.square(g.astype(np.float64) + 0.7 * (w - q)))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    _, _, g_tot = _total_grad(torch.from_numpy(w), torch.from_numpy(g), delta, 0.7, 2)
    assert torch.equal(got, torch.sum(g_tot * g_tot))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_launcher_step(steps):
    """JAX's launcher step (its tx, schedule and SymogConfig at SMALL's
    settings, ``--steps steps``), jitted once, and its state template."""
    from repro.models.lm import init_lm as j_init_lm

    cfg = jconfigs.get_reduced(ARCH)
    tx = _chain(joptim)
    scfg = jcore.SymogConfig(n_bits=2, total_steps=steps)
    step_fn = jax.jit(j_make_step(cfg, tx, jcore.linear_lr(0.05, 0.05 / 10, steps),
                                  symog_cfg=scfg, compute_dtype=jnp.float32))
    return cfg, step_fn, j_init_state(j_init_lm(jax.random.PRNGKey(3), cfg), tx, scfg)


def _jax_continue(ckpt_dir, steps, n):
    """JAX's launcher loop from ``ckpt_dir``'s latest checkpoint for ``n``
    steps: the losses unrounded."""
    from repro.data import SyntheticLM, SyntheticLMConfig

    cfg, step_fn, state = _jax_launcher_step(steps)
    state, meta, start = JManager(ckpt_dir).restore(jax.eval_shape(lambda: state))
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                                         seed=3))
    data.load_state_dict(meta["data"])
    losses = []
    for _ in range(n):
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in next(data).items()})
        losses.append(float(m["loss"]))
    return start, losses


def _port(argv):
    return tlaunch.main(SMALL + argv)


def test_launchers_resume_from_each_other(tmp_path, monkeypatch, capsys):
    """JAX's launcher writes step 2; the port's launcher resumes there, and
    its next 3 losses equal JAX's continuation at rtol 1e-5.  The port's
    launcher writes step 2; JAX's launcher loop (its template, restore and
    stream state, jitted once for both directions) resumes from it, and its
    losses equal the port's own continuation."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["train.py"] + JAX_SMALL + ["--steps", "2", "--ckpt-dir",
                                                               jdir])
    jlaunch.main()
    start, j_losses = _jax_continue(jdir, 5, 3)
    assert start == 2
    out = _port(["--steps", "5", "--ckpt-dir", jdir, "--resume"])
    assert out["start"] == 2 and len(out["losses"]) == 3
    np.testing.assert_allclose(out["losses"], j_losses, rtol=1e-5)
    text = capsys.readouterr().out
    assert "resumed from step 2" in text and "final rel quant error" in text
    assert re.search(r"step +4 loss [0-9.]+ gnorm [0-9.]+ λ [0-9.]+", text)

    first = _port(["--steps", "2", "--ckpt-dir", tdir])
    assert len(first["losses"]) == 2
    own = _port(["--steps", "5", "--ckpt-dir", tdir, "--resume"])
    # the port's resume wrote ckpt_5: JAX continues from the port's ckpt_2
    assert CheckpointManager(tdir).steps() == [2, 5]
    shutil.rmtree(os.path.join(tdir, "ckpt_5"))
    start, j_from_port = _jax_continue(tdir, 5, 3)
    assert start == 2
    np.testing.assert_allclose(own["losses"], j_from_port, rtol=1e-5)


def test_port_resume_is_bit_for_bit(tmp_path):
    """4 steps straight against 2 + ``--resume`` 2: params and momentum
    equal bit for bit, and so are the last two losses."""
    straight = _port(["--steps", "4"])
    _port(["--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    shutil.rmtree(os.path.join(str(tmp_path), "ckpt_4"))
    resumed = _port(["--steps", "4", "--ckpt-dir", str(tmp_path), "--resume"])
    assert resumed["start"] == 2 and resumed["losses"] == straight["losses"][2:]
    a, b = straight["state"], resumed["state"]
    assert a.step == b.step == 4
    for x, y in ((a.params, b.params), (a.opt_state[1], b.opt_state[1])):
        for (path, u), (_, v) in zip(t_flatten(x), t_flatten(y), strict=True):
            assert torch.equal(u, v), path


def test_launcher_flags_are_jax_flags_and_mesh_is_refused(capsys):
    src = open(jlaunch.__file__).read()
    jax_flags = set(re.findall(r'add_argument\("(--[a-z0-9-]+)"', src))
    port_flags = {o for a in tlaunch.build_parser()._actions for o in a.option_strings
                  if o.startswith("--") and o != "--help"}
    assert port_flags == jax_flags | {"--device"} and len(jax_flags) == 15
    # a model axis > 1 is tensor-parallel training: the mesh is taken and
    # asks for its 2 ranks (one process here; tests/test_torch_tp_train.py
    # runs it under two)
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "1x2"])
    err = capsys.readouterr().err
    assert "--mesh 1x2 needs 2 devices, have 1" in err and "not ported" not in err


# ---------------------------------------------------------------------------
# nn
# ---------------------------------------------------------------------------
def test_tree_helpers_match_jax():
    tcfg = tconfigs.get_reduced(ARCH)
    npp = jax.tree_util.tree_map(lambda t: t.numpy(), init_lm(0, tcfg, device="cpu"))
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = params_from_numpy(npp)
    assert tnn.tree_paths(tp) == jtree.tree_paths(jp)
    assert tnn.tree_size(tp) == jtree.tree_size(jp)
    pred = (lambda p, v: "attn" in p and v.ndim >= 2)
    got, want = tnn.tree_select(tp, pred), jtree.tree_select(jp, pred)
    assert sorted(got) == sorted(want) and len(got) > 0
    assert tnn.path_str(("layers0", "sub0", 3)) == jtree.path_str(("layers0", "sub0", 3))
    # packed: JAX counts a Packed leaf's two children
    scfg = jcore.SymogConfig(n_bits=2)
    jpk = jcore.pack_tree(jp, jcore.symog_init(jp, scfg), scfg)
    tpk = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpk))
    assert tnn.tree_size(tpk) == jtree.tree_size(jpk)


def test_dtype_policies():
    x = torch.ones(3)
    assert tnn.DEFAULT_POLICY.cast_compute(x).dtype == torch.bfloat16
    assert tnn.FP32_POLICY.cast_compute(x) is x
    assert tnn.DEFAULT_POLICY.cast_accum(x.to(torch.bfloat16)).dtype == torch.float32
    assert dataclasses.fields(tnn.DTypePolicy)[0].default == torch.float32


@pytest.mark.parametrize("name", ["normal", "truncated", "scaled", "he", "lecun", "zeros",
                                  "ones"])
def test_initializers_follow_their_laws(name):
    """JAX's laws, each drawn from a ``torch.Generator``: the sample mean and
    std within 4 sigma of the law's (std of the sample std ≈ σ/√(2n)), the
    truncation bounds, fans and dtypes."""
    shape = (256, 64, 3)
    init, std = {
        "normal": (tnn.normal_init(0.05), 0.05),
        "truncated": (tnn.truncated_normal_stddev(0.05), 0.05),
        "scaled": (tnn.scaled_normal(2.0, fan_axis=1), math.sqrt(2.0 / 64)),
        "he": (tnn.he_normal(in_axes=(0, 2)), math.sqrt(2.0 / (256 * 3))),
        "lecun": (tnn.lecun_normal(), math.sqrt(1.0 / 256)),
        "zeros": (tnn.zeros_init(), 0.0),
        "ones": (tnn.ones_init(), 0.0),
    }[name]
    gen = torch.Generator().manual_seed(0)
    x = init(gen, shape)
    assert tuple(x.shape) == shape and x.dtype == torch.float32
    assert init(torch.Generator().manual_seed(0), shape, torch.bfloat16).dtype == torch.bfloat16
    if name in ("zeros", "ones"):
        assert torch.equal(x, torch.full(shape, 1.0 if name == "ones" else 0.0))
        return
    xs = x.double().flatten().numpy()
    n = xs.size
    assert abs(xs.mean()) < 4 * std / math.sqrt(n)
    assert abs(xs.std() - std) < 4 * std / math.sqrt(2 * n)
    if name == "truncated":  # ±2σ of the unit normal, before the rescale
        assert np.abs(xs).max() <= 2.0 * std / tnn.initializers.TRUNC2_STD * (1 + 1e-6)
    assert not torch.equal(x, init(torch.Generator().manual_seed(1), shape))
    assert torch.equal(x, init(torch.Generator().manual_seed(0), shape))
