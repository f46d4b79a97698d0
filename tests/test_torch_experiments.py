"""Port parity, the paper's experiments and the examples
(repro_torch.experiments / repro_torch.examples against benchmarks/ and
examples/ of the JAX package, on the CPU).

  - ``run_symog_protocol`` at 2 + 2 steps against JAX's
    ``benchmarks/common.py`` (loaded by path) from the same weights (the
    port's seeded ``cnn_init``, handed to JAX's through its ``cnn_init``)
    and the same data: the losses of both stages at rtol 1e-5, the error
    rates within one test image and the quantization errors at rtol 1e-4.
    LeNet-5 and VGG7 at width 0.125, batch 4: the CNN parity bar of the
    ROADMAP's caveats (a ReLU input within fp32 noise of 0 takes the other
    branch in one framework, which BN spreads over wider nets);
  - every experiment prints JAX's line names (the Table-1 modules run with
    the protocol cut to 1 + 1 steps in both packages; fig3 / fig4 by their
    sources' ``emit`` names);
  - each example's ``main`` at its smallest setting: the quickstart's
    orderings, the LM example's resume, the packed serve token-identical to
    the hard-quantized one;
  - ``-m slow``: table1_mnist's claim C1 and fig3's collapsed modes on the
    port's CPU path at the modules' own settings (the claims JAX's own CPU
    run of them passes).

~60 s alone, the slow cases included."""
import importlib
import importlib.util
import os
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import SyntheticImagesConfig as JImagesConfig  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.data import SyntheticImagesConfig  # noqa: E402
from repro_torch.examples import quickstart, serve_quantized, train_lm_symog  # noqa: E402
from repro_torch.experiments import common  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXPERIMENTS = ["table1_mnist", "table1_cifar10", "table1_cifar100", "fig3_distributions",
               "fig4_adaptation"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench(name):
    """A module of the JAX package's benchmarks/, loaded by path (its
    ``from benchmarks.common import ...`` resolves against the repo root)."""
    import sys

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    path = os.path.join(ROOT, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_bench_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["lenet5", "vgg7"])
def test_symog_protocol_matches_jax(name, monkeypatch):
    tcfg = tcnn.PAPER_CNNS[name] if name == "lenet5" else tcnn.reduced_cnn(name, 0.125)
    jcfg = jcnn.PAPER_CNNS[name] if name == "lenet5" else jcnn.reduced_cnn(name, 0.125)
    kw = dict(pretrain_steps=2, symog_steps=2, lr0=0.01, seed=4)
    data = dict(n_classes=tcfg.n_classes, hw=tcfg.input_hw, channels=tcfg.in_channels,
                global_batch=4, snr=0.8, seed=21)
    got = common.run_symog_protocol(tcfg, data_cfg=SyntheticImagesConfig(**data), device="cpu",
                                    **kw)

    jc = _jax_bench("common")
    params, bn = tcnn.cnn_init(kw["seed"], tcfg, device="cpu")
    to_jax = (lambda tree: jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree))
    monkeypatch.setattr(jc, "cnn_init", lambda key, cfg: (to_jax(params), to_jax(bn)))
    losses = []
    make = jc.make_cnn_train_step

    def recording(*a, **k):
        step = jax.jit(make(*a, **k))

        def run(st, batch):
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
            return st, m

        return run

    monkeypatch.setattr(jc, "make_cnn_train_step", recording)
    # the recording step jits itself: the module's jax.jit passes it through
    monkeypatch.setattr(jc, "jax", types.SimpleNamespace(jit=lambda f: f, random=jax.random))
    want = jc.run_symog_protocol(jcfg, data_cfg=JImagesConfig(**data), **kw)

    np.testing.assert_allclose(got["losses_float"] + got["losses_symog"], losses, rtol=1e-5)
    for key in ("err_float", "err_symog_q", "err_naive_q"):
        assert abs(got[key] - want[key]) <= 1 / 64 + 1e-9, key
    for key in ("rel_qerr_symog", "rel_qerr_naive"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_experiments_print_jax_line_names(name, monkeypatch, capsys):
    tmod = importlib.import_module(f"repro_torch.experiments.{name}")
    if not name.startswith("table1"):
        names = (lambda m: re.findall(r'emit\(\s*f?"([^"]+)"', open(m.__file__).read()))
        assert names(tmod) == names(_jax_bench(name)) and len(names(tmod)) >= 2
        return
    fake = {"err_float": 0.1, "err_symog_q": 0.1, "err_naive_q": 0.5, "rel_qerr_symog": 1e-3,
            "rel_qerr_naive": 0.4, "seconds": 1.0}
    jmod = _jax_bench(name)
    jnames = []
    monkeypatch.setattr(jmod, "run_symog_protocol", lambda cfg, **kw: fake)
    monkeypatch.setattr(jmod, "emit", lambda n, *a, **k: jnames.append(n))
    jmod.run()
    real = common.run_symog_protocol
    monkeypatch.setattr(tmod, "run_symog_protocol", lambda cfg, **kw: real(
        cfg, **dict(kw, pretrain_steps=1, symog_steps=1, device="cpu")))
    del common.EMITTED[:]
    tmod.run()
    assert [n for n, _, _ in common.EMITTED] == jnames and jnames
    out = capsys.readouterr().out
    assert re.search(rf"^{jnames[0]},[0-9.]+,err=[0-9.]+$", out, re.M)


def test_quickstart_main():
    r = quickstart.main(["--device", "cpu"])
    assert r["symog"] > r["naive"] and r["symog"] >= r["float"] - 0.05
    assert r["rel_quant_error"] < 0.05


def test_train_lm_symog_main_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    first = train_lm_symog.main(argv + ["--steps", "2"])
    again = train_lm_symog.main(argv + ["--steps", "3", "--resume"])
    assert len(first["losses"]) == 2 and len(again["losses"]) == 1
    assert all(np.isfinite(first["losses"] + again["losses"]))
    out = capsys.readouterr().out
    assert "model: lm10m" in out and "resumed from step 2" in out and "rel quant error" in out


def test_serve_quantized_main():
    r = serve_quantized.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--gen", "3"])
    assert r["packed_exact"] == 1.0 and r["tokens_packed"].shape == (2, 3)
    fbytes, pbytes = r["weight_bytes"]
    assert pbytes * 8 < fbytes and np.isfinite(r["loss"])


@pytest.mark.slow
@pytest.mark.parametrize("name,line", [("table1_mnist", "table1_mnist_claim_C1"),
                                       ("fig3_distributions", "fig3_modes_collapsed")])
def test_experiment_claims_hold_on_the_cpu(name, line):
    """The claims that JAX's own CPU run of the module passes (C1; Figure 3's
    collapsed modes), on the port's CPU path at the module's own settings
    (hundreds of LeNet-5 steps)."""
    mod = importlib.import_module(f"repro_torch.experiments.{name}")
    del common.EMITTED[:]
    mod.run(device="cpu")
    got = {n: d for n, _, d in common.EMITTED}
    assert "pass=True" in got[line], got
