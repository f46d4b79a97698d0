"""Port parity, the serve launcher (``python -m repro_torch.launch.serve``
against ``python -m repro.launch.serve``), reduced internlm2 on the CPU.

  - ``make_ragged_workload`` draws JAX's workload from the same seed
    (prompts, budgets, arrivals, the shared system prompt), through the
    numpy Threefry of ``launch/threefry.py``, itself held to ``jax.random``;
  - ``main()`` with ``--device cpu --reduced --packed --continuous`` writes
    metrics JSON (float and packed runs) whose counters, gauges and
    step-unit histograms equal JAX's launcher on the same argv (the
    wall-time metrics by name), with and without a JAX-written
    ``--ckpt-dir``; the trace and the profiler window are written;
  - the same on reduced mamba2 and recurrentgemma (no checkpoint), and on
    reduced whisper and paligemma, whose requests carry frames / patches
    (the port draws them from its own generator: the metrics do not read
    them);
  - ``--mesh`` and ``--moe-impl`` are refused with the ROADMAP item that
    brings them."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.models.lm import init_lm as jinit_lm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import threefry  # noqa: E402

ARGV = ["--arch", "internlm2-1.8b", "--reduced", "--packed", "--continuous", "--requests", "4",
        "--slots", "2", "--prompt-len", "8", "--steps", "6", "--kv-bits", "4"]
WALL = ("serve_itl_seconds", "serve_step_time_ewma_seconds", "serve_straggler_fraction")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_threefry_equals_jax_random():
    for seed in (0, 3, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        assert np.array_equal(np.asarray(key), threefry.prng_key(seed))
        for data in (0, 7, 10_000):
            jk, tk = jax.random.fold_in(key, data), threefry.fold_in(threefry.prng_key(seed), data)
            assert np.array_equal(np.asarray(jk), tk)
            assert np.array_equal(np.asarray(jax.random.split(jk)), threefry.split(tk))
            for shape, lo, hi in (((7,), 0, 92544), ((3, 5), 0, 256), ((4,), 5, 6), ((2,), 0, 1),
                                  ((6,), 0, 2**31 - 1), ((5,), -3, 40000)):
                assert np.array_equal(np.asarray(jax.random.randint(jk, shape, lo, hi)),
                                      threefry.randint(tk, shape, lo, hi))


@pytest.mark.parametrize("seed,system_len", [(0, 0), (5, 6)])
def test_make_ragged_workload_equals_jax(seed, system_len):
    kw = dict(n_requests=9, prompt_len=7, steps=11, seed=seed, system_len=system_len)
    ours = tlaunch.make_ragged_workload(tconfigs.get_reduced("internlm2-1.8b"), **kw)
    ref = jlaunch.make_ragged_workload(jconfigs.get_reduced("internlm2-1.8b"), **kw)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
        assert (a.max_new_tokens, a.arrival) == (b.max_new_tokens, b.arrival)


def _metrics(path):
    doc = json.load(open(path))
    assert doc["label"] and doc["requests"] == 4
    return {k: (v["count"] if isinstance(v, dict) else "wall") if k in WALL else v
            for k, v in doc["metrics"].items()}


def _jax_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    jlaunch.main()


@pytest.mark.parametrize("ckpt", [False, True])
def test_main_metrics_equal_jax(tmp_path, monkeypatch, capsys, ckpt):
    extra = []
    if ckpt:
        cfg = jconfigs.get_reduced("internlm2-1.8b")
        JManager(str(tmp_path / "ckpt")).save(
            1, jinit_lm(jax.random.PRNGKey(5), cfg), blocking=True)
        extra = ["--ckpt-dir", str(tmp_path / "ckpt")]
    _jax_main(ARGV + extra + ["--metrics-json", str(tmp_path / "jax.json")], monkeypatch)
    capsys.readouterr()
    tlaunch.main(ARGV + extra + [
        "--device", "cpu", "--metrics-json", str(tmp_path / "port.json"),
        "--trace-out", str(tmp_path / "trace.json"),
        "--profile-dir", str(tmp_path / "prof"), "--profile-steps", "2"])
    out = capsys.readouterr().out
    for suffix in ("", ".packed"):
        port = _metrics(str(tmp_path / f"port{suffix}.json"))
        assert port == _metrics(str(tmp_path / f"jax{suffix}.json"))
        assert port["serve_admissions"] == 4 and port["serve_decode_steps"] > 0
    assert ("restored checkpoint step 1" in out) == ckpt
    spans = json.load(open(tmp_path / "trace.packed.json"))["traceEvents"]
    assert {"admit", "decode"} <= {e["name"] for e in spans}
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 2  # the float and the packed runs' windows


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_main_metrics_equal_jax_recurrent(arch, tmp_path, monkeypatch, capsys):
    """The recurrent families through both launchers: resident states
    beside the paged pool (recurrentgemma's local attention; none for
    mamba2), the int4 flag falling back to a float pool as JAX's rule
    says; counters, gauges and histograms equal."""
    argv = ["--arch", arch] + ARGV[2:]
    _jax_main(argv + ["--metrics-json", str(tmp_path / "jax.json")], monkeypatch)
    capsys.readouterr()
    tlaunch.main(argv + ["--device", "cpu", "--metrics-json", str(tmp_path / "port.json")])
    for suffix in ("", ".packed"):
        port = _metrics(str(tmp_path / f"port{suffix}.json"))
        assert port == _metrics(str(tmp_path / f"jax{suffix}.json"))
        assert port["serve_admissions"] == 4 and port["serve_decode_steps"] > 0
        assert port["serve_pool_bytes"] > 0


@pytest.mark.parametrize("arch", ["whisper-large-v3", "paligemma-3b"])
def test_main_metrics_equal_jax_encdec_vlm(arch, tmp_path, monkeypatch, capsys):
    """whisper (cross-kv resident a slot beside the paged self-attention)
    and paligemma (the image prefix in every row's first blocks, max_len
    widened by it) through both launchers, the int4 flag falling back to a
    float pool: counters, gauges and histograms equal; the non-continuous
    path generates with per-row extras."""
    argv = ["--arch", arch] + ARGV[2:]
    _jax_main(argv + ["--metrics-json", str(tmp_path / "jax.json")], monkeypatch)
    capsys.readouterr()
    tlaunch.main(argv + ["--device", "cpu", "--metrics-json", str(tmp_path / "port.json")])
    for suffix in ("", ".packed"):
        port = _metrics(str(tmp_path / f"port{suffix}.json"))
        assert port == _metrics(str(tmp_path / f"jax{suffix}.json"))
        assert port["serve_admissions"] == 4 and port["serve_decode_steps"] > 0
    tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--packed", "--batch", "2",
                  "--prompt-len", "5", "--steps", "3"])
    assert "packed vs quantized token agreement: 100.00%" in capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    (["--mesh", "1x1"], "Queue 1 item 5"),
    (["--moe-impl", "ep"], "Queue 1 item 5"),
])
def test_refused_flags_name_the_roadmap_item(argv, needle, capsys):
    base = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        tlaunch.main(base + argv)
    assert e.value.code == 2 and needle in capsys.readouterr().err
