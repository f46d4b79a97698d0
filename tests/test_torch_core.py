"""Port parity, SYMOG core (repro_torch.core vs repro.core): the Δ=2^-f
search, the quantizer, bit-packing and the tree-level init / quantize / pack
must be BIT-EXACT — exponents, integer mantissas and packed words alike.

Also: the package imports with jax and the JAX package blocked and no GPU,
the entry points refuse to fall back to the CPU silently, and the bridge
keeps the JAX tree's keys, stacked axes and ``Packed.f`` shapes."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.nn.tree import flatten_with_paths as j_flatten  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths as t_flatten  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("f", [-1, 0, 3, 6])
def test_quantizer_bit_exact(n_bits, f):
    rng = np.random.default_rng(n_bits * 10 + f)
    delta = 2.0**-f
    x = (rng.standard_normal(4096) * 4 * delta).astype(np.float32)
    x[:64] = (np.arange(-32, 32) + 0.5) * delta  # exact half-step ties: round half to even
    jm = jcore.quantize_int(jnp.asarray(x), jcore.delta_from_f(f), n_bits)
    tm = tcore.quantize_int(torch.from_numpy(x), tcore.delta_from_f(f), n_bits)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    jq = jcore.quantize(jnp.asarray(x), jcore.delta_from_f(f), n_bits)
    tq = tcore.quantize(torch.from_numpy(x), tcore.delta_from_f(f), n_bits)
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))


@pytest.mark.parametrize("n_bits", [2, 4])
def test_quant_error_and_clip_bit_exact(n_bits):
    x = (np.random.default_rng(n_bits).standard_normal(512) * 0.7).astype(np.float32)
    d = 2.0**-2
    np.testing.assert_array_equal(
        _np(tcore.quant_error(torch.from_numpy(x), d, n_bits)),
        np.asarray(jcore.quant_error(jnp.asarray(x), d, n_bits)))
    np.testing.assert_array_equal(
        _np(tcore.clip_to_range(torch.from_numpy(x), d, n_bits)),
        np.asarray(jcore.clip_to_range(jnp.asarray(x), d, n_bits)))


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("shape,std", [((64, 48), 0.05), ((3, 32, 16), 0.3), ((128,), 1.0)])
def test_optimal_f_bit_exact(n_bits, shape, std):
    w = (np.random.default_rng(7).standard_normal(shape) * std).astype(np.float32)
    jf, jd = jcore.optimal_f(jnp.asarray(w), n_bits)
    tf, td = tcore.optimal_f(torch.from_numpy(w), n_bits)
    assert int(tf) == int(jf)
    assert float(td) == float(jd)


def test_optimal_f_ties_go_to_smaller_f():
    """All-zero weights quantize exactly under every f: the first (smallest)
    candidate wins in both frameworks."""
    w = np.zeros((8, 8), np.float32)
    jf, _ = jcore.optimal_f(jnp.asarray(w), 2)
    tf, _ = tcore.optimal_f(torch.from_numpy(w), 2)
    assert int(tf) == int(jf) == tcore.F_MIN


@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_pack_int_bit_exact_and_roundtrip(n_bits):
    q = 2 ** (n_bits - 1) - 1
    m = np.random.default_rng(n_bits).integers(-q, q + 1, size=(5, 6, 32)).astype(np.int32)
    jw = jcore.pack_int(jnp.asarray(m), n_bits)
    tw = tcore.pack_int(torch.from_numpy(m), n_bits)
    assert tw.dtype == torch.int8
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    back = tcore.unpack_int(tw, n_bits, 32)
    np.testing.assert_array_equal(_np(back).astype(np.int32), m)


def _jax_params():
    cfg = jconfigs.get_reduced("internlm2-1.8b")
    return cfg, j_init_lm(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("n_bits", [2, 4])
def test_symog_tree_bit_exact(n_bits):
    """symog_init's f tree, quantize_tree and pack_tree on bridged params
    equal the JAX package's bit for bit (scan-stacked leaves: scalar f)."""
    cfg, jp = _jax_params()
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jscfg = jcore.SymogConfig(n_bits=n_bits, total_steps=1)
    tscfg = tcore.SymogConfig(n_bits=n_bits, total_steps=1)
    jst, tst = jcore.symog_init(jp, jscfg), tcore.symog_init(tp, tscfg)
    assert jst.mask == tst.mask
    jf, tf = dict(j_flatten(jst.f)), dict(t_flatten(tst.f))
    assert set(jf) == set(tf)
    for path in jf:
        assert tuple(tf[path].shape) == tuple(np.shape(jf[path])), path
        np.testing.assert_array_equal(_np(tf[path]), np.asarray(jf[path]), err_msg=path)

    jq = dict(j_flatten(jcore.quantize_tree(jp, jst, jscfg)))
    tq = dict(t_flatten(tcore.quantize_tree(tp, tst, tscfg)))
    for path in jq:
        np.testing.assert_array_equal(_np(tq[path]), np.asarray(jq[path]), err_msg=path)

    jpk = jcore.pack_tree(jp, jst, jscfg)
    tpk = tcore.pack_tree(tp, tst, tscfg)
    jleaves = dict(jax.tree_util.tree_flatten_with_path(
        jpk, is_leaf=lambda x: isinstance(x, jcore.Packed))[0])
    packed_paths = 0
    for path, tleaf in t_flatten(tpk):
        jleaf = jleaves[tuple(jax.tree_util.DictKey(k) for k in path.split("/"))]
        if isinstance(tleaf, tcore.Packed):
            packed_paths += 1
            assert tleaf.n_bits == jleaf.n_bits and tleaf.shape == jleaf.shape
            np.testing.assert_array_equal(_np(tleaf.data), np.asarray(jleaf.data), err_msg=path)
            np.testing.assert_array_equal(_np(tleaf.f), np.asarray(jleaf.f), err_msg=path)
            assert tuple(tleaf.f.shape) == tuple(np.shape(jleaf.f)) == ()
        else:
            np.testing.assert_array_equal(_np(tleaf), np.asarray(jleaf), err_msg=path)
    assert packed_paths == 8  # embed + 7 stacked projections


def test_bridge_keeps_packed_leaves_and_stacked_axes():
    cfg, jp = _jax_params()
    scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
    jpk = jcore.pack_tree(jp, jcore.symog_init(jp, scfg), scfg)
    tpk = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpk))
    q = tpk["layers0"]["sub0"]["attn"]["q_proj"]["kernel"]
    assert isinstance(q, tcore.Packed) and q.data.dtype == torch.int8
    assert q.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert q.f.dtype == torch.int32 and q.f.ndim == 0
    assert tuple(tpk["final_norm"]["scale"].shape) == (cfg.d_model,)


def test_unpack_is_exact_dequantization():
    w = (np.random.default_rng(3).standard_normal((16, 32)) * 0.2).astype(np.float32)
    p = tcore.pack(torch.from_numpy(w), 3, 2)
    np.testing.assert_array_equal(
        _np(tcore.unpack(p)), np.asarray(jcore.quantize(jnp.asarray(w), 2.0**-3, 2)))


def test_port_imports_without_jax_repro_or_gpu():
    """Every module of repro_torch imports with jax and repro blocked in
    sys.modules and no visible GPU (chip_smoke.py too, up to its guard)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([SRC, os.path.join(SRC, "..")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no CUDA device and no explicit device, entry points raise."""
    from repro_torch.models import init_lm
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_reduced("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(0, cfg)
    params = init_lm(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_len=16)
    assert ServeEngine(cfg, params, max_len=16, device="cpu").device.type == "cpu"


def test_dispatch_resolves_per_device():
    assert dispatch.resolve_packed_backend("cpu") == "unpack"
    assert dispatch.resolve_attention_backend("cpu") == "composed"
    assert dispatch.resolve_packed_backend("cuda") == "kernel"
    assert dispatch.resolve_attention_backend("cuda") == "fused"
    with pytest.raises(ValueError):
        dispatch.set_packed_backend("pallas")
    with pytest.raises(ValueError):
        dispatch.set_attention_backend("fused-interpret")
