"""Port parity, decoder LM (repro_torch.models vs repro.models) on REDUCED
internlm2-1.8b with JAX-initialized params bridged through numpy, fp32
compute: ``forward_lm``, ``prefill_lm`` and ``decode_lm`` on the dense and
the paged cache agree at 1e-4 for float, ``quantize_tree`` and ``pack_tree``
params (the packed tree on the CPU's unpack path)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models import decode_lm as j_decode  # noqa: E402
from repro.models import forward_lm as j_forward  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models import prefill_lm as j_prefill  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import DecoderLM, decode_lm, forward_lm, init_lm, prefill_lm  # noqa: E402
from repro_torch.models import tree_has_packed  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
_TREES = {}


def _trees(kind):
    """(cfg, jax tree, port tree) per param kind, built once per module."""
    if kind not in _TREES:
        cfg = jconfigs.get_reduced("internlm2-1.8b")
        jp = j_init(jax.random.PRNGKey(0), cfg)
        if kind != "float":
            scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
            st = jcore.symog_init(jp, scfg)
            jp = (jcore.quantize_tree if kind == "quantize_tree" else jcore.pack_tree)(jp, st, scfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
        _TREES[kind] = (cfg, jp, tp)
    return _TREES[kind]


def _tokens(B=2, T=7, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, T)).astype(np.int32)


KINDS = ["float", "quantize_tree", "pack_tree"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b", "deepseek-v3-671b", "gemma2-27b",
                                  "gemma3-4b", "granite-34b"])
def test_configs_match_jax(arch):
    """The port's config keeps the fields it reads; each equals JAX's."""
    import dataclasses

    assert arch in tconfigs.ARCHS
    for get in ("get_config", "get_reduced"):
        t = getattr(tconfigs, get)(arch)
        j = getattr(jconfigs, get)(arch)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.layer_kinds() == j.layer_kinds()
        assert t.layer_windows() == j.layer_windows()
        assert t.layer_rope_bases() == j.layer_rope_bases()


@pytest.mark.parametrize("kind", KINDS)
def test_forward_lm_matches_jax(kind):
    cfg, jp, tp = _trees(kind)
    assert tree_has_packed(tp) == (kind == "pack_tree")
    tok = _tokens()
    want = j_forward(jp, {"tokens": jnp.asarray(tok)}, cfg, compute_dtype=jnp.float32).logits
    got = forward_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), **TOL)
    mod = DecoderLM(cfg, tp)
    np.testing.assert_array_equal(mod(torch.from_numpy(tok), compute_dtype=torch.float32).numpy(),
                                  got.logits.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_and_dense_decode_match_jax(kind):
    cfg, jp, tp = _trees(kind)
    tok = _tokens(seed=1)
    T, max_len = tok.shape[1], 16
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(tok)}, cfg, max_len=max_len,
                       compute_dtype=jnp.float32)
    tl, tc = prefill_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, max_len=max_len,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers0"]["sub0"][name].numpy(),
                                   np.asarray(jc["layers0"]["sub0"][name]), **TOL)
    steps = _tokens(B=2, T=3, seed=2)
    for i in range(3):
        cur = steps[:, i : i + 1]
        jl, jc = j_decode(jp, jc, jnp.asarray(cur), jnp.int32(T + i), cfg,
                          compute_dtype=jnp.float32)
        tl, tc = decode_lm(tp, tc, torch.from_numpy(cur), T + i, cfg,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_paged_decode_matches_jax(kind, backend):
    """Per-row positions through block tables with one inactive row; the
    pools start from the same prefill caches in both frameworks."""
    cfg, jp, tp = _trees(kind)
    tok = _tokens(seed=3)
    T, block, max_len = tok.shape[1], 4, 16
    _, jc = j_prefill(jp, {"tokens": jnp.asarray(tok)}, cfg, max_len=max_len,
                      compute_dtype=jnp.float32)
    nb = max_len // block
    B = tok.shape[0]
    bt = (np.random.default_rng(4).permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    pools = {}
    for name in ("k", "v"):
        dense = np.asarray(jc["layers0"]["sub0"][name])  # (L, B, max_len, K, hd)
        pool = np.zeros((dense.shape[0], B * nb + 1, block) + dense.shape[3:], np.float32)
        for b in range(B):
            pool[:, bt[b]] = dense[:, b].reshape(dense.shape[0], nb, block, *dense.shape[3:])
        pools[name] = pool
    jcache = {"layers0": {"sub0": {n: jnp.asarray(p) for n, p in pools.items()}}}
    tcache = {"layers0": {"sub0": {n: torch.from_numpy(p.copy()) for n, p in pools.items()}}}
    pos = np.asarray([T, T - 2], np.int32)
    active = np.asarray([True, False])
    steps = _tokens(B=2, T=3, seed=5)
    dispatch.set_attention_backend(backend)
    try:
        for i in range(3):
            cur = steps[:, i : i + 1]
            jl, jcache = j_decode(jp, jcache, jnp.asarray(cur), jnp.asarray(pos + i), cfg,
                                  compute_dtype=jnp.float32, active=jnp.asarray(active),
                                  block_tables=jnp.asarray(bt))
            tl, tcache = decode_lm(tp, tcache, torch.from_numpy(cur), torch.from_numpy(pos + i),
                                   cfg, compute_dtype=torch.float32,
                                   active=torch.from_numpy(active), block_tables=torch.from_numpy(bt))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    finally:
        dispatch.set_attention_backend("auto")
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["layers0"]["sub0"][name].numpy(),
                                   np.asarray(jcache["layers0"]["sub0"][name]), **TOL)


def test_unpack_params_equals_quantize_tree():
    """Dequantizing the bridged packed artifact is exact: it equals the
    quantize_tree floats leaf for leaf."""
    from repro_torch.models import unpack_params
    from repro_torch.nn.tree import flatten_with_paths

    dense = dict(flatten_with_paths(unpack_params(_trees("pack_tree")[2])))
    for path, leaf in flatten_with_paths(_trees("quantize_tree")[2]):
        torch.testing.assert_close(dense[path], leaf, rtol=0, atol=0)


def test_init_lm_layout_matches_jax():
    """The port's own init has the JAX tree's keys, shapes and dtypes."""
    cfg, jp, _ = _trees("float")
    tp = init_lm(0, cfg, device="cpu")
    jshapes = {"/".join(str(k.key) for k in p): tuple(v.shape)
               for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    from repro_torch.nn.tree import flatten_with_paths

    tshapes = {p: tuple(v.shape) for p, v in flatten_with_paths(tp)}
    assert tshapes == jshapes
    g = torch.Generator().manual_seed(0)
    tp2 = init_lm(g, cfg, device="cpu")
    torch.testing.assert_close(tp2["embed"]["embedding"], tp["embed"]["embedding"])
