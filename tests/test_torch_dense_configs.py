"""Port parity for the dense decoders beside internlm2 (repro_torch vs the
JAX package), on REDUCED gemma2-27b (alternating local / global layers,
attention and final softcaps, post-norms), gemma3-4b (5:1 local / global,
two rope bases, qk-norm) and granite-34b (MQA, an untied head), fp32
compute on the CPU, with 2-bit ``pack_tree`` params: the port's seeded
``init_lm`` carried into JAX arrays (JAX's eager init takes ~10 s an arch;
tests/test_torch_lm.py holds the two inits' layouts equal), packed by JAX's
jitted ``symog_init`` + ``pack_tree`` and bridged back through numpy.  The
JAX model functions run jitted.  Prompts of 12 tokens run past the reduced window of 8,
so the window binds in prefill and in decode.

  - ``forward_lm``, ``prefill_lm`` (logits and k/v caches), dense
    ``decode_lm`` and paged ``decode_lm`` (block tables, one inactive row,
    the composed route and the plain version of the CUDA kernel) agree with
    JAX at 1e-4;
  - greedy ``serve()`` from a float pool is token-identical to JAX's
    ``serve()`` and to the port's own static dense-cache loop.
The configs themselves are held field by field to JAX's in
tests/test_torch_lm.py::test_configs_match_jax."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models import decode_lm as j_decode  # noqa: E402
from repro.models import forward_lm as j_forward  # noqa: E402
from repro.models import prefill_lm as j_prefill  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import decode_lm, forward_lm, init_lm, prefill_lm  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402

ARCHS = ["gemma2-27b", "gemma3-4b", "granite-34b"]
TOL = dict(rtol=1e-4, atol=1e-4)
T, MAX_LEN = 12, 24
_TREES = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(arch):
    """(cfg, jax tree, port tree): the 2-bit pack_tree of a seeded init."""
    if arch not in _TREES:
        cfg = jconfigs.get_reduced(arch)
        own = init_lm(0, cfg, device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        jp = jax.jit(lambda p: jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg))(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own))
        _TREES[arch] = (cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    return _TREES[arch]


def _jit(fn, **bound):
    return jax.jit(functools.partial(fn, **bound))


def _tokens(cfg, B=2, T=T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    cfg, jp, tp = _trees(arch)
    assert T > cfg.window and cfg.n_layers >= 4
    tok = _tokens(cfg)
    want = _jit(j_forward, cfg=cfg, compute_dtype=jnp.float32)(jp, {"tokens": jnp.asarray(tok)}).logits
    got = forward_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), **TOL)

    jl, jc = _jit(j_prefill, cfg=cfg, max_len=MAX_LEN, compute_dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(tok)})
    tl, tc = prefill_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, max_len=MAX_LEN,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers0"]["sub0"][name].numpy(),
                                   np.asarray(jc["layers0"]["sub0"][name]), **TOL)

    # paged pools from the same prefill caches, before the dense steps
    # update those caches in place
    block, nb, B = 4, MAX_LEN // 4, tok.shape[0]
    bt = (np.random.default_rng(4).permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    pools = {}
    for name in ("k", "v"):
        dense = np.asarray(jc["layers0"]["sub0"][name])  # (L, B, max_len, K, hd)
        pool = np.zeros((dense.shape[0], B * nb + 1, block) + dense.shape[3:], np.float32)
        for b in range(B):
            pool[:, bt[b]] = dense[:, b].reshape(dense.shape[0], nb, block, *dense.shape[3:])
        pools[name] = pool

    steps = _tokens(cfg, T=3, seed=2)
    dec = _jit(j_decode, cfg=cfg, compute_dtype=jnp.float32)
    for i in range(3):
        cur = steps[:, i: i + 1]
        jl, jc = dec(jp, jc, jnp.asarray(cur), jnp.int32(T + i))
        tl, tc = decode_lm(tp, tc, torch.from_numpy(cur), T + i, cfg, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    pos = np.asarray([T, T - 3], np.int32)
    active = np.asarray([True, False])
    jcache = {"layers0": {"sub0": {n: jnp.asarray(p) for n, p in pools.items()}}}
    want = []
    for i in range(3):
        cur = steps[:, i: i + 1]
        jl, jcache = dec(jp, jcache, jnp.asarray(cur), jnp.asarray(pos + i),
                         active=jnp.asarray(active), block_tables=jnp.asarray(bt))
        want.append(np.asarray(jl))
    for backend in ("composed", "fused"):
        tcache = {"layers0": {"sub0": {n: torch.from_numpy(p.copy()) for n, p in pools.items()}}}
        dispatch.set_attention_backend(backend)
        try:
            for i in range(3):
                tl, tcache = decode_lm(tp, tcache, torch.from_numpy(steps[:, i: i + 1]),
                                       torch.from_numpy(pos + i), cfg,
                                       compute_dtype=torch.float32,
                                       active=torch.from_numpy(active),
                                       block_tables=torch.from_numpy(bt))
                np.testing.assert_allclose(tl.numpy(), want[i], **TOL)
        finally:
            dispatch.set_attention_backend("auto")
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache["layers0"]["sub0"][name].numpy(),
                                       np.asarray(jcache["layers0"]["sub0"][name]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serve_matches_jax(arch):
    cfg, jp, tp = _trees(arch)
    jeng = JEngine(cfg, jp, max_len=MAX_LEN, compute_dtype=jnp.float32)
    teng = ServeEngine(cfg, tp, max_len=MAX_LEN, compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, size=L).astype(np.int32), b)
            for L, b in ((11, 5), (3, 6), (14, 4))]
    sc = dict(n_slots=2, block_size=4)
    jc = jeng.serve([JRequest(tokens=p, max_new_tokens=b) for p, b in reqs], JServeConfig(**sc))
    tc = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs], ServeConfig(**sc))
    for (p, b), j, t in zip(reqs, jc, tc):
        assert t.tokens == list(j.tokens)
        static = teng.generate_static({"tokens": p[None]}, b)[0].numpy()
        np.testing.assert_array_equal(np.asarray(t.tokens), static)
