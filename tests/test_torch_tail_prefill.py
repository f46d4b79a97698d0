"""Port parity, the tail-prefill admission (``prefill_prefix_lm``) and the
SYMOG KV tier on all-attention decoders (repro_torch vs the JAX package),
reduced configs, fp32 compute, on the CPU.  Params are the 2-bit
``pack_tree`` of the port's seeded ``init_lm``, packed by JAX's jitted
``symog_init`` + ``pack_tree`` (as tests/test_torch_dense_configs.py).

  - at start 0 over a float pool, ``prefill_prefix_lm`` equals the bucketed
    ``prefill_lm``: last-real-position logits and the k/v it leaves in the
    pool, for internlm2, gemma3 and granite;
  - at start > 0, over a pool an earlier admission filled (the window and a
    half-filled block bind), it equals JAX's jitted ``prefill_prefix_lm``:
    logits at 1e-4, a float pool at 1e-4, a quantized pool's words and
    exponents array_equal;
  - greedy ``serve()`` of reduced internlm2, gemma2, gemma3 and granite from
    ``int8_fp`` and ``int4_fp`` pools, every admission a tail prefill: token-
    identical to JAX's jitted serve, with pools and per-block exponents
    array_equal outside the trash block (physical row 0, where a bucket's
    pad rows all scatter, in an order neither package defines);
  - ``capabilities()`` agrees with JAX's on ``fully_paged`` and the
    features that ride it for every arch the port has."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models.lm import prefill_prefix_lm as j_prefill_prefix  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import init_lm, prefill_lm, prefill_prefix_lm  # noqa: E402
from repro_torch.models.attention import paged_gather  # noqa: E402
from repro_torch.serve import Request, Scheduler, ServeConfig, ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN, BLOCK = 32, 4
_TREES = {}


def _trees(arch):
    """(cfg, jax tree, port tree) of ``arch``'s reduced config."""
    if arch not in _TREES:
        cfg = jconfigs.get_reduced(arch)
        own = init_lm(0, tconfigs.get_reduced(arch), device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        jp = jax.jit(lambda p: jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg))(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own))
        _TREES[arch] = (cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    return _TREES[arch]


def _engine(arch, kv):
    cfg, _, tp = _trees(arch)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    return ServeEngine(cfg, tp, max_len=MAX_LEN, compute_dtype=torch.float32, device="cpu")


def _pool(eng):
    """Zero pools in the scheduler's layout: one slot, (L, n_phys, BLOCK, ...)."""
    return Scheduler(eng, ServeConfig(n_slots=1, block_size=BLOCK)).caches


def _leaves(caches, prefix=()):
    if isinstance(caches, dict):
        for k in sorted(caches):
            yield from _leaves(caches[k], prefix + (k,))
    else:
        yield prefix, caches


def _padded(prompt, bucket):
    out = np.zeros((1, bucket), np.int32)
    out[0, : len(prompt)] = prompt
    return out


# a shuffled table row: logical block i lives in physical block ROW[i]
ROW = np.asarray([5, 2, 7, 1, 8, 3, 6, 4], np.int32)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b", "granite-34b"])
def test_prefix_prefill_at_start0_equals_prefill_lm(arch):
    eng = _engine(arch, "bf16")
    cfg, tp = eng.cfg, eng.params
    lp, bucket = 11, 16
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=lp).astype(np.int32)
    tokens = torch.from_numpy(_padded(prompt, bucket))
    row = ROW.copy()
    row[lp // BLOCK + 1:] = 0  # unallocated entries: the trash block
    caches = _pool(eng)
    got, caches = prefill_prefix_lm(tp, {"tokens": tokens}, caches, torch.from_numpy(row), 0,
                                    cfg, seq_len=lp, compute_dtype=torch.float32)
    want, dense = prefill_lm(tp, {"tokens": tokens}, cfg, max_len=MAX_LEN,
                             compute_dtype=torch.float32, seq_len=lp)
    assert got.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        pool = caches["layers0"]["sub0"][name]  # (L, n_phys, BLOCK, K, hd)
        logical = torch.stack([paged_gather(p, torch.from_numpy(row)[None])[0] for p in pool])
        np.testing.assert_allclose(logical[:, :lp].numpy(),
                                   dense["layers0"]["sub0"][name][:, 0, :lp].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,kv", [("internlm2-1.8b", "bf16"), ("gemma3-4b", "int4_fp"),
                                     ("granite-34b", "int8_fp")])
def test_prefix_prefill_after_a_cached_prefix_matches_jax(arch, kv):
    """An admission of 10 tokens at start 0, then a tail of 7 at start 10:
    the tail's first token shares block 2 with the prefix's last two (its
    exponent set by the prefix), and at 17 tokens the window of 8 binds."""
    eng = _engine(arch, kv)
    cfg, tp = eng.cfg, eng.params
    jp = _trees(arch)[1]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=17).astype(np.int32)
    row = ROW.copy()
    row[17 // BLOCK + 1:] = 0
    caches = _pool(eng)
    jcaches = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), caches)
    for start, lp, bucket in ((0, 10, 16), (10, 7, 8)):
        tokens = _padded(prompt[start: start + lp], bucket)
        jfn = jax.jit(functools.partial(j_prefill_prefix, cfg=cfg, compute_dtype=jnp.float32))
        want, jcaches = jfn(jp, {"tokens": jnp.asarray(tokens)}, jcaches, jnp.asarray(row),
                            jnp.int32(start), seq_len=jnp.int32(lp))
        got, caches = prefill_prefix_lm(tp, {"tokens": torch.from_numpy(tokens)}, caches,
                                        torch.from_numpy(row), start, cfg, seq_len=lp,
                                        compute_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jcaches)))
        for path, leaf in _leaves(caches):
            a, b = leaf.numpy()[:, 1:], jl[path][:, 1:]  # the trash block aside
            if kv == "bf16":
                np.testing.assert_allclose(a, b, **TOL)
            else:
                np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("kv", ["int8_fp", "int4_fp"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-27b", "gemma3-4b", "granite-34b"])
def test_quantized_pool_serve_matches_jax(arch, kv):
    """Every admission is a tail prefill (start 0); block 4 makes decode open
    new blocks; prompts of 11 and 14 tokens run past the window of 8."""
    eng = _engine(arch, kv)
    cfg = eng.cfg
    jeng = JEngine(cfg, _trees(arch)[1], max_len=MAX_LEN, compute_dtype=jnp.float32)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, size=L).astype(np.int32), b)
            for L, b in ((11, 5), (3, 6), (14, 4))]
    sc = dict(n_slots=2, block_size=BLOCK)
    jc, js = jeng.serve([JRequest(tokens=p, max_new_tokens=b) for p, b in reqs],
                        JServeConfig(**sc), return_scheduler=True)
    tc, ts = eng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                       ServeConfig(**sc), return_scheduler=True)
    assert ts._quant_admit and js._quant_admit
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert ts.stats["prefills"] == js.stats["prefills"] == len(reqs)
    assert ts.stats["admission_traces"] == 2  # tail buckets 16 and 4
    assert set(eng._sched_fns[(True, 0)]._admits_prefix) == {(16, BLOCK), (4, BLOCK)}
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, js.caches)))
    tl = dict(_leaves(ts.caches))
    assert sorted(jl) == sorted(tl)
    assert {p[-1] for p in tl} == {"k", "v", "k_scale", "v_scale"}
    for path, leaf in tl.items():
        assert leaf.dtype == (torch.int32 if path[-1].endswith("_scale") else torch.int8)
        np.testing.assert_array_equal(leaf.numpy()[:, 1:], jl[path][:, 1:], err_msg=str(path))
    again = eng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs], ServeConfig(**sc))
    assert [c.tokens for c in again] == [c.tokens for c in tc]


def test_capabilities_fully_paged_match_jax():
    for arch in tconfigs.ARCHS:
        cfg = dataclasses.replace(jconfigs.get_reduced(arch), kv_cache_dtype="int4_fp")
        own = init_lm(0, tconfigs.get_reduced(arch), device="cpu")
        jeng = JEngine(cfg, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own),
                       max_len=16, compute_dtype=jnp.float32)
        teng = ServeEngine(cfg, own, max_len=16, compute_dtype=torch.float32, device="cpu")
        jcaps, got = jeng.capabilities(), teng.capabilities()
        want = jcaps["fully_paged"]
        assert bool(got["fully_paged"]) == bool(want), arch
        assert bool(got["fully_paged"].reason) == (not want), arch
        for name in ("prefix_cache", "chunked_prefill", "speculative", "ep_moe"):
            assert bool(got[name]) == bool(jcaps[name]), (arch, name)
            assert bool(got[name].reason) == (not jcaps[name]), (arch, name)
        sched = Scheduler(teng, ServeConfig(n_slots=1, block_size=BLOCK))
        assert sched._quant_admit == bool(want)
