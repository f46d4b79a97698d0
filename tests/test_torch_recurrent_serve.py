"""Port parity, serving the recurrent families (repro_torch vs the JAX
package): reduced mamba2 and recurrentgemma on the CPU, fp32, ``MAX_LEN``
32, block 4, the port's seeded ``init_lm`` packed by JAX's jitted
``symog_init`` + ``pack_tree`` (or ``quantize_tree``); JAX's serves jitted.

  - greedy ``serve()`` token-identical to JAX's serve and to the port's
    static loop (``generate_static``), under a pool small enough to preempt
    and with an EOS eviction, for packed and ``quantize_tree`` params; the
    pools after the serve (recurrent / SSD states resident a slot, the
    local attention layers' k/v paged) equal JAX's;
  - ``kv_cache_dtype`` under the non-decoder rule: ``kv_quant_bits`` 0 as
    in JAX; under int8_fp recurrentgemma's attention pools are KV_F int8
    words with no ``_scale`` leaves, ``array_equal`` to JAX's; under
    int4_fp they fall back to float;
  - the pool layout (``prefill_cache_specs``) has the shapes and dtypes of
    the caches the port's prefill writes and of JAX's ``eval_shape`` of
    its prefill, for every family at bf16 and int8_fp;
  - a slot left inactive by an eviction keeps its resident state bit for
    bit while the other slot decodes;
  - the prefix cache, chunked prefill and speculation are accepted and
    inert (no hit, no chunk, no round; tokens unchanged), and
    ``capabilities()`` equals JAX's, reasons included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models import prefill_lm as j_prefill  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import init_lm, prefill_lm  # noqa: E402
from repro_torch.models.lm import PAGED_CACHE_LEAVES  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    Scheduler,
    ServeConfig,
    ServeEngine,
    SpeculativeConfig,
)

ARCHS = ["mamba2-2.7b", "recurrentgemma-2b"]
MAX_LEN, BLOCK = 32, 4
TOL = dict(rtol=1e-4, atol=1e-4)
_TREES = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(arch, tree="pack_tree"):
    """(jax tree, port tree) of the port's seeded init, 2-bit ``pack_tree``
    or ``quantize_tree`` by JAX's jitted functions."""
    key = (arch, tree)
    if key not in _TREES:
        cfg = jconfigs.get_reduced(arch)
        own = init_lm(0, cfg, device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        fn = getattr(jcore, tree)
        jp = jax.jit(lambda p: fn(p, jcore.symog_init(p, scfg), scfg))(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own))
        _TREES[key] = (jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    return _TREES[key]


def _engines(arch, kv="bf16", tree="pack_tree"):
    cfg = dataclasses.replace(jconfigs.get_reduced(arch), kv_cache_dtype=kv)
    jp, tp = _trees(arch, tree)
    return (JEngine(cfg, jp, max_len=MAX_LEN, compute_dtype=jnp.float32),
            ServeEngine(cfg, tp, max_len=MAX_LEN, compute_dtype=torch.float32, device="cpu"))


def _requests(cfg, lens=(11, 5, 14, 3, 9), budgets=(8, 6, 7, 9, 5), seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, size=L).astype(np.int32), b)
            for L, b in zip(lens, budgets)]


def _serve_both(jeng, teng, reqs, eos=None, **sc):
    eos = eos or {}
    jc, js = jeng.serve([JRequest(tokens=p, max_new_tokens=b, eos_id=eos.get(i, -1))
                         for i, (p, b) in enumerate(reqs)], JServeConfig(**sc),
                        return_scheduler=True)
    tc, ts = teng.serve([Request(tokens=p, max_new_tokens=b, eos_id=eos.get(i, -1))
                         for i, (p, b) in enumerate(reqs)], ServeConfig(**sc),
                        return_scheduler=True)
    assert [c.tokens for c in tc] == [list(map(int, c.tokens)) for c in jc]
    assert [c.finish_reason for c in tc] == [c.finish_reason for c in jc]
    return tc, ts, js


def _pools(ts, js):
    """{path: (port leaf, JAX leaf)} of the two schedulers' pools."""
    got = dict(flatten_with_paths(ts.caches))
    want = {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(js.caches)[0]}
    assert set(got) == set(want)
    return {p: (got[p], want[p]) for p in got}


def _past_trash(path, a, groups):
    """A paged leaf without its trash block (physical row 0): rows no live
    request owns, written in an order neither package defines."""
    stacked = next(g for g in groups if path.startswith(g.name + "/")).stacked
    return a[:, 1:] if stacked else a[1:]


def _check_pools(ts, js, exact_paged=False):
    for path, (t, j) in _pools(ts, js).items():
        assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == (j.shape, str(j.dtype)), path
        if path.rsplit("/", 1)[-1] in PAGED_CACHE_LEAVES:
            t, j = _past_trash(path, t.numpy(), ts._groups), _past_trash(path, j, ts._groups)
            if exact_paged:
                np.testing.assert_array_equal(t, j, err_msg=path)
                continue
        np.testing.assert_allclose(np.asarray(t, np.float32), np.asarray(j, np.float32), **TOL,
                                   err_msg=path)


def _eos_for(teng, reqs, i=0, at=2):
    """An eos id that request ``i`` emits at its ``at``-th step."""
    p, b = reqs[i]
    return int(teng.generate_static({"tokens": p[None]}, b)[0, at])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serve_matches_jax_and_static(arch):
    """A pool of 8 blocks (one max_len request) for two slots that grow to
    6 and 7 blocks preempts; request 3 stops at an EOS."""
    jeng, teng = _engines(arch)
    reqs = _requests(teng.cfg, lens=(14, 13, 11, 5, 9), budgets=(10, 12, 7, 9, 5))
    eos = {3: _eos_for(teng, reqs, i=3)}
    tc, ts, js = _serve_both(jeng, teng, reqs, eos, n_slots=2, block_size=BLOCK, n_blocks=8)
    assert ts.stats["preemptions"] == js.stats["preemptions"] > 0
    assert tc[3].finish_reason == "eos"
    for (p, b), c in zip(reqs, tc):
        static = teng.generate_static({"tokens": p[None]}, b)[0].numpy()
        np.testing.assert_array_equal(np.asarray(c.tokens), static[: len(c.tokens)])
    _check_pools(ts, js)


@pytest.mark.slow
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_serve_matches_jax_and_packed(arch):
    """``quantize_tree`` params serve the packed params' tokens, and JAX's,
    under the preempting pool."""
    jeng, teng = _engines(arch, tree="quantize_tree")
    reqs = _requests(teng.cfg, lens=(14, 13, 11, 5, 9), budgets=(10, 12, 7, 9, 5))
    tc, ts, js = _serve_both(jeng, teng, reqs, n_slots=2, block_size=BLOCK, n_blocks=8)
    assert ts.stats["preemptions"] > 0
    packed = _engines(arch)[1].serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                                     ServeConfig(n_slots=2, block_size=BLOCK, n_blocks=8))
    assert [c.tokens for c in tc] == [c.tokens for c in packed]
    _check_pools(ts, js)


@pytest.mark.parametrize("kv", ["int8_fp", "int4_fp"])
def test_kv_cache_dtype_follows_the_non_decoder_rule(kv):
    """A hybrid engine is not a SYMOG-pool engine: ``kv_quant_bits`` is 0,
    int8_fp keeps KV_F int8 attention pools (no exponent leaves) scattered
    as the prefill wrote them, int4_fp falls back to float; pools and
    tokens equal JAX's."""
    jeng, teng = _engines("recurrentgemma-2b", kv=kv)
    assert teng.kv_quant_bits == jeng.kv_quant_bits == 0
    reqs = _requests(teng.cfg, lens=(11, 5, 14), budgets=(6, 7, 5))
    _, ts, js = _serve_both(jeng, teng, reqs, n_slots=2, block_size=BLOCK)
    pools = _pools(ts, js)
    assert not any(p.endswith("_scale") for p in pools)
    kv_dtype = torch.int8 if kv == "int8_fp" else torch.float32
    assert {t.dtype for p, (t, _) in pools.items() if p.endswith(("/k", "/v"))} == {kv_dtype}
    _check_pools(ts, js, exact_paged=kv == "int8_fp")


@pytest.mark.parametrize("kv", ["bf16", "int8_fp"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b", "olmoe-1b-7b",
                                  "deepseek-v3-671b"] + ARCHS)
def test_pool_specs_are_the_prefills_caches(arch, kv):
    """The pool layout (``ServeEngine.prefill_cache_specs``) has the shapes
    and dtypes of the caches ``prefill_lm`` really writes at the engine's
    bf16 compute dtype, and of JAX's ``eval_shape`` of its prefill: the
    admission ``copy_`` into a slot row would cast a drifted dtype
    silently."""
    cfg = dataclasses.replace(jconfigs.get_reduced(arch), kv_cache_dtype=kv)
    own = init_lm(0, cfg, device="cpu")
    eng = ServeEngine(cfg, own, max_len=MAX_LEN, device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 5)).astype(np.int32)
    _, caches = prefill_lm(own, {"tokens": torch.from_numpy(tok)}, cfg, max_len=MAX_LEN,
                           compute_dtype=torch.bfloat16)
    jshapes = jax.eval_shape(
        lambda p: j_prefill(p, {"tokens": jnp.asarray(tok)}, cfg, max_len=MAX_LEN,
                            compute_dtype=jnp.bfloat16)[1],
        jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(t.shape, jnp.float32), own))
    spec = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in flatten_with_paths(eng.prefill_cache_specs())}
    assert spec == {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
                    for p, t in flatten_with_paths(caches)}
    assert spec == {"/".join(str(k.key) for k in p): (tuple(v.shape), str(v.dtype))
                    for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}


@pytest.mark.slow
@pytest.mark.parametrize("kv", ["int8_fp", "int4_fp"])
def test_mamba2_kv_cache_dtype_is_inert(kv):
    """mamba2 has no attention: the KV flag changes no pool leaf."""
    jeng, teng = _engines("mamba2-2.7b", kv=kv)
    assert teng.kv_quant_bits == jeng.kv_quant_bits == 0
    reqs = _requests(teng.cfg, lens=(7, 12), budgets=(5, 6))
    _, ts, js = _serve_both(jeng, teng, reqs, n_slots=2, block_size=BLOCK)
    base = _engines("mamba2-2.7b")[1]
    sched = Scheduler(base, ServeConfig(n_slots=2, block_size=BLOCK))
    assert {p: (t.shape, t.dtype) for p, t in flatten_with_paths(ts.caches)} == \
        {p: (t.shape, t.dtype) for p, t in flatten_with_paths(sched.caches)}
    _check_pools(ts, js)


@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_slot_state_is_frozen(arch):
    """Request 0 finishes after 2 tokens; its slot stays empty (nothing
    queued) while request 1 decodes on: every resident leaf of that row is
    bit-identical across those steps."""
    _, teng = _engines(arch)
    reqs = _requests(teng.cfg, lens=(6, 9), budgets=(2, 9))
    sched = Scheduler(teng, ServeConfig(n_slots=2, block_size=BLOCK))
    for p, b in reqs:
        sched.submit(Request(tokens=p, max_new_tokens=b))
    frozen, steps = None, 0
    while sched.step():
        if sched._slots[0] is None and sched._slots[1] is not None:
            rows = {}
            for g in sched._groups:
                for j, paged in enumerate(g.paged):
                    for n, leaf in sched.caches[g.name][f"sub{j}"].items():
                        if not (paged and n in PAGED_CACHE_LEAVES):
                            rows[f"{g.name}/sub{j}/{n}"] = leaf.select(
                                1 if g.stacked else 0, 0).clone()
            if frozen is None:
                frozen = rows
            else:
                steps += 1
                for p, t in rows.items():
                    assert torch.equal(t, frozen[p]), p
    assert frozen and steps >= 4


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_features_are_inert_with_jax_capabilities(arch):
    jeng, teng = _engines(arch)
    want, got = jeng.capabilities(), teng.capabilities()
    assert sorted(got) == sorted(want)
    for name in want:
        assert (bool(got[name]), got[name].reason) == (bool(want[name]), want[name].reason), name
        assert not got[name]
    reqs = _requests(teng.cfg, lens=(8, 8, 5), budgets=(4, 4, 3))
    reqs[1] = (reqs[0][0], 4)  # a shared prompt: a hit on the tier
    base = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                      ServeConfig(n_slots=2, block_size=BLOCK))
    _, teng_draft = _engines(arch)
    for extra, stat in ((dict(prefix_cache=True), "prefix_hits"),
                        (dict(prefill_chunk=3), "chunked_admissions"),
                        (dict(speculative=SpeculativeConfig(draft=teng_draft.params, k=3)),
                         "spec_steps")):
        comps, sched = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                                  ServeConfig(n_slots=2, block_size=BLOCK, **extra),
                                  return_scheduler=True)
        assert [c.tokens for c in comps] == [c.tokens for c in base]
        assert sched.stats[stat] == 0
        assert sched.prefix is None and sched.chunk == 0
