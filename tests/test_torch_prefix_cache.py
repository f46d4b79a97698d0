"""Port parity, the prefix cache with copy-on-write (repro_torch vs the JAX
package), reduced configs, fp32 compute, on the CPU.  Params are the port's
seeded ``init_lm`` packed by JAX's jitted ``symog_init`` + ``pack_tree``
(and ``quantize_tree`` of the same state), as tests/test_torch_tail_prefill.py.

  - greedy serves with ``prefix_cache=True`` (block 4, prompts sharing 9 /
    12 / 14-token prefixes, so hits end mid-block and copy on write) are
    token-identical to JAX's jitted serve under the same config and to the
    port's own serve with the cache off; the hit, miss, hit-token, COW,
    eviction and ``prefill_only_steps`` counts equal JAX's; int8_fp /
    int4_fp pools and exponents are array_equal to JAX's outside the trash
    block (physical row 0), a float pool within 1e-4 (the bars of
    tests/test_prefix_cache.py: token identity to the cache-off oracle);
  - ``cow_copy`` copies every paged leaf and its exponents at every layer;
  - eviction of cached-free blocks runs before preemption, and a
    preempted restart hits its own blocks, both as in JAX;
  - fingerprints split ``quantize_tree`` from ``pack_tree`` artifacts;
  - olmoe (MoE) and deepseek (MLA) bypass: the cache and the chunking are
    inert, their counters 0, tokens equal to the plain serve's;
  - ``ServeConfig``'s refusals equal JAX's, and ``capabilities()`` agrees
    with JAX's on all five keys for every arch the port has."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpeculativeConfig as JSpec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.serve import BlockPool, PrefixCache, Request, Scheduler  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine, SpeculativeConfig  # noqa: E402

MAX_LEN, BLOCK = 32, 4
_TREES = {}
_ENG = {}
STATS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_cow_copies",
         "prefix_evicted_blocks", "prefill_only_steps", "prefills", "preemptions")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(arch):
    """(cfg, {kind: jax tree}, {kind: port tree}) of ``arch``'s reduced
    config; kinds 'packed' and 'quantize_tree' of one SYMOG state."""
    if arch not in _TREES:
        cfg = jconfigs.get_reduced(arch)
        own = init_lm(0, tconfigs.get_reduced(arch), device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        jf = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own)
        st = jax.jit(lambda p: jcore.symog_init(p, scfg))(jf)
        jt = {"packed": jax.jit(lambda p, s: jcore.pack_tree(p, s, scfg))(jf, st),
              "quantize_tree": jax.jit(lambda p, s: jcore.quantize_tree(p, s, scfg))(jf, st)}
        tt = {k: params_from_numpy(jax.tree_util.tree_map(np.asarray, v)) for k, v in jt.items()}
        _TREES[arch] = (cfg, jt, tt)
    return _TREES[arch]


def _engines(arch, kv="bf16", kind="packed"):
    """(port engine, JAX engine), cached per module."""
    key = (arch, kv, kind)
    if key not in _ENG:
        cfg, jt, tt = _trees(arch)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        _ENG[key] = (ServeEngine(cfg, tt[kind], max_len=MAX_LEN, compute_dtype=torch.float32,
                                 device="cpu"),
                     JEngine(cfg, jt[kind], max_len=MAX_LEN, compute_dtype=jnp.float32))
    return _ENG[key]


def _leaves(caches, prefix=()):
    if isinstance(caches, dict):
        for k in sorted(caches):
            yield from _leaves(caches[k], prefix + (k,))
    else:
        yield prefix, caches


def _shared_prefix_requests(vocab, seed=0):
    """Prompts over one 14-token base: a miss, then hits of 9 (2 blocks + 1
    row: COW), 11 (the identical prompt, capped at lp - 1: COW) and 12
    (block-aligned) tokens, and an unrelated miss."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=14).astype(np.int32)
    other = rng.integers(0, vocab, size=7).astype(np.int32)
    tail = (base[9:13] + 1) % vocab
    prompts = [base[:12], np.concatenate([base[:9], tail]), base[:12], base, other]
    return [(p.astype(np.int32), b) for p, b in zip(prompts, (5, 4, 6, 3, 4))]


def _serve_both(arch, kv, reqs, kind="packed", **sc):
    eng, jeng = _engines(arch, kv, kind)
    tc, ts = eng.serve([Request(tokens=p, max_new_tokens=b, arrival=a)
                        for p, b, a in reqs], ServeConfig(**sc), return_scheduler=True)
    jc, js = jeng.serve([JRequest(tokens=p, max_new_tokens=b, arrival=a)
                         for p, b, a in reqs], JServeConfig(**sc), return_scheduler=True)
    return (tc, ts), (jc, js)


def _assert_pools_equal(ts, js, kv):
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, js.caches)))
    tl = dict(_leaves(ts.caches))
    assert sorted(jl) == sorted(tl)
    for path, leaf in tl.items():
        a, b = leaf.numpy()[:, 1:], jl[path][:, 1:]  # the trash block aside
        if kv == "bf16":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=str(path))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("kv", ["bf16", "int8_fp", "int4_fp"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b"])
def test_prefix_cache_serve_matches_jax(arch, kv):
    eng, _ = _engines(arch, kv)
    reqs = [(p, b, 2 * i) for i, (p, b) in enumerate(_shared_prefix_requests(eng.cfg.vocab_size))]
    sc = dict(n_slots=2, block_size=BLOCK, prefix_cache=True)
    (tc, ts), (jc, js) = _serve_both(arch, kv, reqs, **sc)
    assert ts.prefix is not None and js.prefix is not None
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert {k: ts.stats[k] for k in STATS} == {k: js.stats[k] for k in STATS}
    assert ts.stats["prefix_hits"] == 3 and ts.stats["prefix_cow_copies"] == 2
    assert ts.stats["prefix_hit_tokens"] == 9 + 11 + 12
    assert ts.pool.total_allocs == js.pool.total_allocs
    _assert_pools_equal(ts, js, kv)
    off = eng.serve([Request(tokens=p, max_new_tokens=b, arrival=a) for p, b, a in reqs],
                    ServeConfig(n_slots=2, block_size=BLOCK))
    assert [c.tokens for c in tc] == [c.tokens for c in off]
    ts.pool.check()


@pytest.mark.parametrize("kv", ["bf16", "int4_fp"])
def test_cow_copy_clones_every_layer_and_exponent(kv):
    eng, _ = _engines("gemma3-4b", kv)
    sched = Scheduler(eng, ServeConfig(n_slots=1, block_size=BLOCK))
    gen = torch.Generator().manual_seed(0)
    for _, leaf in _leaves(sched.caches):
        leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=gen).to(leaf.dtype))
    before = {p: leaf.clone() for p, leaf in _leaves(sched.caches)}
    fns = eng.scheduler_fns(greedy=True, top_k=0)
    fns.cow_copy(sched.caches, 3, 5)
    groups = {g.name: g for g in fns._groups}
    names = set()
    for path, leaf in _leaves(sched.caches):
        names.add(path[-1])
        want = before[path].clone()
        axis = 1 if groups[path[0]].stacked else 0  # a stacked group: rows on axis 1
        want.select(axis, 5).copy_(want.select(axis, 3))
        assert torch.equal(leaf, want), path
    assert names == ({"k", "v"} if kv == "bf16" else {"k", "v", "k_scale", "v_scale"})
    with pytest.raises(ValueError):
        fns.cow_copy(sched.caches, 3, 0)


def test_eviction_runs_before_preemption():
    """One slot, a pool of 6 blocks of 4, five distinct 8-token prompts:
    every admission needs most of the pool, so parked blocks of finished
    requests are LRU-evicted inside alloc and nothing is preempted."""
    eng, _ = _engines("internlm2-1.8b")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, eng.cfg.vocab_size, size=8).astype(np.int32), 6, 0)
            for _ in range(5)]
    sc = dict(n_slots=1, block_size=BLOCK, n_blocks=8, prefix_cache=True)
    (tc, ts), (jc, js) = _serve_both("internlm2-1.8b", "bf16", reqs, **sc)
    assert ts.stats["prefix_evicted_blocks"] > 0 and ts.stats["preemptions"] == 0
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert {k: ts.stats[k] for k in STATS} == {k: js.stats[k] for k in STATS}
    ts.pool.check()


def test_preempted_restart_hits_its_own_blocks():
    eng, _ = _engines("internlm2-1.8b")
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, eng.cfg.vocab_size, size=8).astype(np.int32), 16, 0)
            for _ in range(2)]
    sc = dict(n_slots=2, block_size=BLOCK, n_blocks=8, prefix_cache=True)
    (tc, ts), (jc, js) = _serve_both("internlm2-1.8b", "bf16", reqs, **sc)
    assert ts.stats["preemptions"] >= 1 and ts.stats["prefix_hits"] >= 1
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert {k: ts.stats[k] for k in STATS} == {k: js.stats[k] for k in STATS}
    off = eng.serve([Request(tokens=p, max_new_tokens=b) for p, b, _ in reqs],
                    ServeConfig(n_slots=2, block_size=BLOCK))
    assert [c.tokens for c in tc] == [c.tokens for c in off]
    ts.pool.check()


def test_admission_times_record_hits():
    eng, _ = _engines("internlm2-1.8b")
    prompt = np.random.default_rng(5).integers(0, eng.cfg.vocab_size, size=8).astype(np.int32)
    _, sched = eng.serve([Request(tokens=prompt, max_new_tokens=3) for _ in range(3)],
                         ServeConfig(n_slots=3, block_size=BLOCK, prefix_cache=True,
                                     time_admissions=True), return_scheduler=True)
    assert [t[2] for t in sched.admit_times] == [0, 7, 7]
    assert all(dt > 0 for _, dt, _ in sched.admit_times)


def test_fingerprints_split_artifacts():
    e_p, _ = _engines("internlm2-1.8b", kind="packed")
    e_q, _ = _engines("internlm2-1.8b", kind="quantize_tree")
    assert e_p.params_fingerprint() != e_q.params_fingerprint()
    assert e_q.params_fingerprint() == e_q.params_fingerprint()
    cache = PrefixCache(BlockPool(4, 4), 4, e_q.params_fingerprint())
    with pytest.raises(ValueError):
        cache.match([1, 2, 3, 4], e_p.params_fingerprint())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_and_mla_bypass(arch):
    eng, _ = _engines(arch)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, eng.cfg.vocab_size, size=9).astype(np.int32)
    reqs = [Request(tokens=prompt, max_new_tokens=3) for _ in range(2)]
    comps, sched = eng.serve(reqs, ServeConfig(n_slots=2, block_size=BLOCK, prefix_cache=True,
                                               prefill_chunk=3), return_scheduler=True)
    assert sched.prefix is None and sched.chunk == 0
    for k in ("prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_cow_copies",
              "prefill_chunks", "chunked_admissions", "prefill_only_steps"):
        assert sched.stats[k] == 0, k
    plain = eng.serve(reqs, ServeConfig(n_slots=2, block_size=BLOCK))
    assert [c.tokens for c in comps] == [c.tokens for c in plain]


def _refusal(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True, spec=True), dict(prefill_chunk=4, spec=True), dict(prefill_chunk=-1),
    dict(prefill_chunk=0, spec=True), dict(prefix_cache=True, prefill_chunk=8, time_admissions=True),
])
def test_serve_config_refusals_match_jax(kw):
    kw = dict(kw)
    spec = kw.pop("spec", False)
    got = _refusal(lambda: ServeConfig(**kw, speculative=SpeculativeConfig(draft=None)
                                       if spec else None))
    want = _refusal(lambda: JServeConfig(**kw, speculative=JSpec(draft=None) if spec else None))
    assert (got is None) == (want is None)
    if got is not None:  # the JAX text adds a pointer to its design notes
        assert got.split(" (")[0] == want.split(" (")[0]


def test_capabilities_match_jax_on_every_key():
    for arch in tconfigs.ARCHS:
        cfg = dataclasses.replace(jconfigs.get_reduced(arch), kv_cache_dtype="int4_fp")
        own = init_lm(0, tconfigs.get_reduced(arch), device="cpu")
        jeng = JEngine(cfg, jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own),
                       max_len=16, compute_dtype=jnp.float32)
        teng = ServeEngine(cfg, own, max_len=16, compute_dtype=torch.float32, device="cpu")
        want, got = jeng.capabilities(), teng.capabilities()
        assert sorted(got) == sorted(want)
        for name in want:
            assert bool(got[name]) == bool(want[name]), (arch, name)
            assert bool(got[name].reason) == (not want[name]), (arch, name)
            assert "not ported" not in got[name].reason
