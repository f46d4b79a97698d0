"""Port parity, serving the encoder-decoder and VLM families (repro_torch vs
the JAX package): reduced whisper-large-v3 and paligemma-3b on the CPU,
fp32, ``MAX_LEN`` 32 (+ the image prefix), block 4, the port's seeded
``init_lm`` packed by JAX's jitted ``symog_init`` + ``pack_tree`` (or
``quantize_tree``); JAX's serves jitted.  Every request carries its own
seeded frames (whisper) or patches (paligemma) in ``Request.extras``.

  - greedy ``serve()`` token-identical to JAX's serve and to the port's
    static loop (``generate_static``), under a pool small enough to preempt
    and with an EOS eviction, from bf16 / int8_fp / int4_fp pools (the
    non-decoder rule: ``kv_quant_bits`` 0, KV_F int8 pools under int8_fp,
    float under int4_fp), for packed and ``quantize_tree`` params; the
    pools after the serve equal JAX's (paged self-attention k/v with the
    image prefix in every row's first blocks; whisper's cross-kv resident
    a slot, bf16, and counted in ``serve_pool_bytes`` as JAX counts it);
  - ``capabilities()`` equals JAX's on all five keys, reasons included; the
    prefix cache, chunked prefill and speculation are accepted and
    bypassed, with JAX's stats;
  - an async serve with extras streams the sync serve's tokens;
  - a whisper checkpoint in JAX's format, both ways: the files byte-equal,
    each package restoring the other's tree ``array_equal``.
"""
import asyncio
import dataclasses
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpeculativeConfig as JSpec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.packing import Packed  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.models.lm import PAGED_CACHE_LEAVES  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine, SpeculativeConfig  # noqa: E402

ARCHS = ["whisper-large-v3", "paligemma-3b"]
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


def _max_len(cfg):
    return MAX_LEN + (cfg.prefix_len if cfg.family == "vlm" else 0)


def _engines(arch, kv="bf16", tree="pack_tree"):
    cfg = dataclasses.replace(jconfigs.get_reduced(arch), kv_cache_dtype=kv)
    jp, tp = _trees(arch, tree)
    return (JEngine(cfg, jp, max_len=_max_len(cfg), compute_dtype=jnp.float32),
            ServeEngine(cfg, tp, max_len=_max_len(cfg), compute_dtype=torch.float32,
                        device="cpu"))


def _extras(cfg, rng):
    name, n = ("frames", cfg.encoder_len) if cfg.family == "encdec" else ("patches", cfg.prefix_len)
    return {name: (rng.standard_normal((1, n, cfg.d_model)) * 0.1).astype(np.float32)}


def _requests(cfg, lens=(14, 13, 11, 5, 9), budgets=(10, 12, 7, 9, 5), seed=1):
    """(prompt, budget, extras) per request: each its own frames / patches."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, size=L).astype(np.int32), b, _extras(cfg, rng))
            for L, b in zip(lens, budgets)]


def _preempting(cfg):
    """Requests whose growth overruns a pool of one max_len request's blocks
    shared by two slots (paligemma's prefix takes 2 of a row's blocks:
    shorter prompts, longer budgets)."""
    if cfg.family == "vlm":
        return _requests(cfg, lens=(6, 5, 7, 3, 4), budgets=(14, 16, 10, 9, 8))
    return _requests(cfg)


def _make(ns, reqs, eos):
    return [ns(tokens=p, max_new_tokens=b, eos_id=eos.get(i, -1), extras=e)
            for i, (p, b, e) in enumerate(reqs)]


def _serve_both(jeng, teng, reqs, eos=None, jextra=None, textra=None, **sc):
    eos = eos or {}
    jc, js = jeng.serve(_make(JRequest, reqs, eos), JServeConfig(**sc, **(jextra or {})),
                        return_scheduler=True)
    tc, ts = teng.serve(_make(Request, reqs, eos), ServeConfig(**sc, **(textra or {})),
                        return_scheduler=True)
    assert [c.tokens for c in tc] == [list(map(int, c.tokens)) for c in jc]
    assert [c.finish_reason for c in tc] == [c.finish_reason for c in jc]
    return tc, ts, js


def _check_pools(ts, js, exact_paged=False):
    """The two schedulers' pools leaf by leaf: paged leaves past the trash
    block (physical row 0, written in an order neither package defines),
    exact under int8 words; bf16 cross-kv rows within a bf16 ulp (their
    fp32 sources agree within 1e-6); float leaves within TOL."""
    got = dict(flatten_with_paths(ts.caches))
    want = {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(js.caches)[0]}
    assert set(got) == set(want)
    for path, t in got.items():
        j = want[path]
        assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == (j.shape, str(j.dtype)), path
        a, b = t.float().numpy(), np.asarray(j, np.float32)
        if path.rsplit("/", 1)[-1] in PAGED_CACHE_LEAVES:
            a, b = a[:, 1:], b[:, 1:]  # every group here is stacked
            if exact_paged:
                np.testing.assert_array_equal(a, b, err_msg=path)
                continue
        if t.dtype == torch.bfloat16:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), np.abs(b)) + 1e-30)) - 7)
            assert (np.abs(a - b) <= ulp).all() and (a != b).mean() < 0.01, path
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=path)


def _eos_for(teng, reqs, i=0, at=2):
    """An eos id that request ``i`` emits at its ``at``-th step."""
    p, b, e = reqs[i]
    return int(teng.generate_static({"tokens": p[None], **e}, b)[0, at])


@pytest.mark.parametrize("kv", ["bf16", "int8_fp", "int4_fp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serve_matches_jax_and_static(arch, kv):
    """A pool of one max_len request's blocks for two slots preempts;
    request 3 stops at an EOS; the pools after the serve equal JAX's."""
    jeng, teng = _engines(arch, kv=kv)
    assert teng.kv_quant_bits == jeng.kv_quant_bits == 0
    reqs = _preempting(teng.cfg)
    eos = {3: _eos_for(teng, reqs, i=3)}
    n_blocks = _max_len(teng.cfg) // BLOCK
    tc, ts, js = _serve_both(jeng, teng, reqs, eos, n_slots=2, block_size=BLOCK,
                             n_blocks=n_blocks)
    assert ts.stats["preemptions"] == js.stats["preemptions"] > 0
    assert tc[3].finish_reason == "eos"
    for (p, b, e), c in zip(reqs, tc):
        static = teng.generate_static({"tokens": p[None], **e}, b)[0].numpy()
        np.testing.assert_array_equal(np.asarray(c.tokens), static[: len(c.tokens)])
    pools = dict(flatten_with_paths(ts.caches))
    assert not any(p.endswith("_scale") for p in pools)
    want = {"int8_fp": torch.int8}.get(kv, torch.float32)
    assert {t.dtype for p, t in pools.items() if p.endswith(("/k", "/v"))} == {want}
    if teng.cfg.family == "encdec":  # resident a slot, bf16 whatever the pool
        cross = {p: t for p, t in pools.items() if "cross" in p}
        assert {t.dtype for t in cross.values()} == {torch.bfloat16}
        assert {tuple(t.shape) for t in cross.values()} == {
            (teng.cfg.n_layers, 2, teng.cfg.encoder_len, teng.cfg.n_kv_heads, teng.cfg.head_dim)}
        assert ts.paged_pool_bytes() == ts.cache_bytes() - sum(
            t.numel() * t.element_size() for t in cross.values())
    assert ts.registry.snapshot()["serve_pool_bytes"] == js.registry.snapshot()["serve_pool_bytes"]
    _check_pools(ts, js, exact_paged=kv == "int8_fp")


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_serve_matches_jax_and_packed(arch):
    """``quantize_tree`` params serve the packed params' tokens, and JAX's,
    under the preempting pool."""
    jeng, teng = _engines(arch, tree="quantize_tree")
    reqs = _preempting(teng.cfg)
    sc = dict(n_slots=2, block_size=BLOCK, n_blocks=_max_len(teng.cfg) // BLOCK)
    tc, ts, js = _serve_both(jeng, teng, reqs, **sc)
    assert ts.stats["preemptions"] > 0
    packed = _engines(arch)[1].serve(_make(Request, reqs, {}), ServeConfig(**sc))
    assert [c.tokens for c in tc] == [c.tokens for c in packed]
    _check_pools(ts, js)


@pytest.mark.parametrize("arch", ARCHS)
def test_capabilities_and_bypassed_features_match_jax(arch):
    """``capabilities()`` equals JAX's, reasons included, and nothing is
    supported; the prefix cache (a shared prompt: a hit on the tier),
    chunks of 3 and speculation are accepted and bypassed, each serve's
    tokens and stats equal to JAX's and to the plain serve's."""
    jeng, teng = _engines(arch, kv="int8_fp")
    want, got = jeng.capabilities(), teng.capabilities()
    assert sorted(got) == sorted(want)
    for name in want:
        assert (bool(got[name]), got[name].reason) == (bool(want[name]), want[name].reason), name
        assert not got[name]
    reqs = _requests(teng.cfg, lens=(8, 8, 5), budgets=(4, 4, 3))
    reqs[1] = (reqs[0][0], 4, reqs[1][2])
    sc = dict(n_slots=2, block_size=BLOCK)
    base, _, _ = _serve_both(jeng, teng, reqs, **sc)
    _, jdraft = _engines(arch, kv="int8_fp")
    keys = ("prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_cow_copies",
            "chunked_admissions", "prefill_chunks", "prefills", "admissions", "decode_steps")
    for jx, tx, stat in (
            (dict(prefix_cache=True), dict(prefix_cache=True), "prefix_hits"),
            (dict(prefill_chunk=3), dict(prefill_chunk=3), "chunked_admissions"),
            (dict(speculative=JSpec(draft=jdraft.params, k=3)),
             dict(speculative=SpeculativeConfig(draft=teng.params, k=3)), "spec_steps")):
        comps, ts, js = _serve_both(jeng, teng, reqs, jextra=jx, textra=tx, **sc)
        assert [c.tokens for c in comps] == [c.tokens for c in base]
        assert ts.stats[stat] == js.stats[stat] == 0
        assert {k: ts.stats[k] for k in keys} == {k: js.stats[k] for k in keys}
        assert ts.prefix is None and ts.chunk == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_async_serve_with_extras_equals_sync(arch):
    _, teng = _engines(arch)
    reqs = _make(Request, _requests(teng.cfg, lens=(6, 9, 4), budgets=(5, 3, 6)), {})
    sync = [c.tokens for c in teng.serve(reqs, ServeConfig(n_slots=2, block_size=BLOCK))]

    async def main():
        async with teng.serve_async(ServeConfig(n_slots=2, block_size=BLOCK)) as srv:
            ids = [srv.submit(r) for r in reqs]
            streams = await asyncio.gather(*[_collect(srv.tokens(i)) for i in ids])
            comps = await srv.drain()
        return streams, comps

    async def _collect(agen):
        return [t async for t in agen]

    streams, comps = asyncio.run(main())
    assert streams == sync and [c.tokens for c in comps] == sync


def test_whisper_checkpoint_round_trip(tmp_path):
    """The packed whisper tree (encoder groups, rank-2 biases, Packed
    leaves) in JAX's format: both packages write the same files; each
    restores the other's tree ``array_equal``, and the restored tree serves
    the original's tokens."""
    jtree, ttree = _trees("whisper-large-v3")
    jm, tm = JManager(str(tmp_path / "jax")), CheckpointManager(str(tmp_path / "port"))
    jm.save(2, jtree, blocking=True)
    tm.save(2, ttree, blocking=True)
    jd, td = jm.path(2), tm.path(2)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    assert "encoder__layers0__sub0__attn__q_proj__bias.npy" in os.listdir(td)
    for name in os.listdir(jd):
        assert filecmp.cmp(os.path.join(jd, name), os.path.join(td, name), shallow=False), name
    back, _, step = CheckpointManager(str(tmp_path / "jax")).restore(ttree)
    assert step == 2
    fa, fb = flatten_with_paths(back), flatten_with_paths(ttree)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, a), (_, b) in zip(fa, fb):
        if isinstance(b, Packed):
            assert isinstance(a, Packed) and a.n_bits == b.n_bits, p
            assert torch.equal(a.data, b.data) and torch.equal(a.f, b.f), p
        else:
            assert torch.equal(a, b), p
    jback, _, _ = JManager(str(tmp_path / "port")).restore(jax.eval_shape(lambda: jtree))
    for a, b in zip(jax.tree_util.tree_leaves(jback), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cfg = jconfigs.get_reduced("whisper-large-v3")
    reqs = _make(Request, _requests(cfg, lens=(5, 7), budgets=(4, 4)), {})
    sc = ServeConfig(n_slots=2, block_size=BLOCK)
    got = ServeEngine(cfg, back, max_len=MAX_LEN, compute_dtype=torch.float32,
                      device="cpu").serve(reqs, sc)
    assert [c.tokens for c in got] == [c.tokens for c in _engines("whisper-large-v3")[1].serve(reqs, sc)]
