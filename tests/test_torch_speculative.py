"""Port parity, self-speculative decoding (repro_torch vs the JAX package),
reduced configs, fp32 compute, on the CPU.  Params are the port's seeded
``init_lm``; its SYMOG state comes from JAX's jitted ``symog_init``, and the
2-bit ``pack_tree`` draft and the ``quantize_tree`` target from JAX's jitted
functions of that state, as tests/test_torch_tail_prefill.py.

Greedy (the bars of tests/test_speculative.py):
  - an exact twin (``quantize_tree`` target, ``pack_tree`` draft of the same
    values) and a disagreeing draft (the float target) serve token-identical
    to the port's ``generate_static`` and to JAX's speculative serve, with
    the ``spec_*`` stats equal to JAX's; from an int4_fp pool too, with the
    target's and the draft's pools and exponents array_equal to JAX's
    outside the trash block;
  - an EOS inside the window truncates exactly; budgets are kept to the
    token; preemption under pool pressure replays exactly;
  - ``decode_verify_lm`` equals k + 1 sequential ``decode_lm`` steps
    (gemma2, its windows binding) within 1e-5, logits and pool, and JAX's
    ``decode_verify_lm`` at 1e-4; ``mla_verify_paged`` equals sequential
    ``mla_decode`` and JAX's ``mla_verify_paged``, from a float and an int4
    pool.
Sampled (the port's splitmix64 draws, not ``jax.random``'s): streams are
identical across reruns, slot counts, arrivals and at the cache boundary;
the accept / residual rule alone, over 20,000 stream ids, commits tokens
distributed as p within 4 sigma, and accepts every draft when p == q.
MoE (olmoe) and MLA + MoE (deepseek) engines bypass: 0 rounds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.lm import decode_verify_lm as j_decode_verify  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SpeculativeConfig as JSpec  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import decode_lm, decode_verify_lm, init_lm  # noqa: E402
from repro_torch.serve import Request, Scheduler, ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve import SpeculativeConfig, latency_stats, sample_tokens  # noqa: E402
from repro_torch.serve.speculative import accept_sampled, speculative_eligible  # noqa: E402

MAX_LEN, BLOCK = 32, 4
_TREES = {}
_ENG = {}
SPEC_STATS = ("spec_steps", "spec_row_rounds", "spec_drafted", "spec_accepted", "spec_emitted",
              "decode_steps", "preemptions", "tokens_emitted")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(arch):
    """(cfg, {kind: jax tree}, {kind: port tree}): 'float', 'quantize_tree'
    and 'packed' of one SYMOG state."""
    if arch not in _TREES:
        cfg = jconfigs.get_reduced(arch)
        own = init_lm(0, tconfigs.get_reduced(arch), device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        jf = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own)
        st = jax.jit(lambda p: jcore.symog_init(p, scfg))(jf)
        jt = {"float": jf,
              "packed": jax.jit(lambda p, s: jcore.pack_tree(p, s, scfg))(jf, st),
              "quantize_tree": jax.jit(lambda p, s: jcore.quantize_tree(p, s, scfg))(jf, st)}
        tt = {k: params_from_numpy(jax.tree_util.tree_map(np.asarray, v)) for k, v in jt.items()}
        _TREES[arch] = (cfg, jt, tt)
    return _TREES[arch]


def _engines(arch, kind, kv="bf16"):
    """(port engine, JAX engine) of the target ``kind``, cached per module."""
    key = (arch, kind, kv)
    if key not in _ENG:
        cfg, jt, tt = _trees(arch)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        _ENG[key] = (ServeEngine(cfg, tt[kind], max_len=MAX_LEN, compute_dtype=torch.float32,
                                 device="cpu"),
                     JEngine(cfg, jt[kind], max_len=MAX_LEN, compute_dtype=jnp.float32))
    return _ENG[key]


def _requests(vocab, seed=0, lens=(3, 6, 4, 5), budgets=(9, 3, 6, 12), arrivals=None):
    rng = np.random.default_rng(seed)
    arrivals = arrivals or (0,) * len(lens)
    return [(rng.integers(0, vocab, size=L).astype(np.int32), b, a)
            for L, b, a in zip(lens, budgets, arrivals)]


def _port_reqs(reqs, **kw):
    return [Request(tokens=p, max_new_tokens=b, arrival=a, **kw) for p, b, a in reqs]


def _static(eng, prompt, steps):
    return eng.generate_static({"tokens": torch.from_numpy(prompt[None])}, steps)[0].tolist()


def _leaves(caches, prefix=()):
    if isinstance(caches, dict):
        for k in sorted(caches):
            yield from _leaves(caches[k], prefix + (k,))
    else:
        yield prefix, caches


def _assert_pools_equal(tc, jc, exact):
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jc)))
    for path, leaf in _leaves(tc):
        a, b = leaf.numpy()[:, 1:], jl[path][:, 1:]  # the trash block aside
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=str(path))


def _spec_serve_both(arch, target, reqs, kv="bf16", k=3, **sc):
    eng, jeng = _engines(arch, target, kv)
    _, jt, tt = _trees(arch)
    tcomps, ts = eng.serve(_port_reqs(reqs), ServeConfig(
        speculative=SpeculativeConfig(draft=tt["packed"], k=k), **sc), return_scheduler=True)
    jcomps, js = jeng.serve([JRequest(tokens=p, max_new_tokens=b, arrival=a) for p, b, a in reqs],
                            JServeConfig(speculative=JSpec(draft=jt["packed"], k=k), **sc),
                            return_scheduler=True)
    return (tcomps, ts), (jcomps, js)


@pytest.mark.parametrize("target", ["quantize_tree", "float"])
def test_greedy_spec_matches_static_and_jax(target):
    """quantize_tree target: the packed draft is an exact twin (every draft
    accepted); float target: the draft disagrees (rejections roll back)."""
    eng, _ = _engines("internlm2-1.8b", target)
    reqs = _requests(eng.cfg.vocab_size)
    (tc, ts), (jc, js) = _spec_serve_both("internlm2-1.8b", target, reqs, n_slots=2)
    for (p, b, _), c in zip(reqs, tc):
        assert c.tokens == _static(eng, p, b)
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert {k: ts.stats[k] for k in SPEC_STATS} == {k: js.stats[k] for k in SPEC_STATS}
    assert [(c.spec_steps, c.spec_tokens) for c in tc] == [(c.spec_steps, c.spec_tokens)
                                                           for c in jc]
    s = ts.stats
    assert s["spec_steps"] > 0
    if target == "quantize_tree":
        assert s["spec_emitted"] / s["spec_row_rounds"] > 1.5
    else:
        assert s["spec_accepted"] < s["spec_drafted"]
    assert sum(c.spec_tokens for c in tc) == s["spec_emitted"]
    assert s["spec_emitted"] == s["tokens_emitted"] - len(reqs)
    assert latency_stats(tc)["accepted_per_step"]["mean"] >= 1.0


@pytest.mark.parametrize("kv", ["int8_fp", "int4_fp"])
def test_spec_serve_from_quantized_pool_matches_jax(kv):
    """Rejected drafts write (and may open) blocks of a quantized pool, as in
    JAX: both pools, words and exponents, equal JAX's after the serve."""
    eng, _ = _engines("gemma3-4b", "float", kv)
    reqs = _requests(eng.cfg.vocab_size, seed=1)
    (tc, ts), (jc, js) = _spec_serve_both("gemma3-4b", "float", reqs, kv=kv, n_slots=2,
                                          block_size=BLOCK)
    assert ts.stats["spec_steps"] > 0 and ts.stats["spec_accepted"] < ts.stats["spec_drafted"]
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert {k: ts.stats[k] for k in SPEC_STATS} == {k: js.stats[k] for k in SPEC_STATS}
    _assert_pools_equal(ts.caches, js.caches, exact=True)
    _assert_pools_equal(ts.draft_caches, js.draft_caches, exact=True)


@pytest.mark.slow
@pytest.mark.parametrize("target", ["quantize_tree", "float"])
@pytest.mark.parametrize("arch", ["gemma2-27b", "gemma3-4b", "granite-34b"])
def test_spec_serve_matches_jax_all_eligible_archs(arch, target):
    eng, _ = _engines(arch, target)
    reqs = _requests(eng.cfg.vocab_size, seed=2, lens=(3, 11), budgets=(12, 9))
    (tc, ts), (jc, js) = _spec_serve_both(arch, target, reqs, n_slots=2, block_size=BLOCK)
    assert speculative_eligible(eng) and ts.stats["spec_steps"] > 0
    for (p, b, _), c in zip(reqs, tc):
        assert c.tokens == _static(eng, p, b)
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert {k: ts.stats[k] for k in SPEC_STATS} == {k: js.stats[k] for k in SPEC_STATS}


def test_eos_inside_window_truncates_exactly():
    eng, _ = _engines("internlm2-1.8b", "quantize_tree")
    prompt = _requests(eng.cfg.vocab_size)[0][0]
    ref = _static(eng, prompt, 10)
    eos = ref[3]
    comps = eng.serve([Request(tokens=prompt, max_new_tokens=10, eos_id=eos)], ServeConfig(
        speculative=SpeculativeConfig(draft=_trees("internlm2-1.8b")[2]["packed"], k=4)))
    assert comps[0].tokens == ref[: ref.index(eos) + 1] and comps[0].finish_reason == "eos"


def test_budget_kept_to_the_token():
    eng, _ = _engines("internlm2-1.8b", "quantize_tree")
    reqs = _requests(eng.cfg.vocab_size, lens=(3, 4), budgets=(2, 5))
    comps = eng.serve(_port_reqs(reqs), ServeConfig(n_slots=2, speculative=SpeculativeConfig(
        draft=_trees("internlm2-1.8b")[2]["packed"], k=4)))
    for (p, b, _), c in zip(reqs, comps):
        assert len(c.tokens) == b and c.finish_reason == "length"
        assert c.tokens == _static(eng, p, b)


def test_preemption_under_pool_pressure():
    eng, _ = _engines("internlm2-1.8b", "quantize_tree")
    reqs = _requests(eng.cfg.vocab_size, lens=(3, 5, 4), budgets=(14, 12, 8))
    sc = dict(n_slots=2, block_size=BLOCK, n_blocks=MAX_LEN // BLOCK)
    (tc, ts), (jc, js) = _spec_serve_both("internlm2-1.8b", "quantize_tree", reqs, **sc)
    assert ts.stats["preemptions"] > 0
    for (p, b, _), c in zip(reqs, tc):
        assert c.tokens == _static(eng, p, b)
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert {k: ts.stats[k] for k in SPEC_STATS} == {k: js.stats[k] for k in SPEC_STATS}


def test_adaptive_depth_backs_off_and_verifies_are_memoized():
    eng, _ = _engines("internlm2-1.8b", "float")
    draft = _trees("internlm2-1.8b")[2]["packed"]
    reqs = _port_reqs(_requests(eng.cfg.vocab_size, lens=(4, 5), budgets=(10, 10)))
    _, adaptive = eng.serve(reqs, ServeConfig(n_slots=2, speculative=SpeculativeConfig(
        draft=draft, k=4)), return_scheduler=True)
    _, fixed = eng.serve(reqs, ServeConfig(n_slots=2, speculative=SpeculativeConfig(
        draft=draft, k=4, adaptive=False)), return_scheduler=True)
    assert adaptive.stats["spec_drafted"] < fixed.stats["spec_drafted"]
    assert fixed.stats["spec_drafted"] == 4 * fixed.stats["spec_row_rounds"]
    fns = eng.speculative_fns(greedy=True, top_k=0)
    n = fns.verify_compiles
    assert n <= 4
    eng.serve(reqs, ServeConfig(n_slots=2, speculative=SpeculativeConfig(draft=draft, k=4)))
    assert fns.verify_compiles == n


# ---------------------------------------------------------------------------
# sampled speculation: determinism and the rejection rule
# ---------------------------------------------------------------------------
SAMPLING = dict(temperature=0.8, top_k=5, seed=11)


def test_sampled_spec_deterministic_across_composition():
    eng, _ = _engines("internlm2-1.8b", "float")
    draft = _trees("internlm2-1.8b")[2]["packed"]
    reqs = _requests(eng.cfg.vocab_size)
    spec = SpeculativeConfig(draft=draft, k=3)  # adaptive is ignored when sampling

    def streams(rs, n):
        return [c.tokens for c in eng.serve(rs, ServeConfig(n_slots=n, speculative=spec,
                                                            **SAMPLING))]

    base = streams(_port_reqs(reqs), 2)
    assert base == streams(_port_reqs(reqs), 2)
    assert base == streams(_port_reqs(reqs), 1)
    assert base == streams(_port_reqs(reqs), 4)
    assert base == streams([Request(tokens=p, max_new_tokens=b, arrival=3 * i)
                            for i, (p, b, _) in enumerate(reqs)], 2)
    greedy = [c.tokens for c in eng.serve(_port_reqs(reqs), ServeConfig(n_slots=2,
                                                                        speculative=spec))]
    assert base != greedy


def test_sampled_spec_at_the_cache_boundary():
    """A budget clamped to the cache end: the last rounds' positions run
    past max_len (valid masked); the stream fills the budget and stays
    deterministic across slot counts."""
    eng, _ = _engines("internlm2-1.8b", "float")
    spec = SpeculativeConfig(draft=_trees("internlm2-1.8b")[2]["packed"], k=4)
    prompt = np.random.default_rng(9).integers(0, eng.cfg.vocab_size, size=8).astype(np.int32)
    kw = dict(temperature=0.9, top_k=0, seed=3)
    one = eng.serve([Request(tokens=prompt, max_new_tokens=99)],
                    ServeConfig(n_slots=1, speculative=spec, **kw))
    assert len(one[0].tokens) == MAX_LEN - 8 + 1
    three = eng.serve([Request(tokens=prompt, max_new_tokens=99)],
                      ServeConfig(n_slots=3, speculative=spec, **kw))
    assert one[0].tokens == three[0].tokens


@pytest.mark.parametrize("case", ["p_ne_q", "p_eq_q", "masked"])
def test_accept_residual_rule_commits_the_target_distribution(case):
    """One verified position (k = 1) over 20,000 stream ids: drafts drawn
    from q, then the rule.  The committed token must follow p within 4
    sigma per class; with p == q every draft is accepted; with the test
    masked (the cache boundary) no draft is and the draw is p itself."""
    N, V = 20_000, 12
    rng = np.random.default_rng(0)
    lp = torch.from_numpy(rng.standard_normal(V).astype(np.float32) * 1.5)
    lq = lp.clone() if case == "p_eq_q" else torch.from_numpy(
        rng.standard_normal(V).astype(np.float32) * 1.5)
    temperature, top_k = 0.9, 0
    p = torch.softmax(lp / temperature, dim=-1)
    q = torch.softmax(lq / temperature, dim=-1)
    streams = torch.arange(N, dtype=torch.int64) * 7 + 1
    d = sample_tokens(lq.expand(N, V), streams, 1234, temperature, top_k)
    logits = torch.stack([lp, lp])[None].expand(N, 2, V)
    valid = torch.ones((N, 2), dtype=torch.bool)
    if case == "masked":
        valid[:, 1] = False
    out, m = accept_sampled(logits, d[:, None], q.expand(N, 1, V)[:, :], valid, streams, 55,
                            temperature, top_k)
    if case == "p_eq_q":
        assert bool((m == 1).all())
    if case == "masked":
        assert bool((m == 0).all())
    counts = torch.bincount(out[:, 0].to(torch.int64), minlength=V).double()
    want = p.double() * N
    sigma = torch.sqrt(N * p.double() * (1 - p.double()))
    assert bool((torch.abs(counts - want) <= 4 * sigma + 1).all()), (counts, want)


# ---------------------------------------------------------------------------
# the verify primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["bf16", "int4_fp"])
def test_decode_verify_lm_matches_sequential_decode_and_jax(kv):
    """gemma2 (windows of 8 binding past 8 tokens): rows at positions 9 and
    12, T = 4, through one verify and through 4 decode steps."""
    eng, jeng = _engines("gemma2-27b", "quantize_tree", kv)
    cfg, jp = eng.cfg, _trees("gemma2-27b")[1]["quantize_tree"]
    sched = Scheduler(eng, ServeConfig(n_slots=2, block_size=BLOCK))
    for p, b, _ in _requests(cfg.vocab_size, seed=3, lens=(9, 12), budgets=(8, 8)):
        sched.submit(Request(tokens=p, max_new_tokens=b))
    sched._grow_tables(horizon=4)
    sched._admit()
    sched._grow_tables(horizon=4)
    bt, active = sched._block_tables.clone(), torch.ones(2, dtype=torch.bool)
    pos0, T = sched._pos.clone(), 4
    base = {p: leaf.clone() for p, leaf in _leaves(sched.caches)}

    def fresh():
        out = {}
        for path, leaf in base.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf.clone()
        return out

    c_seq, cur, fed, seq_logits = fresh(), sched._tokens.clone(), [], []
    p_cur = pos0.clone()
    for _ in range(T):
        fed.append(cur)
        lg, c_seq = decode_lm(eng.params, c_seq, cur[:, None], p_cur, cfg,
                              compute_dtype=torch.float32, active=active, block_tables=bt)
        seq_logits.append(lg[:, -1])
        cur = torch.argmax(lg[:, -1], -1).to(torch.int32)
        p_cur = p_cur + 1
    tokens = torch.stack(fed, dim=1)
    c_ver = fresh()
    v_logits, c_ver = decode_verify_lm(eng.params, c_ver, tokens, pos0, cfg,
                                       compute_dtype=torch.float32, active=active,
                                       block_tables=bt)
    np.testing.assert_allclose(v_logits.numpy(), torch.stack(seq_logits, 1).numpy(),
                               rtol=1e-5, atol=1e-5)
    seq_l = dict(_leaves(c_seq))
    for path, leaf in _leaves(c_ver):
        if kv == "bf16":
            np.testing.assert_allclose(leaf.numpy()[:, 1:], seq_l[path].numpy()[:, 1:],
                                       rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(leaf.numpy()[:, 1:], seq_l[path].numpy()[:, 1:])
    jc = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), fresh())
    j_logits, jc = jax.jit(lambda pr, c, t, p, a, b: j_decode_verify(
        pr, c, t, p, cfg, compute_dtype=jnp.float32, active=a, block_tables=b))(
        jp, jc, jnp.asarray(tokens.numpy()), jnp.asarray(pos0.numpy()),
        jnp.asarray(active.numpy()), jnp.asarray(bt.numpy()))
    np.testing.assert_allclose(v_logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    _assert_pools_equal(c_ver, jc, exact=kv != "bf16")


@pytest.mark.parametrize("pool", ["float", "int4"])
def test_mla_verify_paged_matches_sequential_decode_and_jax(pool):
    jcfg = jattn.MLAConfig(d_model=32, n_heads=4, q_lora_rank=16, kv_lora_rank=8,
                           qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)
    tcfg = tattn.MLAConfig(**dataclasses.asdict(jcfg))
    jp = jattn.mla_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    B, block, n_phys, T = 2, 4, 9, 3
    if pool == "float":
        base = {"c_kv": torch.zeros((n_phys, block, 8)), "k_rope": torch.zeros((n_phys, block, 4))}
    else:
        base = {"c_kv": torch.zeros((n_phys, block, 4), dtype=torch.int8),
                "k_rope": torch.zeros((n_phys, block, 2), dtype=torch.int8),
                "c_kv_scale": torch.zeros((n_phys,), dtype=torch.int32),
                "k_rope_scale": torch.zeros((n_phys,), dtype=torch.int32)}
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    pos0 = torch.tensor([3, 5], dtype=torch.int32)
    xs = torch.from_numpy(np.random.default_rng(7).standard_normal((B, T, 32)).astype(np.float32))
    c = {k: v.clone() for k, v in base.items()}
    outs = []
    for t in range(T):
        y, c = tattn.mla_decode(tp, xs[:, t: t + 1], c, pos0 + t, cfg=tcfg,
                                compute_dtype=torch.float32, block_tables=bt)
        outs.append(y[:, 0])
    positions = pos0[:, None] + torch.arange(T, dtype=torch.int32)[None]
    valid = torch.ones((B, T), dtype=torch.bool)
    cv = {k: v.clone() for k, v in base.items()}
    yv, cv = tattn.mla_verify_paged(tp, xs, cv, bt, positions, cfg=tcfg, valid=valid,
                                    compute_dtype=torch.float32)
    np.testing.assert_allclose(yv.numpy(), torch.stack(outs, 1).numpy(), rtol=1e-5, atol=1e-5)
    for k in base:
        np.testing.assert_array_equal(cv[k].numpy()[1:], c[k].numpy()[1:])
    jy, jc = jattn.mla_verify_paged(jp, jnp.asarray(xs.numpy()),
                                    {k: jnp.asarray(v.numpy()) for k, v in base.items()},
                                    jnp.asarray(bt.numpy()), jnp.asarray(positions.numpy()),
                                    cfg=jcfg, valid=jnp.asarray(valid.numpy()),
                                    compute_dtype=jnp.float32)
    np.testing.assert_allclose(yv.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    for k in base:
        a, b = cv[k].numpy()[1:], np.asarray(jc[k])[1:]
        if pool == "float":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_engines_bypass(arch):
    eng, _ = _engines(arch, "quantize_tree")
    reqs = _port_reqs(_requests(eng.cfg.vocab_size, lens=(3, 5), budgets=(5, 4)))
    comps, sched = eng.serve(reqs, ServeConfig(n_slots=2, speculative=SpeculativeConfig(
        draft=_trees(arch)[2]["packed"], k=3)), return_scheduler=True)
    assert not speculative_eligible(eng) and sched.spec_fns is None
    assert sched.stats["spec_steps"] == 0
    plain = eng.serve(reqs, ServeConfig(n_slots=2))
    assert [c.tokens for c in comps] == [c.tokens for c in plain]
