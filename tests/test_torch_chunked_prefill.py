"""Port parity, chunked prefill (repro_torch vs the JAX package), reduced
configs, fp32 compute, on the CPU.  Params are the port's seeded
``init_lm`` packed by JAX's jitted ``symog_init`` + ``pack_tree``, as
tests/test_torch_tail_prefill.py.

A chunk is the tail-prefill step from ``start`` = the tokens done, so a
chunked serve's streams equal a one-shot serve's (tests/test_chunked_prefill.py):

  - greedy serves with ``prefill_chunk`` 3 and 4 (block 4: chunk
    boundaries land mid-block) from float, int8_fp and int4_fp pools are
    token-identical to JAX's jitted serve under the same config and to the
    port's own one-shot serve; chunk, chunked-admission, prefill-only-step
    and first-token-step counts equal JAX's; quantized pools and exponents
    array_equal to JAX's outside the trash block, a float pool within 1e-4;
  - a chunk rides a step beside a live decode: the neighbour's stream keeps
    one token a step, and TTFT counts the final chunk;
  - chunking composes with the prefix cache (a chunk after a hit starts at
    the matched offset), as in JAX;
  - chunked sampled streams equal one-shot ones;
  - a prefilling slot's device table row stays zeroed until its final chunk."""
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.serve import Request, Scheduler, ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve import latency_stats  # noqa: E402

MAX_LEN, BLOCK = 32, 4
_TREES = {}
_ENG = {}
STATS = ("prefill_chunks", "chunked_admissions", "prefill_only_steps", "prefills",
         "decode_steps", "prefix_hits", "prefix_hit_tokens", "prefix_cow_copies")


def _trees(arch):
    if arch not in _TREES:
        cfg = jconfigs.get_reduced(arch)
        own = init_lm(0, tconfigs.get_reduced(arch), device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        jp = jax.jit(lambda p: jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg))(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own))
        _TREES[arch] = (cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    return _TREES[arch]


def _engines(arch, kv="bf16"):
    """(port engine, JAX engine), cached per module."""
    if (arch, kv) not in _ENG:
        cfg, jp, tp = _trees(arch)
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        _ENG[arch, kv] = (ServeEngine(cfg, tp, max_len=MAX_LEN, compute_dtype=torch.float32,
                                      device="cpu"),
                          JEngine(cfg, jp, max_len=MAX_LEN, compute_dtype=jnp.float32))
    return _ENG[arch, kv]


def _leaves(caches, prefix=()):
    if isinstance(caches, dict):
        for k in sorted(caches):
            yield from _leaves(caches[k], prefix + (k,))
    else:
        yield prefix, caches


def _requests(vocab, seed=0, lens=(5, 12, 3, 9, 14), budgets=(6, 4, 5, 3, 4), arrivals=None):
    """A short / long prompt mix: the 9-, 12- and 14-token prompts chunk."""
    rng = np.random.default_rng(seed)
    arrivals = arrivals or (0,) * len(lens)
    return [(rng.integers(0, vocab, size=L).astype(np.int32), b, a)
            for L, b, a in zip(lens, budgets, arrivals)]


def _serve_both(arch, kv, reqs, **sc):
    eng, jeng = _engines(arch, kv)
    tc, ts = eng.serve([Request(tokens=p, max_new_tokens=b, arrival=a) for p, b, a in reqs],
                       ServeConfig(**sc), return_scheduler=True)
    jc, js = jeng.serve([JRequest(tokens=p, max_new_tokens=b, arrival=a) for p, b, a in reqs],
                        JServeConfig(**sc), return_scheduler=True)
    return (tc, ts), (jc, js)


def _assert_like_jax(tc, ts, jc, js, kv):
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
    assert [(c.admitted_step, c.first_token_step, c.finished_step) for c in tc] == \
        [(c.admitted_step, c.first_token_step, c.finished_step) for c in jc]
    assert {k: ts.stats[k] for k in STATS} == {k: js.stats[k] for k in STATS}
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, js.caches)))
    for path, leaf in _leaves(ts.caches):
        a, b = leaf.numpy()[:, 1:], jl[path][:, 1:]  # the trash block aside
        if kv == "bf16":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=str(path))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("kv", ["bf16", "int8_fp", "int4_fp"])
@pytest.mark.parametrize("chunk", [3, 4])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b"])
def test_chunked_serve_matches_jax(arch, chunk, kv):
    eng, _ = _engines(arch, kv)
    reqs = _requests(eng.cfg.vocab_size, arrivals=(0, 0, 1, 2, 3))
    (tc, ts), (jc, js) = _serve_both(arch, kv, reqs, n_slots=2, block_size=BLOCK,
                                     prefill_chunk=chunk)
    assert ts.chunk == chunk
    _assert_like_jax(tc, ts, jc, js, kv)
    long = [len(p) for p, _, _ in reqs if len(p) > chunk]
    assert ts.stats["chunked_admissions"] == len(long)
    assert ts.stats["prefill_chunks"] == sum(-(-n // chunk) for n in long)
    one = eng.serve([Request(tokens=p, max_new_tokens=b, arrival=a) for p, b, a in reqs],
                    ServeConfig(n_slots=2, block_size=BLOCK))
    assert [c.tokens for c in tc] == [c.tokens for c in one]
    ts.pool.check()


def test_chunks_ride_beside_decode_and_ttft_counts_them():
    """A short request decoding while a 12-token prompt arrives: its four
    chunks of 3 ride four decode steps (no prefill-only step), the short
    stream keeps one token a step, and the long request's TTFT counts
    them."""
    eng, _ = _engines("internlm2-1.8b")
    reqs = _requests(eng.cfg.vocab_size, seed=1, lens=(3, 12), budgets=(12, 4), arrivals=(0, 3))
    (tc, ts), (jc, js) = _serve_both("internlm2-1.8b", "bf16", reqs, n_slots=2, block_size=BLOCK,
                                     prefill_chunk=3)
    _assert_like_jax(tc, ts, jc, js, "bf16")
    short, long = tc
    assert long.first_token_step - long.admitted_step == 3
    assert ts.stats["prefill_chunks"] == 4 and ts.stats["prefill_only_steps"] == 0
    assert short.finished_step - short.first_token_step == len(short.tokens) - 1
    alone = eng.serve([Request(tokens=reqs[1][0], max_new_tokens=3)],
                      ServeConfig(n_slots=1, block_size=BLOCK, prefill_chunk=3))
    lat = latency_stats(alone)
    assert lat["ttft_steps"]["p50"] == 4.0 and lat["queue_steps"]["p50"] == 0.0


@pytest.mark.parametrize("kv", ["bf16", "int4_fp"])
def test_chunked_prefill_composes_with_prefix_cache(kv):
    eng, _ = _engines("gemma3-4b", kv)
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, eng.cfg.vocab_size, size=9).astype(np.int32)
    reqs = [(np.concatenate([prefix, rng.integers(0, eng.cfg.vocab_size, size=n)]).astype(
        np.int32), 4, 0) for n in (4, 7)]
    sc = dict(n_slots=1, block_size=BLOCK, prefix_cache=True, prefill_chunk=3)
    (tc, ts), (jc, js) = _serve_both("gemma3-4b", kv, reqs, **sc)
    _assert_like_jax(tc, ts, jc, js, kv)
    assert ts.stats["prefix_hits"] == 1 and ts.stats["prefix_hit_tokens"] == 9
    assert ts.stats["prefix_cow_copies"] == 1  # 9 = 2 blocks + 1 row
    # the 13-token miss chunks 5x from 0; the 7-token tail 3x from 9
    assert ts.stats["chunked_admissions"] == 2 and ts.stats["prefill_chunks"] == 5 + 3
    plain = eng.serve([Request(tokens=p, max_new_tokens=b) for p, b, _ in reqs],
                      ServeConfig(n_slots=1, block_size=BLOCK))
    assert [c.tokens for c in tc] == [c.tokens for c in plain]
    ts.pool.check()


def test_chunked_sampled_streams_match_one_shot():
    eng, _ = _engines("internlm2-1.8b")
    reqs = [Request(tokens=p, max_new_tokens=b) for p, b, _ in _requests(eng.cfg.vocab_size)]
    kw = dict(n_slots=2, block_size=BLOCK, temperature=0.9, top_k=7, seed=13)
    one = eng.serve(reqs, ServeConfig(**kw))
    chunked = eng.serve(reqs, ServeConfig(prefill_chunk=3, **kw))
    assert [c.tokens for c in one] == [c.tokens for c in chunked]
    greedy = eng.serve(reqs, ServeConfig(n_slots=2, block_size=BLOCK))
    assert [c.tokens for c in one] != [c.tokens for c in greedy]


def test_prefilling_slot_keeps_its_device_row_zeroed():
    eng, _ = _engines("internlm2-1.8b", "int4_fp")
    sched = Scheduler(eng, ServeConfig(n_slots=1, block_size=BLOCK, prefill_chunk=3))
    prompt = np.random.default_rng(3).integers(0, eng.cfg.vocab_size, size=10).astype(np.int32)
    sched.submit(Request(tokens=prompt, max_new_tokens=4))
    for done in (3, 6, 9):
        sched.step()
        state = sched._slots[0]
        assert state.prefilling and state.done == done
        assert not bool(sched._block_tables[0].any()) and not bool(sched._active[0])
    sched.step()  # the final chunk publishes the row, samples the first token, decodes
    state = sched._slots[0]
    assert not state.prefilling and len(state.out) == 2 and state.first_token_step == 3
    assert sched._block_tables[0].tolist()[:3] == (np.asarray(state.blocks) + 1).tolist()
    assert sched.stats["prefill_only_steps"] == 3
