"""Port parity, serving (repro_torch.serve vs repro.serve) on REDUCED
internlm2-1.8b, fp32 compute, on the CPU: greedy continuous-batching
``serve()`` is TOKEN-IDENTICAL to the JAX engine's ``serve()`` and to the
port's own static dense-cache loop ``generate_static``, for float,
``quantize_tree`` and ``pack_tree`` params (packed on the CPU's unpack path)
— with ragged prompts and budgets, block growth, eos eviction and
preemption with exact replay (mirrors tests/test_scheduler.py and
tests/test_packed_serving.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Request,
    ServeConfig,
    ServeEngine,
    latency_stats,
)

MAX_LEN = 24
_ENG = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(kind):
    """(jax engine, port engine) per param kind, built once per module."""
    if kind not in _ENG:
        cfg = jconfigs.get_reduced("internlm2-1.8b")
        jp = j_init(jax.random.PRNGKey(0), cfg)
        if kind != "float":
            scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
            st = jcore.symog_init(jp, scfg)
            jp = (jcore.quantize_tree if kind == "quantize_tree" else jcore.pack_tree)(jp, st, scfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
        _ENG[kind] = (JEngine(cfg, jp, max_len=MAX_LEN, compute_dtype=jnp.float32),
                      ServeEngine(cfg, tp, max_len=MAX_LEN, compute_dtype=torch.float32,
                                  device="cpu"))
    return _ENG[kind]


def _requests(lens=(3, 6, 4, 5, 7), budgets=(5, 3, 6, 4, 2), seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=L).astype(np.int32), b) for L, b in zip(lens, budgets)]


def _static(eng, prompt, steps):
    return eng.generate_static({"tokens": prompt[None]}, steps)[0].numpy()


@pytest.mark.parametrize("kind", ["float", "quantize_tree", "pack_tree"])
def test_serve_token_identical_to_jax_and_static(kind):
    jeng, teng = _engines(kind)
    assert teng.packed == (kind == "pack_tree")
    reqs = _requests()
    jcomps = jeng.serve([JRequest(tokens=p, max_new_tokens=b) for p, b in reqs],
                        JServeConfig(n_slots=2))
    tcomps, sched = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                               ServeConfig(n_slots=2), return_scheduler=True)
    assert [c.index for c in tcomps] == list(range(len(reqs)))
    for (p, b), jc, tc in zip(reqs, jcomps, tcomps):
        assert tc.tokens == list(jc.tokens)
        np.testing.assert_array_equal(np.asarray(tc.tokens), _static(teng, p, b))
        assert tc.finish_reason == jc.finish_reason == "length"
        assert (tc.admitted_step, tc.finished_step) == (jc.admitted_step, jc.finished_step)
    static_steps = sum(max(b for _, b in reqs[lo: lo + 2]) for lo in range(0, len(reqs), 2))
    assert sched.stats["decode_steps"] < static_steps
    assert sched.pool.n_live == 0


def test_packed_serve_equals_quantize_tree_serve():
    reqs = _requests(seed=1)
    out = {}
    for kind in ("quantize_tree", "pack_tree"):
        teng = _engines(kind)[1]
        out[kind] = [c.tokens for c in teng.serve(
            [Request(tokens=p, max_new_tokens=b) for p, b in reqs], ServeConfig(n_slots=3))]
    assert out["quantize_tree"] == out["pack_tree"]
    assert _engines("pack_tree")[1].weight_bytes() < _engines("quantize_tree")[1].weight_bytes() / 4


def test_small_blocks_eos_and_preemption_match_jax():
    """block_size=4 forces block growth mid-decode; a 6-block pool forces
    youngest-first preemption with exact replay; an eos id taken from the
    first request's stream evicts it early — all token-identical to JAX."""
    jeng, teng = _engines("quantize_tree")
    reqs = _requests(lens=(8, 8, 5), budgets=(16, 16, 6), seed=2)
    eos = int(_static(teng, reqs[0][0], 16)[3])
    cfgs = [
        (dict(n_slots=2, block_size=4), -1),
        (dict(n_slots=2, block_size=4, n_blocks=6), -1),
        (dict(n_slots=2, block_size=4), eos),
    ]
    for kw, eos_id in cfgs:
        jcomps, jsched = jeng.serve(
            [JRequest(tokens=p, max_new_tokens=b, eos_id=eos_id) for p, b in reqs],
            JServeConfig(**kw), return_scheduler=True)
        tcomps, tsched = teng.serve(
            [Request(tokens=p, max_new_tokens=b, eos_id=eos_id) for p, b in reqs],
            ServeConfig(**kw), return_scheduler=True)
        for jc, tc in zip(jcomps, tcomps):
            assert tc.tokens == list(jc.tokens)
            assert tc.finish_reason == jc.finish_reason
        for key in ("preemptions", "evictions", "decode_steps", "prefills"):
            assert tsched.stats[key] == jsched.stats[key], key
        assert tsched.pool.n_live == 0
        if "n_blocks" in kw:
            assert tsched.stats["preemptions"] >= 1
        if eos_id >= 0:
            assert tcomps[0].finish_reason == "eos" and tcomps[0].tokens[-1] == eos


def test_request_filling_max_len_leaves_the_batch_running():
    """A request that ends at max_len (a multiple of the block) keeps pos =
    max_len in its freed slot;
    the next decode steps of the others clamp its table lookup into the
    trash block, as JAX's gather clamps it (an out-of-range index before)."""
    jeng, teng = _engines("float")
    reqs = _requests(lens=(20, 4), budgets=(5, 12), seed=8)
    jc = jeng.serve([JRequest(tokens=p, max_new_tokens=b) for p, b in reqs],
                    JServeConfig(n_slots=2, block_size=4))
    tc = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                    ServeConfig(n_slots=2, block_size=4))
    assert len(tc[0].tokens) == MAX_LEN - 20 + 1 and tc[0].finished_step < tc[1].finished_step
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]


def test_generate_wrapper_and_latency_stats():
    _, teng = _engines("float")
    batch = {"tokens": np.random.default_rng(6).integers(0, 256, size=(3, 6)).astype(np.int32)}
    np.testing.assert_array_equal(teng.generate(batch, 5).numpy(),
                                  teng.generate_static(batch, 5).numpy())
    reqs = [Request(tokens=p, max_new_tokens=b) for p, b in _requests(lens=(4, 5, 6),
                                                                      budgets=(3, 4, 5))]
    reqs[2] = dataclasses.replace(reqs[2], arrival=4)
    stats = latency_stats(teng.serve(reqs, ServeConfig(n_slots=2)))
    assert stats["ttft_steps"]["p50"] == stats["queue_steps"]["p50"] + 1.0
    assert latency_stats([]) == {}


def test_serve_config_rejects_sampling_and_quantized_kv():
    """What stays refused now that sampling and quantized pools serve:
    negative temperature or top_k, a bad block size, and an unknown
    kv_cache_dtype."""
    for kw in (dict(temperature=-0.1), dict(top_k=-1), dict(block_size=0), dict(n_slots=-1)):
        with pytest.raises(ValueError):
            ServeConfig(**kw)
    ServeConfig(temperature=0.7, top_k=50, seed=123)  # sampling is accepted
    cfg = dataclasses.replace(jconfigs.get_reduced("internlm2-1.8b"), kv_cache_dtype="fp8")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ServeEngine(cfg, {}, max_len=8, device="cpu")


def test_from_symog_packs_and_serves():
    """from_symog packs a float tree with the port's own SYMOG and serves it
    token-identically to the JAX engine built from the JAX artifact."""
    cfg = jconfigs.get_reduced("internlm2-1.8b")
    jp = j_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    scfg = tcore.SymogConfig(n_bits=2, total_steps=1)
    teng = ServeEngine.from_symog(cfg, tp, tcore.symog_init(tp, scfg), scfg, max_len=MAX_LEN,
                                  compute_dtype=torch.float32, device="cpu")
    assert teng.packed
    jeng = _engines("pack_tree")[0]
    reqs = _requests(lens=(5, 9), budgets=(4, 4), seed=7)
    jc = jeng.serve([JRequest(tokens=p, max_new_tokens=b) for p, b in reqs])
    tc = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs])
    assert [c.tokens for c in tc] == [list(c.tokens) for c in jc]
