"""Port parity, serving telemetry end to end (repro_torch.serve against
repro.serve), reduced internlm2, fp32, on the CPU.  Params are the port's
seeded ``init_lm`` packed by JAX's jitted ``symog_init`` + ``pack_tree``
(a second seed gives a disagreeing speculative draft).

The cases of tests/test_telemetry_serve.py, each serve run by both
packages on the same requests.  For plain, preempting, chunked,
prefix-cache, cancelled and speculative serves the two registries must
agree: every counter and gauge equal, every histogram in decode-step or
token units (``serve_queue_wait_steps``, ``serve_ttft_steps``,
``serve_accepted_per_step``) equal bucket for bucket; the wall-time
metrics (``serve_itl_seconds``, the EWMA step time, the straggler
fraction) by name, and the histogram by sample count.  Timelines, events,
the tracer's instants and span kinds and ``latency_stats`` are equal too."""
import asyncio
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402

MAX_LEN = 24
WALL = ("serve_itl_seconds", "serve_step_time_ewma_seconds", "serve_straggler_fraction")
_ENG = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    """{'port': (engine, draft tree), 'jax': (engine, draft tree)}, cached."""
    if not _ENG:
        cfg = jconfigs.get_reduced("internlm2-1.8b")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        pack = jax.jit(lambda p: jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg))
        trees = []
        for seed in (0, 1):
            own = init_lm(seed, tconfigs.get_reduced("internlm2-1.8b"), device="cpu")
            jt = pack(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own))
            trees.append((jt, params_from_numpy(jax.tree_util.tree_map(np.asarray, jt))))
        (jt, tt), (jd, td) = trees
        _ENG["port"] = (tserve.ServeEngine(cfg, tt, max_len=MAX_LEN, compute_dtype=torch.float32,
                                           device="cpu"), td)
        _ENG["jax"] = (jserve.ServeEngine(cfg, jt, max_len=MAX_LEN, compute_dtype=jnp.float32),
                       jd)
    return _ENG


def _requests(mod, lens=(3, 6, 4, 5), budgets=(5, 3, 6, 4), seed=0):
    rng = np.random.default_rng(seed)
    vocab = jconfigs.get_reduced("internlm2-1.8b").vocab_size
    return [mod.Request(tokens=rng.integers(0, vocab, size=L).astype(np.int32), max_new_tokens=b)
            for L, b in zip(lens, budgets)]


def _serve(mod, reqs_kw=None, draft=False, **sc):
    eng, dtree = _setup()["port" if mod is tserve else "jax"]
    if draft:
        sc["speculative"] = mod.SpeculativeConfig(draft=dtree, k=3)
    return eng.serve(_requests(mod, **(reqs_kw or {})), mod.ServeConfig(**sc),
                     return_scheduler=True)


def _metrics(snap):
    """The registry as compared: wall-time metrics by name (histogram: by
    sample count), everything else in full."""
    out = {}
    for name, v in snap.items():
        if name in WALL:
            v = v["count"] if isinstance(v, dict) else "wall"
        out[name] = v
    return out


def _comp(c):
    return (c.index, [int(t) for t in c.tokens], c.finish_reason, c.slot, c.admitted_step,
            c.finished_step, c.first_token_step, c.spec_steps, c.spec_tokens,
            [(e, int(s)) for e, s in c.timeline])


def _assert_same(port, ref):
    (tc, ts), (jc, js) = port, ref
    assert [_comp(c) for c in tc] == [_comp(c) for c in jc]
    assert list(ts.events) == list(js.events)
    assert list(ts.registry.snapshot()) == list(js.registry.snapshot())
    assert _metrics(ts.registry.snapshot()) == _metrics(js.registry.snapshot())
    assert tserve.latency_stats(tc) == jserve.latency_stats(jc)


def _both(**kw):
    port, ref = _serve(tserve, **kw), _serve(jserve, **kw)
    _assert_same(port, ref)
    return port


def _events(comp, kind):
    return [step for ev, step in comp.timeline if ev == kind]


# ---------------------------------------------------------------------------
# registry-backed stats: one source of truth, three exports
# ---------------------------------------------------------------------------
def test_stats_dict_is_a_registry_view():
    comps, sched = _both(n_slots=2)
    stats, snap = sched.stats, sched.registry.snapshot()
    assert stats["tokens_emitted"] == sum(len(c.tokens) for c in comps)
    for key in ("decode_steps", "prefills", "tokens_emitted", "preemptions"):
        assert snap[f"serve_{key}"] == stats[key]
    assert snap["serve_live_slots"] == 0 and snap["serve_pool_live_blocks"] == 0
    assert snap["serve_pool_free_blocks"] == sched.pool.n_free
    assert snap["serve_pool_bytes"] == sched.cache_bytes() > 0
    assert snap["serve_queue_wait_steps"]["count"] == len(comps)
    assert snap["serve_ttft_steps"]["count"] == len(comps)
    assert snap["serve_itl_seconds"]["count"] > 0
    prom = sched.registry.to_prometheus()
    assert f"serve_tokens_emitted {stats['tokens_emitted']}" in prom
    doc = json.loads(sched.registry.to_json())
    assert doc["metrics"]["serve_decode_steps"] == stats["decode_steps"]


def test_step_time_monitor_feeds_gauges():
    _, sched = _serve(tserve, n_slots=2)
    _, jsched = _serve(jserve, n_slots=2)
    assert sched.monitor.count == sched.stats["decode_steps"] == jsched.monitor.count
    snap = sched.registry.snapshot()
    assert snap["serve_step_time_ewma_seconds"] > 0.0
    assert 0.0 <= snap["serve_straggler_fraction"] <= 1.0


# ---------------------------------------------------------------------------
# lifecycle timelines reconcile with Completion.tokens
# ---------------------------------------------------------------------------
def test_timeline_token_events_match_tokens():
    comps, _ = _both(n_slots=2)
    for comp in comps:
        assert comp.timeline[0] == ("submit", 0) and comp.timeline[-1][0] == "finish"
        assert len(_events(comp, "admit")) == 1
        assert len(_events(comp, "token")) == len(comp.tokens)
        steps = [s for _, s in comp.timeline]
        assert steps == sorted(steps)


def test_timeline_under_preemption_replay():
    comps, sched = _both(reqs_kw=dict(lens=(8, 8), budgets=(16, 16)), n_slots=2, block_size=4,
                         n_blocks=6)
    assert sched.stats["preemptions"] >= 1
    preempted = [c for c in comps if _events(c, "preempt")]
    assert preempted
    for comp in preempted:
        admits = _events(comp, "admit")
        assert len(admits) == len(_events(comp, "preempt")) + 1
        assert comp.admitted_step == admits[-1] > admits[0]
        assert len(_events(comp, "token")) == len(comp.tokens)
    lat = tserve.latency_stats(comps)
    assert lat["queue_steps"]["mean"] == pytest.approx(
        np.mean([c.admitted_step - c.arrival for c in comps]))


def _cancelled(mod):
    eng, _ = _setup()["port" if mod is tserve else "jax"]
    sched = mod.Scheduler(eng, mod.ServeConfig(n_slots=2))
    ids = [sched.submit(r) for r in _requests(mod, lens=(4, 6), budgets=(10, 10))]
    for _ in range(3):
        sched.step()
    assert sched.cancel(ids[0])
    return sched.run(), sched


def test_timeline_and_latency_on_cancellation():
    port = _cancelled(tserve)
    _assert_same(port, _cancelled(jserve))
    comps, sched = port
    gone, kept = comps
    assert gone.finish_reason == "cancelled" and gone.timeline[-1][0] == "cancel"
    assert len(_events(gone, "token")) == len(gone.tokens) > 0
    assert len(_events(kept, "token")) == len(kept.tokens)
    assert tserve.latency_stats(comps) == tserve.latency_stats([kept])
    assert tserve.latency_stats([gone]) == {} and tserve.latency_stats([]) == {}
    snap = sched.registry.snapshot()
    assert snap["serve_queue_wait_steps"]["count"] == snap["serve_ttft_steps"]["count"] == 1
    assert snap["serve_cancellations"] == 1


def test_ttft_honest_under_chunked_prefill():
    nchunks = math.ceil(10 / 4)
    comps, sched = _both(reqs_kw=dict(lens=(10,), budgets=(3,)), n_slots=2, prefill_chunk=4)
    (comp,) = comps
    assert sched.stats["chunked_admissions"] == 1
    assert len(_events(comp, "chunk")) == nchunks
    assert comp.first_token_step - comp.admitted_step == nchunks - 1
    assert _events(comp, "token")[0] == comp.first_token_step
    lat = tserve.latency_stats(comps)
    assert lat["ttft_steps"]["p50"] == lat["queue_steps"]["p50"] + nchunks
    hist = sched.registry.snapshot()["serve_ttft_steps"]
    assert hist["count"] == 1 and hist["sum"] == comp.first_token_step - comp.arrival + 1


def test_prefix_cache_registry_equals_jax():
    """Shared-prefix prompts under the prefix cache: the prefix_* counters
    (the cache's own ``StatsView``) and the serve_prefix_* ones agree."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 64, size=12).astype(np.int32)

    def run(mod):
        eng, _ = _setup()["port" if mod is tserve else "jax"]
        reqs = [mod.Request(tokens=np.concatenate([base[:n], base[:2] + 1]), max_new_tokens=3,
                            arrival=2 * i) for i, n in enumerate((8, 9, 12))]
        return eng.serve(reqs, mod.ServeConfig(n_slots=2, block_size=4, prefix_cache=True),
                         return_scheduler=True)

    port = run(tserve)
    _assert_same(port, run(jserve))
    snap = port[1].registry.snapshot()
    assert snap["prefix_hits"] == snap["serve_prefix_hits"] == 2
    assert snap["serve_prefix_cow_copies"] >= 1


# ---------------------------------------------------------------------------
# steady state: no new steps built after warmup (admission buckets exempt)
# ---------------------------------------------------------------------------
def _steady(mod):
    eng, _ = _setup()["port" if mod is tserve else "jax"]
    lens, budgets = (3, 6, 4, 10, 5, 7), (5, 3, 6, 4, 2, 3)
    cfg = mod.ServeConfig(n_slots=2, prefill_chunk=4)
    eng.serve(_requests(mod, lens=lens, budgets=budgets), cfg)  # warmup
    sched = mod.Scheduler(eng, cfg)
    for i, req in enumerate(_requests(mod, lens=lens * 2, budgets=budgets * 2)):
        sched.submit(dataclasses.replace(req, arrival=i * 3))
    flat = True
    while sched._n_live or sched._queue:
        sched.step()
        flat &= sched.stats["decode_trace_compiles"] == sched.stats["chunk_trace_compiles"] == 0
    return flat, sched.step_count, dict(sched.stats)


def test_steady_state_compile_counters_flat():
    port = _steady(tserve)
    assert port == _steady(jserve)
    flat, steps, stats = port
    assert flat and steps >= 32
    assert stats["decode_steps"] > 0 and stats["chunked_admissions"] > 0


def test_steady_state_verify_compiles_flat():
    """Speculative serves: the second serve on a warm engine builds no new
    verify step, and the registry (serve_accepted_per_step included)
    equals JAX's."""
    kw = dict(reqs_kw=dict(lens=(3, 6, 4), budgets=(6, 4, 5)), draft=True, n_slots=2)
    _both(**kw)
    comps, sched = _both(**kw)
    assert sched.stats["spec_steps"] > 0
    assert sched.stats["verify_trace_compiles"] == sched.stats["decode_trace_compiles"] == 0
    acc = sched.registry.snapshot()["serve_accepted_per_step"]
    assert acc["count"] == sched.stats["spec_row_rounds"]
    assert acc["sum"] == sched.stats["spec_emitted"] == sched.stats["tokens_emitted"] - len(comps)


# ---------------------------------------------------------------------------
# tracing through a real serve
# ---------------------------------------------------------------------------
def test_trace_spans_cover_serve_phases(tmp_path):
    kw = dict(reqs_kw=dict(lens=(8, 8), budgets=(16, 16)), n_slots=2, block_size=4, n_blocks=6)
    comps, sched = _serve(tserve, telemetry=tserve.TelemetryConfig(trace=True, trace_capacity=512),
                          **kw)
    _, jsched = _serve(jserve, telemetry=jserve.TelemetryConfig(trace=True, trace_capacity=512),
                       **kw)
    assert [(k, a) for k, _, _, a in sched.tracer.spans] == [
        (k, a) for k, _, _, a in jsched.tracer.spans]
    assert [(k, a) for k, _, a in sched.tracer.instants] == [
        (k, a) for k, _, a in jsched.tracer.instants]
    kinds = {s[0] for s in sched.tracer.spans}
    assert {"admit", "decode"} <= kinds
    assert {"evict", "preempt"} <= {i[0] for i in sched.tracer.instants}
    assert sum(1 for s in sched.tracer.spans if s[0] == "decode") == sched.stats["decode_steps"]
    path = tmp_path / "serve_trace.json"
    sched.tracer.export_chrome(str(path))
    doc = json.loads(path.read_text())
    assert {e["name"] for e in doc["traceEvents"]} >= {"admit", "decode", "evict"}
    assert sched.events.capacity == sched.admit_times.capacity == 512
    off, _ = _serve(tserve, **kw)
    assert [c.tokens for c in comps] == [c.tokens for c in off]


def test_tracing_off_by_default():
    _, sched = _serve(tserve, n_slots=2)
    assert sched.tracer.enabled is False and len(sched.tracer) == 0
    assert sched._profile is None


# ---------------------------------------------------------------------------
# async surface
# ---------------------------------------------------------------------------
def _async(mod):
    eng, _ = _setup()["port" if mod is tserve else "jax"]
    reqs = _requests(mod, lens=(3, 5), budgets=(4, 6))

    async def main():
        async with mod.AsyncServeEngine(eng, mod.ServeConfig(n_slots=2)) as srv:
            ids = [srv.submit(r) for r in reqs]
            comps = await srv.drain()
            return ids, comps, [srv.timeline(i) for i in ids], srv.metrics.snapshot()

    return asyncio.run(main())


def test_async_metrics_and_timeline():
    ids, comps, timelines, snap = _async(tserve)
    jids, jcomps, jtimelines, jsnap = _async(jserve)
    assert ids == jids and [_comp(c) for c in comps] == [_comp(c) for c in jcomps]
    assert timelines == jtimelines and _metrics(snap) == _metrics(jsnap)
    by_idx = {c.index: c for c in comps}
    for idx, tl in zip(ids, timelines):
        assert tl == by_idx[idx].timeline
        assert len([1 for ev, _ in tl if ev == "token"]) == len(by_idx[idx].tokens)
    assert snap["serve_tokens_emitted"] == sum(len(c.tokens) for c in comps)
