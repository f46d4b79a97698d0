"""Port parity, streaming, cancellation, priority and the asyncio front end
(repro_torch.serve against repro.serve), reduced internlm2, fp32, on the
CPU.  Params are the port's seeded ``init_lm`` packed by JAX's jitted
``symog_init`` + ``pack_tree``, as tests/test_torch_prefix_cache.py.

Each case of tests/test_async_serve.py runs as one scenario written once
and driven through both packages' schedulers on the same requests: the
completions (tokens, finish reasons, slots, steps, timelines), the
``events`` log, the streamed tokens, what ``cancel`` returns and the
admission order under priority must be equal to the JAX package's.  The
asyncio cases hold the port's async streams to the port's synchronous
serve (which the scenarios hold to JAX's), and one case serves two
engines with different kernel backends from two threads at once: each
must count calls only on its own route and give its own tokens (the
dispatch backends are per thread)."""
import asyncio
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.serve import AsyncServeEngine, Request, Scheduler, ServeConfig  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

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


def _engines():
    """(port engine, JAX engine) of one packed artifact, cached."""
    if not _ENG:
        cfg = jconfigs.get_reduced("internlm2-1.8b")
        own = init_lm(0, tconfigs.get_reduced("internlm2-1.8b"), device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        jf = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own)
        st = jax.jit(lambda p: jcore.symog_init(p, scfg))(jf)
        jt = jax.jit(lambda p, s: jcore.pack_tree(p, s, scfg))(jf, st)
        tt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jt))
        _ENG["port"] = ServeEngine(cfg, tt, max_len=MAX_LEN, compute_dtype=torch.float32,
                                   device="cpu")
        _ENG["jax"] = JEngine(cfg, jt, max_len=MAX_LEN, compute_dtype=jnp.float32)
        _ENG["tree"] = tt
    return _ENG["port"], _ENG["jax"]


PORT = types.SimpleNamespace(name="port", Request=Request, Scheduler=Scheduler,
                             ServeConfig=ServeConfig, eng=lambda: _engines()[0])
JAX = types.SimpleNamespace(name="jax", Request=JRequest, Scheduler=JScheduler,
                            ServeConfig=JServeConfig, eng=lambda: _engines()[1])


def _requests(ns, lens=(3, 6, 4, 5), budgets=(5, 3, 6, 4), seed=0, **kw):
    rng = np.random.default_rng(seed)
    vocab = ns.eng().cfg.vocab_size
    return [ns.Request(tokens=rng.integers(0, vocab, size=L).astype(np.int32),
                       max_new_tokens=b, **kw) for L, b in zip(lens, budgets)]


def _comp(c):
    return dict(index=c.index, tokens=[int(t) for t in c.tokens], reason=c.finish_reason,
                slot=c.slot, arrival=c.arrival, admitted=c.admitted_step,
                finished=c.finished_step, first=c.first_token_step,
                timeline=[(e, int(s)) for e, s in c.timeline])


def _both(scenario, **kw):
    """Run ``scenario(ns)`` on the port and on JAX; the results must be equal."""
    port, ref = scenario(PORT, **kw), scenario(JAX, **kw)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# synchronous streaming callbacks
# ---------------------------------------------------------------------------
def _streaming(ns):
    streamed = {}
    cfg = ns.ServeConfig(n_slots=2, on_token=lambda i, t: streamed.setdefault(i, []).append(t))
    comps, sched = ns.eng().serve(_requests(ns), cfg, return_scheduler=True)
    return [_comp(c) for c in comps], {i: [int(t) for t in v] for i, v in streamed.items()}, \
        list(sched.events)


def test_streaming_matches_completions():
    comps, streamed, _ = _both(_streaming)
    assert set(streamed) == {c["index"] for c in comps}
    for c in comps:
        assert streamed[c["index"]] == c["tokens"]


def _override(ns):
    via_default, via_override = [], []
    sched = ns.Scheduler(ns.eng(), ns.ServeConfig(
        n_slots=2, on_token=lambda i, t: via_default.append((i, int(t)))))
    reqs = _requests(ns, lens=(3, 5), budgets=(4, 4))
    sched.submit(reqs[0])
    sched.submit(reqs[1], on_token=lambda i, t: via_override.append((i, int(t))))
    return [_comp(c) for c in sched.run()], via_default, via_override


def test_per_request_callback_overrides_default():
    comps, via_default, via_override = _both(_override)
    assert [t for i, t in via_default] == comps[0]["tokens"] and {i for i, _ in via_default} == {0}
    assert [t for i, t in via_override] == comps[1]["tokens"]
    assert {i for i, _ in via_override} == {1}


def _replay(ns):
    streamed = {}
    comps, sched = ns.eng().serve(
        _requests(ns, lens=(8, 8), budgets=(16, 16)),
        ns.ServeConfig(n_slots=2, block_size=4, n_blocks=6,
                       on_token=lambda i, t: streamed.setdefault(i, []).append(int(t))),
        return_scheduler=True)
    return [_comp(c) for c in comps], streamed, sched.stats["preemptions"], list(sched.events)


def test_preemption_replay_streams_each_token_once():
    comps, streamed, preemptions, _ = _both(_replay)
    assert preemptions > 0
    for c in comps:
        assert streamed[c["index"]] == c["tokens"]


def _on_finish(ns):
    fins = []
    sched = ns.Scheduler(ns.eng(), ns.ServeConfig(n_slots=2))
    ids = [sched.submit(r, on_finish=fins.append)
           for r in _requests(ns, lens=(3, 4, 5), budgets=(3, 8, 3))]
    for _ in range(2):
        sched.step()
    cancelled = sched.cancel(ids[1])
    comps = sched.run()
    return ids, cancelled, [_comp(c) for c in fins], [_comp(c) for c in comps]


def test_on_finish_fires_for_every_reason():
    ids, cancelled, fins, comps = _both(_on_finish)
    assert cancelled and sorted(c["index"] for c in fins) == ids
    assert {c["index"]: c["reason"] for c in fins}[ids[1]] == "cancelled"
    assert sorted(fins, key=lambda c: c["index"]) == comps


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------
def _cancel_mid(ns):
    reqs = _requests(ns, lens=(4, 6), budgets=(10, 10))
    baseline = ns.eng().serve(reqs, ns.ServeConfig(n_slots=2, block_size=4))
    sched = ns.Scheduler(ns.eng(), ns.ServeConfig(n_slots=2, block_size=4))
    ids = [sched.submit(r) for r in reqs]
    for _ in range(3):
        sched.step()
    live_blocks = sum(len(s.blocks) for s in sched._slots if s is not None)
    free_before = sched.pool.n_free
    victim_blocks = len(next(s for s in sched._slots if s is not None and s.index == ids[0]).blocks)
    cancelled = sched.cancel(ids[0])
    left = [s for s in sched._slots if s is not None]
    assert len(left) == 1
    assert sched.pool.n_live == len(left[0].blocks) < live_blocks
    assert sched.pool.n_free == free_before + victim_blocks
    sched.pool.check([s.blocks for s in left])
    comps = sched.run()
    sched.pool.check()
    assert sched.pool.n_live == 0
    return (cancelled, [_comp(c) for c in comps], [_comp(c) for c in baseline],
            list(sched.events))


def test_cancel_mid_decode_frees_blocks_and_spares_survivors():
    cancelled, comps, baseline, _ = _both(_cancel_mid)
    assert cancelled
    assert comps[0]["reason"] == "cancelled" and len(comps[0]["tokens"]) == 4
    assert comps[0]["tokens"] == baseline[0]["tokens"][:4]
    assert comps[0]["timeline"][-1][0] == "cancel"
    assert comps[1]["tokens"] == baseline[1]["tokens"] and comps[1]["reason"] == "length"


def _cancel_queued(ns):
    sched = ns.Scheduler(ns.eng(), ns.ServeConfig(n_slots=1))
    ids = [sched.submit(r) for r in _requests(ns, lens=(3, 4), budgets=(4, 4))]
    sched.step()
    returns = [sched.cancel(ids[1]), sched.cancel(ids[1]), sched.cancel(99)]
    comps = sched.run()
    returns.append(sched.cancel(ids[0]))
    return returns, [_comp(c) for c in comps], list(sched.events)


def test_cancel_queued_and_unknown():
    returns, comps, events = _both(_cancel_queued)
    assert returns == [True, False, False, False]
    assert comps[1]["reason"] == "cancelled" and comps[1]["tokens"] == []
    assert comps[1]["slot"] == -1 and comps[0]["reason"] == "length"
    assert (1, "cancel", 1, -1) in events


# ---------------------------------------------------------------------------
# priority admission and preemption
# ---------------------------------------------------------------------------
def _priority(ns, priorities):
    sched = ns.Scheduler(ns.eng(), ns.ServeConfig(n_slots=1))
    reqs = _requests(ns, lens=(3, 3, 3), budgets=(2, 2, 2))
    for r, p in zip(reqs, priorities):
        r.priority = p
    ids = [sched.submit(r) for r in reqs]
    comps = sched.run()
    admits = [idx for _, kind, idx, _ in sched.events if kind == "admit"]
    return ids, admits, [_comp(c) for c in comps]


def test_priority_admits_before_older_fifo_peers():
    ids, admits, _ = _both(_priority, priorities=(0, 0, 1))
    assert admits == [ids[2], ids[0], ids[1]]


def test_priority_zero_is_plain_fifo():
    ids, admits, _ = _both(_priority, priorities=(0, 0, 0))
    assert admits == ids


def _victim(ns):
    sched = ns.Scheduler(ns.eng(), ns.ServeConfig(n_slots=2, block_size=4, n_blocks=6))
    low, high = _requests(ns, lens=(8, 8), budgets=(16, 16))
    high.priority = 5
    id_low, id_high = sched.submit(low), sched.submit(high)
    comps = sched.run()
    preempted = {idx for _, kind, idx, _ in sched.events if kind == "preempt"}
    return id_low, id_high, preempted, sched.stats["preemptions"], [_comp(c) for c in comps], \
        list(sched.events)


def test_preemption_victim_is_lowest_priority():
    id_low, id_high, preempted, n, comps, _ = _both(_victim)
    assert n > 0 and preempted == {id_low}
    assert all(c["reason"] == "length" for c in comps)


# ---------------------------------------------------------------------------
# the legacy keyword forms of serve() and Scheduler
# ---------------------------------------------------------------------------
def _legacy(ns):
    eng = ns.eng()
    reqs = _requests(ns, lens=(4, 5, 6), budgets=(4, 4, 4))
    new = eng.serve(reqs, ns.ServeConfig(n_slots=2, temperature=0.8, top_k=5, seed=7))
    with pytest.warns(DeprecationWarning):
        old = eng.serve(reqs, n_slots=2, temperature=0.8, top_k=5, seed=7)
    assert [c.tokens for c in old] == [c.tokens for c in new]
    for bad in (lambda: eng.serve([], ns.ServeConfig(n_slots=2), n_slots=2),
                lambda: ns.Scheduler(eng, ns.ServeConfig(n_slots=2), temperature=0.5)):
        with pytest.raises(TypeError, match="not both"):
            bad()
    with pytest.warns(DeprecationWarning):
        sched = ns.Scheduler(eng, 3)
    assert sched.n_slots == 3 and sched.config == ns.ServeConfig(n_slots=3)
    return [c.finish_reason for c in old]


def test_legacy_keyword_forms_warn_as_in_jax():
    """``serve(reqs, n_slots=...)`` and ``Scheduler(engine, 3)`` warn with a
    DeprecationWarning and serve as the config form; mixing the two forms
    is a TypeError, in both packages (sampled streams are the port's own,
    so only the shapes of the results are compared across packages)."""
    assert _both(_legacy) == ["length"] * 3


# ---------------------------------------------------------------------------
# the asyncio front end (held to the port's sync serve, itself held to JAX's)
# ---------------------------------------------------------------------------
def _sync_tokens(reqs, **sc):
    return [c.tokens for c in PORT.eng().serve(reqs, ServeConfig(**sc))]


def test_async_streams_match_sync_serve():
    reqs = _requests(PORT)
    sync = _streaming(JAX)[0]

    async def main():
        async with PORT.eng().serve_async(ServeConfig(n_slots=2)) as srv:
            ids = [srv.submit(r) for r in reqs]
            streams = await asyncio.gather(*[_collect(srv.tokens(i)) for i in ids])
            comps = await srv.drain()
        return ids, streams, comps

    async def _collect(agen):
        return [t async for t in agen]

    ids, streams, comps = asyncio.run(main())
    assert [c.index for c in comps] == ids
    assert [_comp(c) for c in comps] == sync  # timelines and steps included
    for c, stream in zip(comps, streams):
        assert stream == c.tokens


def test_async_cancel_mid_stream():
    reqs = _requests(PORT, lens=(4, 6), budgets=(10, 10))
    baseline = _sync_tokens(reqs, n_slots=2, block_size=4)

    async def main():
        async with PORT.eng().serve_async(ServeConfig(n_slots=2, block_size=4)) as srv:
            ids = [srv.submit(r) for r in reqs]
            got = []
            async for t in srv.tokens(ids[0]):
                got.append(t)
                if len(got) == 3:
                    assert await srv.cancel(ids[0])
            comps = await srv.drain()
            pool = srv.scheduler.pool
        return got, comps, pool

    got, comps, pool = asyncio.run(main())
    assert comps[0].finish_reason == "cancelled"
    assert comps[0].tokens[:3] == got[:3] == baseline[0][:3]
    assert comps[0].tokens == baseline[0][: len(comps[0].tokens)]
    assert comps[1].tokens == baseline[1]
    pool.check()
    assert pool.n_live == 0


def test_async_late_submission_joins_live_batch():
    reqs = _requests(PORT, lens=(3, 5), budgets=(8, 4))
    sync = _sync_tokens(reqs, n_slots=2)

    async def main():
        async with PORT.eng().serve_async(ServeConfig(n_slots=2)) as srv:
            i0 = srv.submit(reqs[0])
            first = []
            async for t in srv.tokens(i0):
                first.append(t)
                if len(first) == 2:
                    break
            i1 = srv.submit(reqs[1])
            c1 = await srv.result(i1)
            c0 = await srv.result(i0)
            late = srv.timeline(i1)
        return first, c0, c1, late

    first, c0, c1, late = asyncio.run(main())
    assert first == sync[0][:2] and c0.tokens == sync[0] and c1.tokens == sync[1]
    assert late[0][1] > 0  # submitted while request 0 was decoding
    assert c1.admitted_step < c0.finished_step  # and joined the live batch


def test_async_chunked_prefill_streams_identically():
    reqs = _requests(PORT, lens=(3, 12), budgets=(8, 4))
    sync = _sync_tokens(reqs, n_slots=2, block_size=4)

    async def main():
        async with PORT.eng().serve_async(ServeConfig(n_slots=2, block_size=4,
                                                      prefill_chunk=3)) as srv:
            for r in reqs:
                srv.submit(r)
            comps = await srv.drain()
            chunks = srv.scheduler.stats["prefill_chunks"]
        return comps, chunks

    comps, chunks = asyncio.run(main())
    assert chunks == 4
    assert [c.tokens for c in comps] == sync


def test_async_submit_requires_entered_engine():
    srv = AsyncServeEngine(PORT.eng(), ServeConfig(n_slots=1))
    with pytest.raises(RuntimeError, match="entered"):
        srv.submit(Request(tokens=np.asarray([1, 2, 3], np.int32)))


# ---------------------------------------------------------------------------
# the dispatch backends are per thread
# ---------------------------------------------------------------------------
def test_engines_on_two_threads_keep_their_own_backends(monkeypatch):
    """A 'kernel' engine and an 'unpack' engine serve at once from two
    threads.  A barrier holds both threads at their first packed layer,
    each having set its own backend, so with process-global backends one
    thread would resolve the other's route from then on.  Each thread must
    resolve only its own route at every packed layer, only the 'kernel'
    thread may call the kernel wrapper (whose plain version runs on the
    CPU), and each must give the tokens of its engine's serve on the main
    thread."""
    from repro_torch.models import quantized

    port, _ = _engines()
    tree = _ENG["tree"]
    engines = {}
    for name in ("kernel", "unpack"):
        dispatch.set_packed_backend(name)
        try:
            engines[name] = ServeEngine(port.cfg, tree, max_len=MAX_LEN,
                                        compute_dtype=torch.float32, device="cpu")
        finally:
            dispatch.set_packed_backend("auto")
    reqs = _requests(PORT)
    want = {n: [c.tokens for c in e.serve(reqs, ServeConfig(n_slots=2))]
            for n, e in engines.items()}
    routes = {"kernel": set(), "unpack": set()}
    kernel_calls = {"kernel": 0, "unpack": 0}
    barrier = threading.Barrier(2, timeout=60)
    first = threading.local()
    resolve, matmul = quantized.resolve_packed_backend, quantized.fixedpoint_matmul

    def counted_resolve(device):
        route = resolve(device)
        routes[threading.current_thread().name].add(route)
        if not getattr(first, "done", False):
            first.done = True
            barrier.wait()  # both threads are now past setting their backends
        return route

    def counted_matmul(*a, **k):
        kernel_calls[threading.current_thread().name] += 1
        return matmul(*a, **k)

    monkeypatch.setattr(quantized, "resolve_packed_backend", counted_resolve)
    monkeypatch.setattr(quantized, "fixedpoint_matmul", counted_matmul)
    got, errors = {}, []

    def run(name):
        try:
            got[name] = [c.tokens for c in engines[name].serve(reqs, ServeConfig(n_slots=2))]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n,), name=n) for n in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert routes == {"kernel": {"kernel"}, "unpack": {"unpack"}}
    assert kernel_calls["kernel"] > 0 and kernel_calls["unpack"] == 0
    assert got == want
