"""Port sampling (repro_torch.serve), on the CPU.

  - ``filter_logits`` (temperature + top-k) is allclose to the JAX package's,
    with the same -inf positions;
  - ``sample_uniform`` is splitmix64 (held to a pure-Python version), and
    ``sample_tokens`` over 20,000 stream ids of one 16-way logit row follows
    softmax(filter_logits) within 4 sigma per class, with no mass outside
    the top-k;
  - sampled ``serve()`` of reduced internlm2-1.8b (temperature 0.7, top-k 5,
    seed 123; mirrors tests/test_scheduler.py's sampling tests): the same
    streams across reruns, slot counts 2 / 3 / 5, staggered and reversed
    arrivals, a tight pool that preempts, and ``pack_tree`` vs
    ``quantize_tree`` params; another seed gives other streams;
  - greedy (temperature 0, top-k ignored) is still token-identical to JAX.
JAX draws with ``jax.random``, so sampled streams are held to this contract,
not to JAX's bits."""
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
from repro.serve.engine import filter_logits as j_filter_logits  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve import filter_logits, greedy_generate, sample_tokens  # noqa: E402
from repro_torch.serve.engine import sample_uniform  # noqa: E402

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


def _trees(kind):
    """(cfg, jax tree, port tree) of reduced internlm2 per param kind."""
    if kind not in _ENG:
        cfg = jconfigs.get_reduced("internlm2-1.8b")
        jp = j_init(jax.random.PRNGKey(0), cfg)
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        st = jcore.symog_init(jp, scfg)
        jp = (jcore.quantize_tree if kind == "quantize_tree" else jcore.pack_tree)(jp, st, scfg)
        _ENG[kind] = (cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    return _ENG[kind]


def _engine(kind="quantize_tree"):
    cfg, _, tp = _trees(kind)
    return ServeEngine(cfg, tp, max_len=MAX_LEN, compute_dtype=torch.float32, device="cpu")


def _requests(seed=0, lens=(3, 6, 4, 5, 7), budgets=(5, 3, 6, 4, 2)):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, 256, size=L).astype(np.int32), max_new_tokens=b)
            for L, b in zip(lens, budgets)]


def _streams(eng, reqs, **kw):
    return [c.tokens for c in eng.serve(reqs, ServeConfig(**kw))]


@pytest.mark.parametrize("temperature,top_k", [(0.7, 0), (0.7, 5), (1.3, 1), (0.5, 16)])
def test_filter_logits_matches_jax(temperature, top_k):
    x = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32) * 4
    x[1, 3] = x[1, 7]  # a tie at the k-th value keeps both, as in JAX
    want = np.asarray(j_filter_logits(jnp.asarray(x), temperature, top_k))
    got = filter_logits(torch.from_numpy(x), temperature, top_k).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def _splitmix_ref(seed: int, stream: int, v: int) -> float:
    """sample_uniform's entry (stream, v), in Python integers mod 2^64."""
    m = (1 << 64) - 1

    def mix(x):
        x &= m
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
        return x ^ (x >> 31)

    key = mix(((stream * 0x9E3779B97F4A7C15) & m) ^ mix(seed))
    return ((mix(key + (v + 1) * 0x9E3779B97F4A7C15) >> 41) * 2 + 1) * 2.0**-24


def test_sample_uniform_is_splitmix64():
    streams = torch.tensor([0, 1, 1_000_003, 2047 * 1_000_003 + 31, -5], dtype=torch.int64)
    u = sample_uniform(123, streams, 7)
    for b, s in enumerate(streams.tolist()):
        for v in range(7):
            assert u[b, v].item() == _splitmix_ref(123, s, v)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    # a row's draws depend on its stream id alone, not on the batch
    np.testing.assert_array_equal(sample_uniform(123, streams[2:3], 7).numpy(), u[2:3].numpy())
    assert not torch.equal(sample_uniform(124, streams, 7), u)


@pytest.mark.parametrize("top_k", [0, 5])
def test_sampler_follows_the_filtered_distribution(top_k):
    """20,000 draws (one stream id each) from one fixed 16-way logit row:
    every class's count within 4 sigma of n·p, p = softmax(filter_logits),
    and no draw outside the top-k."""
    n, temperature = 20_000, 0.7
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(16).astype(np.float32))
    streams = torch.arange(n, dtype=torch.int64) * 1_000_003 + 1
    tok = sample_tokens(logits.expand(n, 16), streams, 123, temperature, top_k)
    counts = np.bincount(tok.numpy(), minlength=16)
    p = torch.softmax(filter_logits(logits, temperature, top_k), -1).double().numpy()
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(counts - n * p) <= 4 * sigma + 1e-9), (counts, n * p)
    if top_k:
        assert counts[p == 0].sum() == 0 and (p > 0).sum() == top_k
    # greedy-like limit: the top class dominates at a tiny temperature
    cold = sample_tokens(logits.expand(64, 16), streams[:64], 123, 1e-6, 0)
    assert torch.all(cold == torch.argmax(logits))


def test_sampled_streams_invariant_to_admission_order_and_batch():
    """The (request, step)-keyed stream contract end to end: reruns, slot
    counts, arrival order and preemption replay change no sampled token."""
    eng = _engine()
    reqs = _requests()
    kw = dict(temperature=0.7, top_k=5, seed=123)
    base = _streams(eng, reqs, n_slots=2, **kw)
    assert [len(t) for t in base] == [r.max_new_tokens for r in reqs]
    assert base == _streams(eng, reqs, n_slots=2, **kw)
    assert base == _streams(eng, reqs, n_slots=3, **kw)
    assert base == _streams(eng, reqs, n_slots=5, **kw)
    staggered = [dataclasses.replace(r, arrival=4 * i) for i, r in enumerate(reqs)]
    assert base == _streams(eng, staggered, n_slots=2, **kw)
    reverse = [dataclasses.replace(r, arrival=4 * (len(reqs) - i)) for i, r in enumerate(reqs)]
    assert base == _streams(eng, reverse, n_slots=3, **kw)
    # pool pressure: a 6-block pool preempts the younger of two long
    # requests, whose restart replays the same stream
    longer = _requests(seed=2, lens=(8, 8, 5), budgets=(16, 16, 6))
    comps, sched = eng.serve(longer, ServeConfig(n_slots=2, block_size=4, n_blocks=6, **kw),
                             return_scheduler=True)
    assert sched.stats["preemptions"] >= 1
    assert [c.tokens for c in comps] == _streams(eng, longer, n_slots=2, block_size=4, **kw)
    # the draw is random: another seed moves the streams, and they are not greedy
    assert base != _streams(eng, reqs, n_slots=2, **dict(kw, seed=124))
    assert base != _streams(eng, reqs, n_slots=2)


def test_sampling_reproducible_across_packed_and_quantize_tree():
    kw = dict(n_slots=2, temperature=0.7, top_k=5, seed=123)
    reqs = _requests(seed=1)
    assert _streams(_engine("quantize_tree"), reqs, **kw) == _streams(_engine("pack_tree"), reqs,
                                                                       **kw)


def test_greedy_still_token_identical_to_jax():
    """temperature 0 is argmax whatever top_k says, in both packages, and
    greedy serves share one set of memoized steps whatever top_k says."""
    cfg, jp, tp = _trees("pack_tree")
    jeng = JEngine(cfg, jp, max_len=MAX_LEN, compute_dtype=jnp.float32)
    teng = _engine("pack_tree")
    reqs = _requests(seed=2)
    jc = jeng.serve([JRequest(tokens=r.tokens, max_new_tokens=r.max_new_tokens) for r in reqs],
                    JServeConfig(n_slots=2, top_k=5, seed=9))
    tc = _streams(teng, reqs, n_slots=2, top_k=5, seed=9)
    assert tc == [list(c.tokens) for c in jc]
    assert tc == _streams(teng, reqs, n_slots=2)
    assert set(teng._sched_fns) == {(True, 0)}
    batch = {"tokens": np.stack([r.tokens[:3] for r in reqs[:2]])}
    np.testing.assert_array_equal(
        greedy_generate(cfg, tp, batch, 4, MAX_LEN, torch.float32, "cpu").numpy(),
        teng.generate_static(batch, 4).numpy())
