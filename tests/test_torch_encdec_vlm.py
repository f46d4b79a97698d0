"""Port parity for the encoder-decoder and VLM families (repro_torch vs the
JAX package): reduced whisper-large-v3 and paligemma-3b on the CPU, fp32,
2-bit ``pack_tree`` params of the port's seeded ``init_lm`` packed by JAX's
jitted ``symog_init`` + ``pack_tree``; JAX's functions jitted.

  - ``make_mask`` under every clause (causal or not, window, image prefix,
    ``kv_valid``) equals JAX's;
  - ``sinusoidal_pos`` and the decode step's position embedding against
    JAX's jitted ones: the divisors 10000^(2i/D) bit-equal, the sines and
    cosines within 1e-6 (torch's and XLA's sin / cos differ by an ulp on
    about one value in twenty);
  - forward, prefill (exact and bucketed with ``seq_len``: the prefix-LM
    mask holds under the padding) and dense and paged ``decode_lm`` (an
    inactive row, the cross-kv resident beside the paged pools) within
    1e-4; whisper's cross-kv leaves bf16 and equal to JAX's but where an
    fp32 value within 1e-6 of JAX's rounds to the neighbouring bf16 value
    (one bf16 ulp, on a few entries in a thousand);
  - ``init_caches`` (and its ``prefill`` layout) trees, shapes and dtypes
    equal JAX's ``init_caches`` (and ``eval_shape`` of its prefill) under
    bf16 and int8_fp: the cross-kv in the cache dtype, int8 under int8_fp,
    but bf16 in a prefill's caches;
  - JAX's own whisper / paligemma trees bridge into the port's layout (the
    encoder groups, the rank-2 attention biases left float), and the full
    configs' parameter counts equal JAX's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models import decode_lm as j_decode  # noqa: E402
from repro.models import forward_lm as j_forward  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.models import init_lm as j_init_lm  # noqa: E402
from repro.models import prefill_lm as j_prefill  # noqa: E402
from repro.models.attention import make_mask as j_make_mask  # noqa: E402
from repro.models.layers import sinusoidal_pos as j_sinusoidal_pos  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.packing import Packed  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import decode_lm, forward_lm, init_caches, init_lm, prefill_lm  # noqa: E402
from repro_torch.models.attention import make_mask  # noqa: E402
from repro_torch.models.layers import _sin_divisors, sinusoidal_angles, sinusoidal_pos  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths, tree_leaves  # noqa: E402

ARCHS = ["whisper-large-v3", "paligemma-3b"]
TOL = dict(rtol=1e-4, atol=1e-4)
T, MAX_LEN, BLOCK = 9, 32, 4
_TREES = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(arch):
    """(cfg, jax tree, port tree): the 2-bit pack_tree of a seeded init."""
    if arch not in _TREES:
        cfg = jconfigs.get_reduced(arch)
        own = init_lm(0, cfg, device="cpu")
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        jp = jax.jit(lambda p: jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg))(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own))
        _TREES[arch] = (cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    return _TREES[arch]


def _jit(fn, **bound):
    return jax.jit(functools.partial(fn, **bound))


def _offset(cfg):
    return cfg.prefix_len if cfg.family == "vlm" else 0


def _batch(cfg, B=2, T=T, seed=0):
    """Tokens (B, T) and the family's extras, numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = (rng.standard_normal((B, cfg.encoder_len, cfg.d_model)) * 0.1).astype(
            np.float32)
    else:
        b["patches"] = (rng.standard_normal((B, cfg.prefix_len, cfg.d_model)) * 0.1).astype(
            np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()})


def _paths(tree):
    return {p: t for p, t in flatten_with_paths(tree)}


def _jpaths(tree):
    return {"/".join(str(k.key) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bf16_ulp(a, b, err_msg=""):
    """bf16 values equal but where fp32 inputs within 1e-6 of each other
    rounded to neighbouring bf16 values: at most one bf16 ulp apart, and
    on fewer than one entry in a hundred."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), np.abs(b)) + 1e-30)) - 7)
    assert (np.abs(a - b) <= ulp).all(), err_msg
    assert (a != b).mean() < 0.01, err_msg


def _check_caches(got, want):
    """Every leaf's path, dtype and value: float leaves within TOL; the
    bf16 cross-kv (whisper) within a bf16 ulp."""
    got, want = _paths(got), _jpaths(want)
    assert set(got) == set(want)
    for p, t in got.items():
        assert str(t.dtype).split(".")[-1] == str(want[p].dtype), p
        a, b = t.float().numpy(), np.asarray(want[p], np.float32)
        if t.dtype == torch.bfloat16:
            _assert_bf16_ulp(a, b, err_msg=p)
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=p)


# ---------------------------------------------------------------------------
# masks and positions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,prefix_len,valid", [
    (True, None, 0, False), (False, None, 0, False), (True, 3, 0, False),
    (True, None, 5, False), (True, 3, 5, True), (False, 2 ** 30, 0, True)])
def test_make_mask_matches_jax(causal, window, prefix_len, valid):
    rng = np.random.default_rng(3)
    q_pos = np.sort(rng.integers(0, 16, size=(3, 6)), axis=1).astype(np.int32)
    kv_pos = np.tile(np.arange(16, dtype=np.int32), (3, 1))
    kv_valid = rng.random((3, 16)) < 0.7 if valid else None
    kw = dict(causal=causal, window=window, prefix_len=prefix_len)
    want = j_make_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                       kv_valid=None if kv_valid is None else jnp.asarray(kv_valid), **kw)
    got = make_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                    kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,D", [(12, 32), (40, 32), (1500, 1280)])
def test_sinusoids_match_jitted_jax(S, D):
    """The encoder's table and the decode step's per-row embedding, each
    against the JAX package's jitted expression (lm.py's decode form
    copied here).  XLA folds the decode form's constant divisors into
    reciprocals, the port too: its angles there are products, the table's
    quotients, and the two may round an ulp apart; at 1,280 lanes XLA's
    folded divisors are not the C library's either, so the decode form is
    held to JAX's at the reduced width alone (positions < 40: a serve's)."""
    i = jnp.arange(D // 2, dtype=jnp.float32)
    jdiv = jax.jit(lambda i: jnp.power(10000.0, 2 * i / D))(i)
    np.testing.assert_array_equal(_sin_divisors(D, torch.device("cpu")).numpy(), np.asarray(jdiv))
    want = jax.jit(j_sinusoidal_pos, static_argnums=(0, 1))(S, D)
    got = sinusoidal_pos(S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    def j_decode_pe(pos_v):  # src/repro/models/lm.py, decode_lm's encdec branch
        ang = pos_v[:, None].astype(jnp.float32) / jnp.power(10000.0, 2 * i / D)[None, :]
        return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)[:, None, :]

    if D > 32:
        return
    pos = np.arange(S, dtype=np.int32)
    want_pe = jax.jit(j_decode_pe)(jnp.asarray(pos))
    got_pe = sinusoidal_angles(torch.from_numpy(pos)[:, None], D, reciprocal=True)
    np.testing.assert_allclose(got_pe.numpy(), np.asarray(want_pe), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    cfg, jp, tp = _trees(arch)
    off = _offset(cfg)
    max_len = MAX_LEN + off
    jb, tb = _both(_batch(cfg))
    want = _jit(j_forward, cfg=cfg, compute_dtype=jnp.float32)(jp, jb).logits
    got = forward_lm(tp, tb, cfg, compute_dtype=torch.float32)
    assert got.logits.shape == (2, T, cfg.vocab_size)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), **TOL)

    jl, jc = _jit(j_prefill, cfg=cfg, max_len=max_len, compute_dtype=jnp.float32)(jp, jb)
    tl, tc = prefill_lm(tp, tb, cfg, max_len=max_len, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_caches(tc, jc)
    if cfg.family == "encdec":
        assert {t.dtype for p, t in _paths(tc).items() if "cross" in p} == {torch.bfloat16}

    # paged pools (every row's positions from the prefix on) from the same
    # prefill caches, before the dense steps update those caches in place
    B, nb = 2, max_len // BLOCK
    bt = (np.random.default_rng(4).permutation(B * nb) + 1).reshape(B, nb).astype(np.int32)
    pools = {}
    for name, dense in _jpaths(jc).items():
        dense = np.asarray(dense)
        if name.endswith(("/k", "/v")):  # (L, B, max_len, K, hd) -> (L, n_phys, block, K, hd)
            pool = np.zeros((dense.shape[0], B * nb + 1, BLOCK) + dense.shape[3:], np.float32)
            for b in range(B):
                pool[:, bt[b]] = dense[:, b].reshape(dense.shape[0], nb, BLOCK, *dense.shape[3:])
            pools[name] = pool
        else:  # the cross-kv: resident rows, as the serving pool keeps them
            pools[name] = dense

    steps = _batch(cfg, T=3, seed=2)["tokens"]
    dec = _jit(j_decode, cfg=cfg, compute_dtype=jnp.float32)
    for i in range(3):
        cur = steps[:, i: i + 1]
        jl, jc = dec(jp, jc, jnp.asarray(cur), jnp.int32(off + T + i))
        tl, tc = decode_lm(tp, tc, torch.from_numpy(cur), off + T + i, cfg,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_caches(tc, jc)

    def nest(flat, conv):
        out = {}
        for p, a in flat.items():
            g, sub, n = p.split("/")
            out.setdefault(g, {}).setdefault(sub, {})[n] = conv(a)
        return out

    pos = np.asarray([off + T, off + T - 3], np.int32)
    active = np.asarray([True, False])
    jcache = nest(pools, jnp.asarray)
    want = []
    for i in range(3):
        jl, jcache = dec(jp, jcache, jnp.asarray(steps[:, i: i + 1]), jnp.asarray(pos + i),
                         active=jnp.asarray(active), block_tables=jnp.asarray(bt))
        want.append(np.asarray(jl))
    for backend in ("composed", "fused"):
        tcache = nest(pools, lambda a: torch.from_numpy(np.array(a)) if a.dtype != jnp.bfloat16
                      else torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16))
        dispatch.set_attention_backend(backend)
        try:
            for i in range(3):
                tl, tcache = decode_lm(tp, tcache, torch.from_numpy(steps[:, i: i + 1]),
                                       torch.from_numpy(pos + i), cfg,
                                       compute_dtype=torch.float32,
                                       active=torch.from_numpy(active),
                                       block_tables=torch.from_numpy(bt))
                np.testing.assert_allclose(tl.numpy(), want[i], **TOL)
        finally:
            dispatch.set_attention_backend("auto")
        _check_caches(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_prefill_matches_jax_and_exact(arch):
    """A prompt of 5 tokens padded to its bucket of 8 with ``seq_len`` 5:
    the logits at the last real token and the caches of the real positions
    equal the exact-length prefill's and JAX's bucketed prefill.  For
    paligemma the image prefix sees the whole prefix and no text (the
    prefix-LM clause comes before any padding)."""
    cfg, jp, tp = _trees(arch)
    max_len = MAX_LEN + _offset(cfg)
    b = _batch(cfg, B=1, T=5, seed=6)
    padded = dict(b, tokens=np.pad(b["tokens"], ((0, 0), (0, 3))))
    jb, tb = _both(padded)
    jl, jc = _jit(j_prefill, cfg=cfg, max_len=max_len, compute_dtype=jnp.float32)(
        jp, jb, seq_len=jnp.int32(5))
    tl, tc = prefill_lm(tp, tb, cfg, max_len=max_len, compute_dtype=torch.float32, seq_len=5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_caches(tc, jc)
    el, ec = prefill_lm(tp, _both(b)[1], cfg, max_len=max_len, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), el.numpy(), **TOL)
    real = _offset(cfg) + 5
    for p, t in _paths(tc).items():
        if p.endswith(("/k", "/v")):
            np.testing.assert_allclose(t[:, :, :real].numpy(), _paths(ec)[p][:, :, :real].numpy(),
                                       **TOL, err_msg=p)


@pytest.mark.parametrize("kv", ["bf16", "int8_fp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_jax(arch, kv):
    cfg = dataclasses.replace(tconfigs.get_reduced(arch), kv_cache_dtype=kv)
    max_len = MAX_LEN + _offset(cfg)

    def spec(tree):
        return {p: (tuple(t.shape), str(t.dtype).split(".")[-1]) for p, t in _paths(tree).items()}

    def jspec(tree):
        return {p: (tuple(v.shape), str(v.dtype)) for p, v in _jpaths(tree).items()}

    got = spec(init_caches(cfg, 3, max_len, device="meta"))
    assert got == jspec(jax.eval_shape(lambda: j_init_caches(cfg, 3, max_len)))
    if cfg.family == "encdec":
        want = "int8" if kv == "int8_fp" else "bfloat16"
        assert {d for p, (_, d) in got.items() if "cross" in p} == {want}
    b = _batch(cfg, B=1, T=1)
    jshapes = jax.eval_shape(
        lambda p, b: j_prefill(p, b, cfg, max_len=max_len, compute_dtype=jnp.bfloat16)[1],
        jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(t.shape, jnp.float32),
                               init_lm(0, cfg, device="cpu")),
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in b.items()})
    pre = spec(init_caches(cfg, 1, max_len, torch.bfloat16, device="meta", prefill=True))
    assert pre == jspec(jshapes)
    if cfg.family == "encdec":
        assert {d for p, (_, d) in pre.items() if "cross" in p} == {"bfloat16"}


# ---------------------------------------------------------------------------
# the bridge and the full configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_jax_trees(arch):
    """JAX's own init and pack_tree bridge into the port's layout: same
    paths and shapes as the port's init, Packed where JAX packed (never a
    bias: whisper's q / k / v biases are rank 2, (H, hd), rank 3 stacked),
    and the port's forward on the bridged tree equals JAX's."""
    cfg = jconfigs.get_reduced(arch)
    jparams = jax.jit(lambda k: j_init_lm(k, cfg))(jax.random.PRNGKey(1))
    scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
    jpk = jax.jit(lambda p: jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg))(jparams)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpk))
    own = {p: tuple(t.shape) for p, t in flatten_with_paths(init_lm(0, cfg, device="cpu"))}
    got = {p: tuple(t.shape) for p, t in flatten_with_paths(tp)}
    assert got == own
    packed = {p for p, t in flatten_with_paths(tp) if isinstance(t, Packed)}
    assert not any(p.endswith("bias") for p in packed)
    if arch == "whisper-large-v3":
        assert {"encoder", "enc_final_norm"} <= set(tp)
        assert got["layers0/sub0/cross_attn/q_proj/bias"] == (cfg.n_layers, cfg.n_heads,
                                                              cfg.head_dim)
        assert {"encoder/layers0/sub0/attn/q_proj/kernel", "layers0/sub0/cross_attn/k_proj/kernel",
                "layers0/sub0/mlp/fc1/kernel"} <= packed
        assert not any("cross" in p for p in got if p.startswith("encoder/"))
    else:
        assert "layers0/sub0/mlp/gate_proj/kernel" in packed
    jb, tb = _both(_batch(cfg, T=6))
    want = _jit(j_forward, cfg=cfg, compute_dtype=jnp.float32)(jpk, jb)
    out = forward_lm(tp, tb, cfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(want.logits), **TOL)


def test_full_config_param_counts():
    """The full configs' parameter counts from the port's init, shapes only
    (``FakeTensorMode`` allocates nothing), equal JAX's ``eval_shape`` of its
    init and the published scale."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    expect = {"whisper-large-v3": (1.4e9, 1.8e9), "paligemma-3b": (2.4e9, 3.2e9)}
    for arch, (lo, hi) in expect.items():
        cfg = tconfigs.get_config(arch)
        with FakeTensorMode():
            n = sum(t.numel() for t in tree_leaves(init_lm(0, cfg, device="cpu")))
        shapes = jax.eval_shape(lambda: j_init_lm(jax.random.PRNGKey(0), jconfigs.get_config(arch)))
        assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
        assert lo <= n <= hi, (arch, n)
