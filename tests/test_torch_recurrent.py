"""Port parity for the recurrent families (repro_torch vs the JAX package):
mamba2's SSD block and recurrentgemma's RG-LRU block with local attention,
on the CPU in fp32.

  - ``ssd_scan_ref`` against JAX's and against the literal O(T) recurrence
    at several T / chunk; the SSD and RG-LRU blocks' full pass (with a
    bucketed ``seq_len`` and, for the RG-LRU, a carried ``h0``) and decode
    step against JAX's on the same weights; a decode step continuing a full
    pass equals the full pass one step longer; the RG-LRU state stays
    bounded over 512 steps;
  - the hybrid ring cache: window-sized k/v with a per-row ``kv_pos``, and
    ring decode past the window against JAX's ring decode and the forward;
  - reduced mamba2 and recurrentgemma (an RRL unit + an RR tail), 2-bit
    ``pack_tree`` params of the port's seeded ``init_lm`` packed by JAX's
    jitted ``symog_init`` + ``pack_tree``: forward, prefill (logits and
    every cache leaf), a bucketed prefill (caches equal to the exact-length
    prefill's) and dense decode against JAX's jitted functions at 1e-4;
    ``decode_lm`` with an inactive row keeps that row's states and caches;
  - the bridge carries JAX's trees (``units`` / ``tail`` groups, the (H,
    dh, dh) gate kernels as Packed leaves); the full configs' parameter
    counts from shapes alone (no memory: ``FakeTensorMode``).
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
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.packing import Packed  # noqa: E402
from repro_torch.models import (  # noqa: E402
    RGLRUConfig,
    SSDConfig,
    decode_lm,
    forward_lm,
    init_caches,
    init_lm,
    prefill_lm,
    rglru_block_apply,
    rglru_block_decode,
    rglru_init,
    scan_groups,
    ssd_block_apply,
    ssd_block_decode,
    ssd_init,
    ssd_scan_ref,
)
from repro_torch.models.rglru import _associative_scan  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths, tree_leaves  # noqa: E402

ARCHS = ["mamba2-2.7b", "recurrentgemma-2b"]
TOL = dict(rtol=1e-4, atol=1e-4)
T, MAX_LEN = 13, 32
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


def _to_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _tokens(cfg, B=2, T=T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _leaves(tree):
    """{path: float32 numpy} of a JAX or port cache tree."""
    if any(isinstance(v, torch.Tensor) for v in tree_leaves(tree)):
        return {p: _np(v) for p, v in flatten_with_paths(tree)}
    return {"/".join(str(k.key) for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# SSD and RG-LRU blocks
# ---------------------------------------------------------------------------
def _ssd_sequential(x, dt, A, Bm, Cm):
    """The literal O(T) recurrence, in fp64."""
    B, T_, H, P = x.shape
    h = np.zeros((B, H, P, Bm.shape[-1]), np.float64)
    ys = []
    for t in range(T_):
        a = np.exp(dt[:, t] * A)
        h = a[:, :, None, None] * h + dt[:, t, :, None, None] * (
            x[:, t, :, :, None] * Bm[:, t, None, None, :])
        ys.append(np.einsum("bhpN,bN->bhp", h, Cm[:, t]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("T_,chunk", [(16, 4), (24, 8), (8, 8), (12, 3)])
def test_ssd_scan_matches_jax_and_sequential(T_, chunk):
    rng = np.random.default_rng(T_ + chunk)
    B, H, P, N = 2, 3, 4, 5
    x = rng.standard_normal((B, T_, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, T_, H)))) * 0.5).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, T_, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T_, N)) * 0.5).astype(np.float32)
    y, h = ssd_scan_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=chunk)
    jy, jh = jax.jit(functools.partial(jssd.ssd_scan_ref, chunk=chunk))(x, dt, A, Bm, Cm)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    y_ref, h_ref = _ssd_sequential(*(a.astype(np.float64) for a in (x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=1e-4, atol=1e-5)


def test_ssd_block_matches_jax_and_decode_continues_full():
    cfg = SSDConfig(d_model=16, d_inner=32, n_heads=4, head_dim=8, d_state=8, conv_width=4,
                    chunk=4)
    gen = torch.Generator().manual_seed(3)
    p = ssd_init(gen, cfg)
    jp = _to_jax(p)
    u = (np.random.default_rng(1).standard_normal((2, 9, 16)) * 0.5).astype(np.float32)
    tu = torch.from_numpy(u)
    kw = dict(cfg=cfg, compute_dtype=torch.float32)
    jkw = dict(cfg=cfg, compute_dtype=jnp.float32)
    y_full, c_full = ssd_block_apply(p, tu, **kw)
    jy, jc = jax.jit(functools.partial(jssd.ssd_block_apply, **jkw))(jp, u)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(jy), **TOL)
    for n in ("h", "conv"):
        np.testing.assert_allclose(c_full[n].numpy(), np.asarray(jc[n]), **TOL)
    # a bucketed pass (9 tokens, 6 real) keeps the 6-token pass's cache
    y6, c6 = ssd_block_apply(p, tu[:, :6], **kw)
    yb, cb = ssd_block_apply(p, tu, seq_len=6, **kw)
    jyb, jcb = jax.jit(functools.partial(jssd.ssd_block_apply, **jkw))(jp, u, seq_len=6)
    np.testing.assert_allclose(yb.numpy(), np.asarray(jyb), **TOL)
    np.testing.assert_allclose(yb[:, :6].numpy(), y6.numpy(), **TOL)
    for n in ("h", "conv"):
        np.testing.assert_allclose(cb[n].numpy(), c6[n].numpy(), **TOL)
        np.testing.assert_allclose(cb[n].numpy(), np.asarray(jcb[n]), **TOL)
    # decode step 9 from the 8-step pass's cache == the 9-step pass
    _, c8 = ssd_block_apply(p, tu[:, :8], **kw)
    y9, c9 = ssd_block_decode(p, tu[:, 8:9], c8, **kw)
    jy9, jc9 = jax.jit(functools.partial(jssd.ssd_block_decode, **jkw))(
        jp, u[:, 8:9], {n: jnp.asarray(t.numpy()) for n, t in c8.items()})
    np.testing.assert_allclose(y9.numpy(), y_full[:, 8:9].numpy(), **TOL)
    np.testing.assert_allclose(y9.numpy(), np.asarray(jy9), **TOL)
    for n in ("h", "conv"):
        np.testing.assert_allclose(c9[n].numpy(), c_full[n].numpy(), **TOL)
        np.testing.assert_allclose(c9[n].numpy(), np.asarray(jc9[n]), **TOL)


def test_rglru_block_matches_jax_and_decode_continues_full():
    cfg = RGLRUConfig(d_model=16, d_rnn=32, n_heads=4, conv_width=4)
    p = rglru_init(torch.Generator().manual_seed(5), cfg)
    jp = _to_jax(p)
    x = (np.random.default_rng(2).standard_normal((2, 7, 16)) * 0.5).astype(np.float32)
    tx = torch.from_numpy(x)
    h0 = np.random.default_rng(4).standard_normal((2, 32)).astype(np.float32)
    kw = dict(cfg=cfg, compute_dtype=torch.float32)
    japply = jax.jit(functools.partial(jrglru.rglru_block_apply, cfg=cfg,
                                       compute_dtype=jnp.float32))
    for extra in ({}, {"seq_len": 5}, {"h0": h0}):
        y, c = rglru_block_apply(p, tx, **kw, **{k: (torch.from_numpy(v) if k == "h0" else v)
                                                for k, v in extra.items()})
        jy, jc = japply(jp, x, **extra)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for n in ("h", "conv"):
            np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **TOL)
    y_full, c_full = rglru_block_apply(p, tx, **kw)
    y6, c6 = rglru_block_apply(p, tx[:, :6], **kw)
    y7, c7 = rglru_block_decode(p, tx[:, 6:7], c6, **kw)
    jy7, _ = jax.jit(functools.partial(jrglru.rglru_block_decode, cfg=cfg,
                                       compute_dtype=jnp.float32))(
        jp, x[:, 6:7], {n: jnp.asarray(t.numpy()) for n, t in c6.items()})
    np.testing.assert_allclose(y7.numpy(), y_full[:, 6:7].numpy(), **TOL)
    np.testing.assert_allclose(y6.numpy(), y_full[:, :6].numpy(), **TOL)
    np.testing.assert_allclose(y7.numpy(), np.asarray(jy7), **TOL)
    np.testing.assert_allclose(c7["h"].numpy(), c_full["h"].numpy(), **TOL)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_associative_scan_matches_the_loop(n):
    """The log-depth scan equals the step-by-step recurrence, and JAX's
    ``associative_scan`` of the same combine."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 3)).astype(np.float32)
    _, h = _associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    ref, s = [], np.zeros((2, 3), np.float64)
    for t in range(n):
        s = a[:, t] * s + b[:, t]
        ref.append(s)
    np.testing.assert_allclose(h.numpy(), np.stack(ref, 1), rtol=1e-5, atol=1e-6)
    _, jh = jax.lax.associative_scan(lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
                                     (jnp.asarray(a), jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)


def test_rglru_stability():
    """Decay a in (0, 1): the state stays bounded over a long sequence."""
    cfg = RGLRUConfig(d_model=8, d_rnn=16, n_heads=2, conv_width=4)
    p = rglru_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 512, 8), generator=torch.Generator().manual_seed(1))
    y, cache = rglru_block_apply(p, x, cfg=cfg, compute_dtype=torch.float32)
    assert bool(torch.isfinite(y).all())
    assert float(cache["h"].abs().max()) < 1e3


# ---------------------------------------------------------------------------
# the ring cache (hybrid local attention)
# ---------------------------------------------------------------------------
def test_ring_cache_bounds_memory():
    cfg = tconfigs.get_reduced("recurrentgemma-2b")
    caches = init_caches(cfg, 2, 10_000, device="meta")
    jshapes = jax.eval_shape(lambda: j_init_caches(cfg, 2, 10_000))
    got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1]) for p, t in flatten_with_paths(caches)}
    want = {"/".join(str(k.key) for k in p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert got == want
    kv = [s for p, (s, _) in got.items() if p.endswith(("/k", "/v"))]
    assert kv and all(s[1] == cfg.window for s in kv), kv
    assert got["units/sub2/kv_pos"] == ((2, cfg.window), "int32")


@pytest.mark.parametrize("kv", ["bf16", "int8_fp"])
def test_ring_decode_past_window_matches_jax(kv):
    """24 decode steps from empty ring caches (window 8): the ring wraps
    three times; logits and caches equal JAX's ring decode, and on bf16
    caches track the windowed forward at JAX's bar for it (the caches round
    k/v to bf16; KV_F int8's grid of 2^-5 moves them further)."""
    cfg, jp, tp = _trees("recurrentgemma-2b")
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    Tn = 24
    tok = _tokens(cfg, B=1, T=Tn, seed=3)
    jc = j_init_caches(cfg, 1, Tn)
    tc = init_caches(cfg, 1, Tn, device="cpu")
    dec = _jit(j_decode, cfg=cfg, compute_dtype=jnp.float32)
    outs = []
    for t in range(Tn):
        jl, jc = dec(jp, jc, jnp.asarray(tok[:, t: t + 1]), jnp.int32(t))
        tl, tc = decode_lm(tp, tc, torch.from_numpy(tok[:, t: t + 1]), t, cfg,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        outs.append(tl.numpy()[:, 0])
    want, got = _leaves(jc), _leaves(tc)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], **TOL, err_msg=p)
    if kv == "bf16":
        ref = forward_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, compute_dtype=torch.float32)
        np.testing.assert_allclose(np.stack(outs, 1), ref.logits.numpy(), rtol=0.05, atol=5e-3)


# ---------------------------------------------------------------------------
# the models: forward, prefill, bucketed prefill, dense decode
# ---------------------------------------------------------------------------
def test_scan_groups_units_and_tail():
    want = {"mamba2-2.7b": [("layers0", ("M",), 3)],
            "recurrentgemma-2b": [("units", ("R", "R", "A"), 1), ("tail", ("R", "R"), 1)]}
    for arch, groups in want.items():
        got = [(g.name, g.unit, g.count) for g in scan_groups(tconfigs.get_reduced(arch))]
        assert got == groups
    full = scan_groups(tconfigs.get_config("recurrentgemma-2b"))
    assert [(g.name, g.count, g.offset, g.paged) for g in full] == [
        ("units", 8, 0, (False, False, True)), ("tail", 1, 24, (False, False))]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    cfg, jp, tp = _trees(arch)
    tok = _tokens(cfg)
    want = _jit(j_forward, cfg=cfg, compute_dtype=jnp.float32)(jp, {"tokens": jnp.asarray(tok)})
    got = forward_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), **TOL)

    jl, jc = _jit(j_prefill, cfg=cfg, max_len=MAX_LEN, compute_dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(tok)})
    tl, tc = prefill_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, max_len=MAX_LEN,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    want_c, got_c = _leaves(jc), _leaves(tc)
    assert set(got_c) == set(want_c)
    for p in want_c:
        np.testing.assert_allclose(got_c[p], want_c[p], **TOL, err_msg=p)

    # a bucketed prefill: the 13 tokens right-padded to 16, seq_len 13
    pad = np.concatenate([tok, np.zeros((tok.shape[0], 3), np.int32)], axis=1)
    bl, bc = prefill_lm(tp, {"tokens": torch.from_numpy(pad)}, cfg, max_len=MAX_LEN,
                        compute_dtype=torch.float32, seq_len=T)
    jbl, jbc = _jit(j_prefill, cfg=cfg, max_len=MAX_LEN, compute_dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(pad)}, seq_len=jnp.int32(T))
    np.testing.assert_allclose(bl.numpy(), tl.numpy(), **TOL)
    np.testing.assert_allclose(bl.numpy(), np.asarray(jbl), **TOL)
    bucket_c, jbucket_c = _leaves(bc), _leaves(jbc)
    for p, leaf in bucket_c.items():
        np.testing.assert_allclose(leaf, jbucket_c[p], **TOL, err_msg=p)
        ref = got_c[p]
        if p.endswith(("/k", "/v")):  # the padded tail's k/v lie past seq_len
            leaf, ref = leaf[..., :T, :, :], ref[..., :T, :, :]
        np.testing.assert_allclose(leaf, ref, **TOL, err_msg=p)

    dec = _jit(j_decode, cfg=cfg, compute_dtype=jnp.float32)
    steps = _tokens(cfg, T=3, seed=2)
    for i in range(3):
        cur = steps[:, i: i + 1]
        jl, jc = dec(jp, jc, jnp.asarray(cur), jnp.int32(T + i))
        tl, tc = decode_lm(tp, tc, torch.from_numpy(cur), T + i, cfg, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for p, leaf in _leaves(jc).items():
        np.testing.assert_allclose(_leaves(tc)[p], leaf, **TOL, err_msg=p)


@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_row_is_frozen(arch):
    """``active`` (B,) without block tables: the inactive row's resident
    states, conv windows and dense k/v stay as they were (JAX's
    ``_gate_cache``), the active row's equal JAX's."""
    cfg, jp, tp = _trees(arch)
    tok = _tokens(cfg)
    jl, jc = _jit(j_prefill, cfg=cfg, max_len=MAX_LEN, compute_dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(tok)})
    _, tc = prefill_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, max_len=MAX_LEN,
                       compute_dtype=torch.float32)
    before = _leaves(tc)
    active = np.asarray([True, False])
    pos = np.asarray([T, T], np.int32)
    dec = _jit(j_decode, cfg=cfg, compute_dtype=jnp.float32)
    for i in range(2):
        cur = _tokens(cfg, T=1, seed=7 + i)
        jl, jc = dec(jp, jc, jnp.asarray(cur), jnp.asarray(pos + i), active=jnp.asarray(active))
        tl, tc = decode_lm(tp, tc, torch.from_numpy(cur), torch.from_numpy(pos + i), cfg,
                           compute_dtype=torch.float32, active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **TOL)
    after, want = _leaves(tc), _leaves(jc)
    for p in before:
        stacked = next(g for g in scan_groups(cfg) if p.startswith(g.name)).stacked
        b_axis = 1 if stacked else 0  # the batch axis after a stacked layer axis
        np.testing.assert_array_equal(np.take(after[p], 1, axis=b_axis),
                                      np.take(before[p], 1, axis=b_axis), err_msg=p)
        np.testing.assert_allclose(after[p], want[p], **TOL, err_msg=p)


# ---------------------------------------------------------------------------
# the bridge and the full configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_jax_trees(arch):
    """JAX's own init and pack_tree bridge into the port's layout: same
    paths and shapes as the port's init, Packed where JAX packed (the RG-LRU
    gate kernels (H, dh, dh) among them), and the port's forward on the
    bridged tree equals JAX's."""
    cfg = jconfigs.get_reduced(arch)
    jparams = jax.jit(lambda k: j_init_lm(k, cfg))(jax.random.PRNGKey(1))
    scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
    jpk = jax.jit(lambda p: jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg))(jparams)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpk))
    own = {p: tuple(t.shape) for p, t in flatten_with_paths(init_lm(0, cfg, device="cpu"))}
    got = {p: tuple(t.shape) for p, t in flatten_with_paths(tp)}
    assert got == own
    packed = {p for p, t in flatten_with_paths(tp) if isinstance(t, Packed)}
    if arch == "recurrentgemma-2b":
        assert {"units", "tail"} <= set(tp)
        assert "units/sub0/rglru/rg_lru/a_gate/kernel" in packed
        assert "units/sub0/rglru/rg_lru/a_param" not in packed
    else:
        assert "layers0/sub0/ssd/in_proj_dt/kernel" in packed
        assert not any(p.endswith(("A_log", "ssm_D", "dt_bias")) for p in packed)
    tok = _tokens(cfg, T=6)
    want = _jit(j_forward, cfg=cfg, compute_dtype=jnp.float32)(jpk, {"tokens": jnp.asarray(tok)})
    out = forward_lm(tp, {"tokens": torch.from_numpy(tok)}, cfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(want.logits), **TOL)


def test_full_config_param_counts():
    """The full configs' parameter counts from the port's init, shapes only
    (``FakeTensorMode`` allocates nothing), equal JAX's ``eval_shape`` of its
    init and the published scale."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    expect = {"mamba2-2.7b": (2.2e9, 3.2e9), "recurrentgemma-2b": (2.2e9, 3.2e9)}
    for arch, (lo, hi) in expect.items():
        cfg = tconfigs.get_config(arch)
        with FakeTensorMode():
            n = sum(t.numel() for t in tree_leaves(init_lm(0, cfg, device="cpu")))
        shapes = jax.eval_shape(lambda: j_init_lm(jax.random.PRNGKey(0), jconfigs.get_config(arch)))
        assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
        assert lo <= n <= hi, (arch, n)
