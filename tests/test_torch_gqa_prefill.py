"""The paged GQA kernel's prefill form (``csrc/gqa_prefill.cu``) on the CPU:
what can be held here without the card.

  * the route rule (``ops._gqa_route``): the tensor-core prefill kernel only
    for bf16 queries over pools exact in bf16, hd a multiple of 16 up to 256,
    block a multiple of 16, aligned pools and T·G at the threshold; fp32
    queries and fp32 pools stay on ``gqa_decode``; a forced 'prefill' the rule
    refuses raises on either device;
  * the tile walk: a Python mirror of the kernel's per-query-tile key-tile
    range, the 16-token sub-tiles it reads and its cut over a cluster's
    ranks, over ragged pos0 (0, mid-block, the table's last slot), windows
    None / 7 / 64, G 1 / 2 / 8 and T·G across the 64-row tile's edges: every
    key a row sees is read, every key left out is masked for every row, and
    the ranks partition the range in order;
  * the numerics: a plain-torch model of the kernel's one rounding change
    (K and V as bf16 tiles, exact; the online softmax over 64-key tiles with
    p in two bf16 parts, p_hi + p_lo) held to ``paged_attention_ref`` at the
    bf16 bar on reduced copies of every tail-prefill case of chip_smoke.py
    phase 3e, the wide-exponent int8 / int4 pools too; with one bf16 p
    instead, a wide-exponent pool misses the bar, which is why the kernel
    keeps two;
  * the port's plain version against JAX's Pallas kernel in interpret mode
    at the route's shapes (T 32 and 64, G 2, window, softcap, int8 / int4
    SYMOG pools, pos0 mid-block) at the fp32 bar of
    tests/test_torch_paged_attention.py.

The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py ``-k prefill``; chip_smoke.py phase 3e)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro_torch.kernels.paged_attention import ops, paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    dequant_logical,
    gather_logical,
    paged_attention_ref,
)
from repro_torch.models.attention import (  # noqa: E402
    KV_QMAX,
    block_scale_exp,
    pack_int4,
    quantize_fixed,
)

BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # chip_smoke.py ATTN_TOL["bfloat16"]
F32_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_paged_attention.py


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
BF, F32 = torch.bfloat16, torch.float32
N = ops.PREFILL_MIN_ROWS


@pytest.mark.parametrize("q_dtype,code,kv_scale,hd,block,TG,aligned,want", [
    (BF, 4, 1.0, 256, 16, 4096, True, "prefill"),  # gemma3's admission, int4 words
    (BF, 3, 1.0, 128, 16, 512, True, "prefill"),  # int8 words
    (BF, 1, 1.0, 128, 16, N, True, "prefill"),  # bf16 pool at the threshold
    (BF, 1, 1.0, 128, 16, N - 1, True, "decode"),  # one row short of it
    (BF, 1, 0.5, 128, 16, 512, True, "decode"),  # a bf16 pool under a scale: not exact
    (BF, 2, 2.0**-5, 64, 32, 512, True, "prefill"),  # KV_F under a power of two
    (BF, 2, 0.3, 64, 32, 512, True, "decode"),  # KV_F under another scale
    (BF, 0, 1.0, 128, 16, 512, True, "decode"),  # fp32 pool
    (F32, 4, 1.0, 256, 16, 4096, True, "decode"),  # fp32 queries (the parity phases)
    (F32, 1, 1.0, 128, 16, 512, True, "decode"),
    (BF, 4, 1.0, 72, 16, 512, True, "decode"),  # hd not a multiple of 16
    (BF, 4, 1.0, 8, 16, 512, True, "decode"),
    (BF, 4, 1.0, 16, 16, 512, True, "prefill"),
    (BF, 4, 1.0, 272, 16, 512, True, "decode"),  # hd above 256
    (BF, 4, 1.0, 128, 8, 512, True, "decode"),  # a 16-key step would straddle blocks
    (BF, 4, 1.0, 128, 20, 512, True, "decode"),
    (BF, 4, 1.0, 128, 64, 512, True, "prefill"),
    (BF, 1, 1.0, 128, 16, 512, False, "decode"),  # pools not 8-byte aligned
])
def test_route_rule(q_dtype, code, kv_scale, hd, block, TG, aligned, want):
    assert ops._gqa_route(q_dtype, code, kv_scale, hd, block, TG, aligned) == want


def _pools(rng, n_blocks, block, K, hd, pool, wide=False):
    """k / v pools and the call's keywords: 'bf16', 'kv_f' (int8 x 2^-5),
    'q8' / 'q4' (SYMOG words: ``wide`` random mantissas under exponents in
    [-8, 4], else the pools a paged write makes of unit-scale k / v, values
    N(0,1)·2^s with s in [-3, 1] per (block, head))."""
    if pool in ("bf16", "fp32", "kv_f"):
        kp, vp = (torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd))
                                   .astype(np.float32)) for _ in range(2))
        if pool == "kv_f":
            kp, vp = (torch.clamp(torch.round(x * 32), -127, 127).to(torch.int8) for x in (kp, vp))
            return kp, vp, dict(kv_scale=2.0**-5)
        dt = BF if pool == "bf16" else F32
        return kp.to(dt), vp.to(dt), {}
    bits = 8 if pool == "q8" else 4
    qmax = KV_QMAX[bits]
    pools, exps = [], []
    for _ in range(2):
        if wide:
            m = torch.from_numpy(rng.integers(-qmax, qmax + 1, size=(n_blocks, block, K, hd))
                                 .astype(np.int8))
            e = torch.from_numpy(rng.integers(-8, 5, size=(n_blocks, K)).astype(np.int32))
        else:
            s = rng.integers(-3, 2, size=(n_blocks, 1, K, 1)).astype(np.float32)
            x = torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd))
                                 .astype(np.float32) * np.exp2(s))
            e = block_scale_exp(x[:, 0], qmax)
            m = quantize_fixed(x, e[:, None], qmax)
        pools.append(pack_int4(m) if bits == 4 else m)
        exps.append(e)
    return pools[0], pools[1], dict(k_scale_exp=exps[0], v_scale_exp=exps[1], kv_bits=bits)


def _call(seed, *, T, G, pool, B=1, K=2, hd=64, block=16, pos0=0, wide=False, q_mult=1.0):
    """A case's operands: queries, pools, a shuffled block table over the
    rows' tokens (its spare entries on the trash block 0) and pos0."""
    rng = np.random.default_rng(seed)
    mb = -(-(pos0 + T) // block) + 1
    n_blocks = B * mb + 1
    bt = (rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb).astype(np.int32)
    q = torch.from_numpy((rng.standard_normal((B, T, K, G, hd)) * q_mult).astype(np.float32))
    kp, vp, kw = _pools(rng, n_blocks, block, K, hd, pool, wide)
    p0 = torch.full((B,), pos0, dtype=torch.int32)
    return q.to(BF), kp, vp, torch.from_numpy(bt), p0, kw


def test_forced_route_is_checked_on_either_device():
    q, kp, vp, bt, pos0, kw = _call(0, T=32, G=2, pool="q4")
    base = dict(scale=0.125, window=None, **kw)
    want = paged_attention(q, kp, vp, bt, pos0, **base)
    assert ops._gqa_route(q.dtype, 4, 1.0, 64, 16, 64) == "prefill"
    for route in ("prefill", "decode"):  # the CPU runs the plain version either way
        assert torch.equal(paged_attention(q, kp, vp, bt, pos0, _route=route, **base), want)
    with pytest.raises(ValueError):  # fp32 queries stay on gqa_decode
        paged_attention(q.float(), kp, vp, bt, pos0, _route="prefill", **base)
    with pytest.raises(ValueError):  # too few rows a KV head
        paged_attention(q[:, :1], kp, vp, bt, pos0, _route="prefill", **base)
    fp = _call(1, T=32, G=2, pool="fp32")
    with pytest.raises(ValueError):  # an fp32 pool is not exact in bf16
        paged_attention(*fp[:5], scale=0.125, _route="prefill")
    with pytest.raises(ValueError):
        paged_attention(q, kp, vp, bt, pos0, _route="tensor_core", **base)
    assert ops.prefill_launches == ops.prefill_quant_launches == 0  # CPU calls never count


# ---------------------------------------------------------------------------
# the tile walk
# ---------------------------------------------------------------------------
def test_prefill_split_rule():
    assert ops._prefill_split(1, 4, 8, 128, 16, 132) == 4  # a 256-row chunk of gemma3
    assert ops._prefill_split(1, 4, 64, 128, 16, 132) == 1  # T 2048: the tiles fill the card
    assert ops._prefill_split(1, 4, 16, 128, 16, 132) == 2
    assert ops._prefill_split(1, 4, 1, 2, 16, 132) == 1  # one key tile: nothing to split
    assert ops._prefill_split(1, 4, 1, 8, 16, 132) == 2  # two key tiles
    for args in [(1, 1, 1, 1000, 16, 132), (4, 8, 3, 64, 32, 132), (2, 4, 40, 300, 16, 8)]:
        s = ops._prefill_split(*args)
        assert s in (1, 2, 4) and (s == 1 or s * args[0] * args[1] * args[2] <= args[5])


@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("TG", [63, 64, 65, 200])
@pytest.mark.parametrize("window", [None, 7, 64])
@pytest.mark.parametrize("where", ["zero", "mid_block", "last_slot"])
def test_tile_walk_covers_every_visible_key_once(G, TG, window, where):
    block, max_blocks = 16, 24
    n_tok = max_blocks * block
    T = -(-TG // G)
    pos0 = {"zero": 0, "mid_block": 8 * block + 5, "last_slot": n_tok - 1}[where]
    w = ops._NO_WINDOW if window is None else window
    n_tiles = -(-n_tok // ops.PREFILL_KEYS)
    for row0 in range(0, TG, ops.PREFILL_ROWS):
        rows = min(ops.PREFILL_ROWS, TG - row0)
        v_lo, v_hi = ops.prefill_key_tiles(pos0, G, row0, rows, w, block, max_blocks)
        read = set()
        for v in range(v_lo, v_hi):
            t_lo, t_hi = ops.prefill_read_tokens(pos0, G, row0, rows, w, block, max_blocks, v)
            assert 0 <= t_lo < t_hi <= ops.PREFILL_KEYS and t_lo % 16 == 0 and t_hi % 16 == 0
            read |= {v * ops.PREFILL_KEYS + t for t in range(t_lo, t_hi)}
        assert all(k < n_tok for k in read)  # nothing past the table
        seen = set()
        for r in range(row0, row0 + rows):
            q_pos = pos0 + min(r, T * G - 1) // G
            seen |= set(range(max(0, q_pos - w + 1), min(q_pos, n_tok - 1) + 1))
        assert seen <= read  # every key some row sees is read
        # a skipped tile, and a sub-tile left out of a read one, is masked for every row
        for v in set(range(n_tiles)) - set(range(v_lo, v_hi)):
            assert not seen & set(range(v * ops.PREFILL_KEYS, (v + 1) * ops.PREFILL_KEYS))
        for n_split in (1, 2, 4):
            shares = ops.prefill_rank_tiles(v_lo, v_hi, n_split)
            assert shares[0][0] == v_lo and shares[-1][1] == v_hi
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))  # contiguous, in order
            sizes = [b - a for a, b in shares]
            assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


# ---------------------------------------------------------------------------
# the numerics: the kernel's rounding of p, modelled in torch
# ---------------------------------------------------------------------------
def _kernel_model(q, kp, vp, bt, pos0, *, scale, cap=0.0, window=None, kv_scale=1.0,
                  k_scale_exp=None, v_scale_exp=None, kv_bits=0, parts=2):
    """gqa_prefill's arithmetic: K and V as bf16 tiles (exact: every value of
    an eligible pool is), bf16 queries, S in fp32, the online softmax over
    64-key tiles (natural-unit logits, p = 2^((x - m)·log2 e)) with p rounded
    to ``parts`` bf16 parts for the
    p . V product (fp32 accumulation), out = acc / l rounded to bf16."""
    if k_scale_exp is not None:
        k = dequant_logical(kp, k_scale_exp, bt, kv_bits=kv_bits)
        v = dequant_logical(vp, v_scale_exp, bt, kv_bits=kv_bits)
    else:
        k = gather_logical(kp, bt).float() * kv_scale
        v = gather_logical(vp, bt).float() * kv_scale
    assert torch.equal(k.to(BF).float(), k) and torch.equal(v.to(BF).float(), v)
    B, T, K, G, hd = q.shape
    S = k.shape[1]
    w = ops._NO_WINDOW if window is None else window
    q_pos = pos0.long()[:, None] + torch.arange(T)[None]
    kv_pos = torch.arange(S)
    mask = (kv_pos[None, None] <= q_pos[..., None]) & (q_pos[..., None] - kv_pos[None, None] < w)
    s = torch.einsum("btkgh,bskh->bkgts", q.float(), k)
    log2e = 1.4426950408889634
    x = torch.tanh(s * scale / cap) * cap if cap > 0 else s * scale
    x = torch.where(mask[:, None, None], x, torch.full_like(x, -1e30))
    m = torch.full(x.shape[:-1], -1e30)
    l = torch.zeros(x.shape[:-1])
    acc = torch.zeros(x.shape[:-1] + (hd,))
    for t0 in range(0, S, ops.PREFILL_KEYS):
        xt = x[..., t0:t0 + ops.PREFILL_KEYS]
        m_new = torch.maximum(m, xt.max(-1).values)
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.where(xt == -1e30, torch.zeros_like(xt),
                        torch.exp2((xt - m_new[..., None]) * log2e))
        l = l * alpha + p.sum(-1)
        hi = p.to(BF).float()
        pr = hi + (p - hi).to(BF).float() if parts == 2 else hi
        acc = acc * alpha[..., None] + torch.einsum("bkgts,bskh->bkgth", pr,
                                                     v[:, t0:t0 + ops.PREFILL_KEYS])
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


# chip_smoke.py phase 3e's tail-prefill cases (gemma3: B 1, K 4, G 2, hd 256,
# int4 pool of unit-scale k / v), cut by 4 in T, positions and windows (hd 64,
# K 2): (T, pos0, window, cap, q_mult)
TAIL_CASES = [(32, 0, 256, 0.0, 1.0), (128, 0, 256, 0.0, 1.0), (512, 0, 256, 0.0, 1.0),
              (512, 0, None, 0.0, 1.0), (128, 250, 256, 0.0, 1.0), (512, 0, 16, 0.0, 4.0),
              (512, 250, 16, 2.0, 4.0), (64, 256, 256, 0.0, 1.0), (64, 250, 256, 0.0, 1.0),
              (32, 250, 256, 0.0, 1.0)]


def _model_err(case, parts):
    q, kp, vp, bt, pos0, kw = case
    kw = dict(kw, scale=64**-0.5)
    want = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
    got = _kernel_model(q, kp, vp, bt, pos0, parts=parts, **kw)
    ok = torch.allclose(got.float(), want.float(), **BF16_TOL)
    return ok, (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("pool", ["q4", "q8", "bf16"])
@pytest.mark.parametrize("case", range(len(TAIL_CASES)))
def test_two_part_p_holds_the_bf16_bar_on_the_tail_cases(case, pool):
    T, pos0, window, cap, q_mult = TAIL_CASES[case]
    q, kp, vp, bt, p0, kw = _call(case, T=T, G=2, pool=pool, pos0=pos0, q_mult=q_mult)
    ok, err = _model_err((q, kp, vp, bt, p0, dict(kw, window=window, cap=cap)), parts=2)
    assert ok, err


WIDE_CASES = [("q8", 64, None, 0.0), ("q4", 64, None, 0.0), ("q8", 200, 40, 5.0),
              ("q4", 200, 40, 5.0), ("q4", 128, 64, 2.0)]


@pytest.mark.parametrize("pool,T,window,cap", WIDE_CASES)
def test_two_part_p_holds_the_bar_on_wide_exponents(pool, T, window, cap):
    """Random mantissas under exponents spread over [-8, 4] (|v| up to
    127·2^4): outputs are sums that cancel, where p's rounding shows."""
    q, kp, vp, bt, p0, kw = _call(100 + T, T=T, G=2, pool=pool, pos0=37, wide=True)
    ok, err = _model_err((q, kp, vp, bt, p0, dict(kw, window=window, cap=cap)), parts=2)
    assert ok, err


def test_one_bf16_p_misses_the_bar_on_wide_exponents():
    """The reason for two parts: with p rounded once to bf16, some wide case
    misses the bar that the two-part p holds."""
    misses = []
    for pool, T, window, cap in WIDE_CASES:
        case = _call(100 + T, T=T, G=2, pool=pool, pos0=37, wide=True)
        case = case[:5] + (dict(case[5], window=window, cap=cap),)
        misses.append(not _model_err(case, parts=1)[0])
    assert any(misses)


# ---------------------------------------------------------------------------
# the port's plain version vs JAX's Pallas kernel (interpret) at the route's shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,T,window,cap", [(4, 32, None, 0.0), (8, 32, 9, 3.0),
                                               (4, 64, 20, 0.0), (8, 64, None, 5.0)])
def test_plain_version_matches_pallas_interpret_at_prefill_shapes(bits, T, window, cap):
    """Pools as a paged write makes them of unit-scale k / v (the fp32 bar's
    scale: over wide exponents, |v| up to 2032, two correct fp32 sums of 64+
    cancelling terms part by ~1e-4)."""
    rng = np.random.default_rng(bits * 10 + T)
    B, K, G, hd, block, mb = 2, 2, 2, 16, 16, 8
    n_blocks = B * mb + 1
    bt = (rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb).astype(np.int32)
    pos0 = np.asarray([5, 8 * 16 - T - 3], np.int32)  # mid-block starts
    q = rng.standard_normal((B, T, K, G, hd)).astype(np.float32)
    kp, vp, pkw = _pools(rng, n_blocks, block, K, hd, f"q{bits}")
    ops_np = [a.numpy() for a in (kp, vp, pkw["k_scale_exp"], pkw["v_scale_exp"])]
    kw = dict(scale=hd**-0.5, cap=cap, window=window, kv_bits=bits)
    want = j_paged(*(jnp.asarray(a) for a in (q, ops_np[0], ops_np[1], bt, pos0)),
                   k_scale_exp=jnp.asarray(ops_np[2]), v_scale_exp=jnp.asarray(ops_np[3]),
                   interpret=True, **kw)
    got = paged_attention(torch.from_numpy(q), kp, vp, torch.from_numpy(bt),
                          torch.from_numpy(pos0), k_scale_exp=pkw["k_scale_exp"],
                          v_scale_exp=pkw["v_scale_exp"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **F32_TOL)
    assert math.isfinite(float(got.abs().max()))
