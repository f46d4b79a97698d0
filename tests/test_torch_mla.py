"""Port parity, multi-head latent attention and deepseek-v3 (repro_torch vs
the JAX package) on the CPU, the same params on both sides (JAX trees
bridged through numpy; the reduced deepseek's float tree is drawn by the
port's seeded init, its packed tree by JAX's ``symog_init`` + ``pack_tree``):

  - ``paged_attention_mla`` (the plain version the wrapper runs on CPU
    tensors) against JAX's Pallas ``_mla_kernel`` / ``_mla_kernel_quant`` in
    interpret mode and JAX's ``paged_attention_mla_ref``: float, KV_F int8,
    SYMOG int8 and int4 pools (one exponent per physical block, over
    [-8, 4]), T in {1, 3}, block in {8, 16}, fp32 at 2e-4/2e-5 and bf16 at
    1e-2 (tests/test_paged_attention.py:182, :226); the block-8 half of the
    sweep is marked ``slow``;
  - the MLA layer: ``mla_apply`` (prefill) and ``mla_decode`` on the dense
    cache and on the paged pool, float and int4, on the 'fused' (the
    kernel's plain version) and 'composed' backends, against JAX's layer,
    the written pool leaves array_equal;
  - reduced deepseek-v3: forward logits, prefill + dense decode and paged
    dropless decode at 1e-4 (tests/test_torch_lm.py) for float and
    ``pack_tree`` params; the static loop's tokens
    equal JAX's; greedy ``serve()`` token-identical to JAX ``serve()`` from
    bf16, ``int8_fp`` and ``int4_fp`` MLA pools, the quantized pools and
    their exponents array_equal; the packed artifact has one f per (layer,
    expert) on the routed stacks and one f per stack elsewhere."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.kernels.dispatch import set_attention_backend as j_set_attn  # noqa: E402
from repro.kernels.paged_attention import paged_attention_mla as j_mla  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_mla_ref as j_mla_ref  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import decode_lm as j_decode  # noqa: E402
from repro.models import forward_lm as j_forward  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models import prefill_lm as j_prefill  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import Packed  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.paged_attention import ops, paged_attention_mla  # noqa: E402
from repro_torch.kernels.paged_attention.ref import dequant_logical  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import decode_lm, forward_lm, init_lm, lm_train_loss, prefill_lm  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_lm.py
ATTN_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
MAX_LEN = 24
_TREES, _ENG = {}, {}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _jit(fn, **bound):
    """JAX's model function jitted over its array arguments, with the config
    and options in ``bound``: one XLA compile per shape (under a second at
    the reduced size) where an eager first call compiles op by op (~5 s)."""
    return jax.jit(functools.partial(fn, **bound))


# ---------------------------------------------------------------------------
# the kernel's plain version vs JAX ref and Pallas interpret
# ---------------------------------------------------------------------------
def _mla_case(seed, *, pool, T, block, B=2, H=4, r=32, rope=16, max_blocks=3):
    """Numpy operands: queries, pools (float, KV_F int8, or SYMOG int8 /
    split-halves int4 words with one exponent per physical block in
    [-8, 4]), tables and first positions (one row at position 0)."""
    rng = np.random.default_rng(seed)
    n_blocks = B * max_blocks + 1
    bt = (rng.permutation(n_blocks - 1)[: B * max_blocks] + 1).reshape(B, max_blocks)
    pos0 = (rng.integers(T - 1, max_blocks * block, size=B) - (T - 1)).astype(np.int32)
    pos0[0] = 0
    q_eff = rng.standard_normal((B, T, H, r)).astype(np.float32)
    q_rope = rng.standard_normal((B, T, H, rope)).astype(np.float32)
    kw = dict(scale=0.1)
    pools = []
    for width in (r, rope):
        if pool == "float":
            pools.append(rng.standard_normal((n_blocks, block, width)).astype(np.float32))
        elif pool == "kv_f":
            pools.append(rng.integers(-127, 128, size=(n_blocks, block, width)).astype(np.int8))
        else:
            bits = 4 if pool == "int4" else 8
            qmax = tatt.KV_QMAX[bits]
            m = rng.integers(-qmax, qmax + 1, size=(n_blocks, block, width)).astype(np.int8)
            pools.append(tatt.pack_int4(_t(m)).numpy() if bits == 4 else m)
    if pool == "kv_f":
        kw["kv_scale"] = 2.0**-5
    elif pool in ("int8", "int4"):
        kw.update(ckv_scale_exp=rng.integers(-8, 5, size=n_blocks).astype(np.int32),
                  kr_scale_exp=rng.integers(-8, 5, size=n_blocks).astype(np.int32),
                  kv_bits=4 if pool == "int4" else 8)
    return (q_eff, q_rope, pools[0], pools[1], bt.astype(np.int32), pos0), kw


@pytest.mark.parametrize("pool", ["float", "kv_f", "int8", "int4"])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("block", [pytest.param(8, marks=pytest.mark.slow), 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_plain_matches_jax_ref_and_pallas(pool, T, block, dtype):
    (qe, qr, cp, kp, bt, pos0), kw = _mla_case(T * 10 + block, pool=pool, T=T, block=block)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    if pool == "float":  # float pools hold the compute dtype, as the serving pools do
        jc, jk, tc, tk = jnp.asarray(cp, jdt), jnp.asarray(kp, jdt), _t(cp, tdt), _t(kp, tdt)
    else:
        jc, jk, tc, tk = jnp.asarray(cp), jnp.asarray(kp), _t(cp), _t(kp)
    jargs = (jnp.asarray(qe, jdt), jnp.asarray(qr, jdt), jc, jk, jnp.asarray(bt),
             jnp.asarray(pos0))
    want = np.asarray(j_mla_ref(*jargs, **jkw).astype(jnp.float32))
    pallas = np.asarray(j_mla(*jargs, interpret=True, **jkw).astype(jnp.float32))
    got = paged_attention_mla(_t(qe, tdt), _t(qr, tdt), tc, tk, _t(bt), _t(pos0), **tkw)
    assert got.dtype == tdt and tuple(got.shape) == qe.shape
    np.testing.assert_allclose(got.float().numpy(), want, **ATTN_TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), pallas, **ATTN_TOL[dtype])
    assert (ops.mla_launches == ops.mla_quant_launches == ops.mla_tc_launches
            == ops.mla_tc_quant_launches == 0)  # CPU calls never count


def test_mla_wrapper_validates_its_arguments():
    (qe, qr, cp, kp, bt, pos0), kw = _mla_case(0, pool="int4", T=1, block=8)
    args = (_t(qe), _t(qr), _t(cp), _t(kp), _t(bt), _t(pos0))
    ce, re = _t(kw["ckv_scale_exp"]), _t(kw["kr_scale_exp"])
    with pytest.raises(ValueError):
        paged_attention_mla(*args, scale=0.1, kv_bits=4)  # no exponents
    with pytest.raises(ValueError):
        paged_attention_mla(*args, scale=0.1, ckv_scale_exp=ce, kr_scale_exp=re)  # no bits
    with pytest.raises(ValueError):
        paged_attention_mla(*args, scale=0.1, ckv_scale_exp=ce, kv_bits=4)  # one exponent leaf
    out = paged_attention_mla(*args, scale=0.1, ckv_scale_exp=ce, kr_scale_exp=re, kv_bits=4,
                              out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the CUDA route rule, and the tensor-core kernel's device-side work split
# ---------------------------------------------------------------------------
BF, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("q,pool,bits,kv_scale,r,rope,aligned,want", [
    (BF, BF, 0, 1.0, 512, 64, True, "tc"),  # deepseek-v3's bf16 pool
    (BF, I8, 4, 2.0**-5, 512, 64, True, "tc"),  # int4 SYMOG words (kv_scale unused)
    (BF, I8, 8, 1.0, 512, 64, True, "tc"),  # int8 SYMOG words
    (BF, I8, 0, 2.0**-5, 512, 64, True, "tc"),  # KV_F int8 x 2^-5
    (BF, I8, 0, 4.0, 64, 16, True, "tc"),  # KV_F under any power of two
    (BF, I8, 0, 0.03, 512, 64, True, "partial"),  # not a power of two: not exact
    (BF, I8, 0, 3 * 2.0**-5, 512, 64, True, "partial"),
    (BF, BF, 0, 0.5, 512, 64, True, "partial"),  # a bf16 pool is taken as it is
    (BF, F32, 0, 1.0, 512, 64, True, "partial"),  # fp32 values are not bf16
    (F32, BF, 0, 1.0, 512, 64, True, "partial"),  # fp32 queries (the parity runs)
    (F32, I8, 4, 1.0, 512, 64, True, "partial"),
    (F32, I8, 0, 2.0**-5, 512, 64, True, "partial"),
    (BF, BF, 0, 1.0, 36, 6, True, "partial"),  # widths not of 16
    (BF, I8, 4, 1.0, 512, 8, True, "partial"),
    (BF, BF, 0, 1.0, 520, 48, True, "partial"),
    (BF, BF, 0, 1.0, 528, 32, True, "partial"),  # r past 512
    (BF, BF, 0, 1.0, 512, 80, True, "partial"),  # r + rope past 576
    (BF, BF, 0, 1.0, 16, 16, True, "tc"),  # the smallest widths
    (BF, I8, 8, 1.0, 64, 16, True, "tc"),
    (BF, BF, 0, 1.0, 512, 64, False, "partial"),  # operands not 4-byte aligned
])
def test_mla_route_rule(q, pool, bits, kv_scale, r, rope, aligned, want):
    """The tensor cores take bf16 queries over a pool whose values are exact
    in bf16 (word x a power of two), at widths of 16 that fit their
    registers; everything else stays on mla_partial."""
    assert ops._mla_route(q, pool, bits, kv_scale, r, rope, aligned) == want


@pytest.mark.parametrize("B,TH,max_blocks,block", [
    (4, 128, 32, 16), (4, 384, 32, 16), (1, 128, 32, 16), (1, 5, 1, 16), (64, 128, 32, 16),
    (3, 24, 9, 8), (2, 40, 200, 64), (8, 1024, 64, 16),
])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_mla_tc_split_rule(B, TH, max_blocks, block, n_sm):
    """1..8 ranks (one cluster), no more than the longest row has tiles;
    thread blocks for at most 3/4 of the SMs where that gives 4 ranks or
    more, else up to 4 ranks within two blocks an SM (never more than two
    an SM unless one rank each already takes more); deepseek-v3's decode
    (B 4, 128 heads) takes 6 at T 1 and 4 at T 3."""
    row_tiles = -(-TH // ops.MLA_TC_ROWS)
    s = ops._mla_tc_split(B, row_tiles, max_blocks, block, n_sm)
    tiles = max_blocks * -(-block // ops.TILE)
    assert 1 <= s <= min(ops.MAX_SPLIT, tiles)
    pairs = B * row_tiles
    assert s == 1 or pairs * s <= 2 * n_sm
    assert s <= 4 or 4 * pairs * s <= 3 * n_sm
    if 4 * pairs * min(4, tiles) <= 3 * n_sm:  # 4 ranks fit one block an SM: no fewer
        assert s >= min(4, tiles)
    if (B, max_blocks, n_sm) == (4, 32, 132) and TH in (128, 384):
        assert s == (6 if TH == 128 else 4)


@pytest.mark.parametrize("block", [4, 8, 16, 20, 64])
@pytest.mark.parametrize("T,H", [(1, 5), (1, 8), (1, 128), (3, 8), (4, 5), (3, 128)])
def test_mla_split_covers_every_visible_tile_once(block, T, H):
    """Ragged rows (from one block up to the 32 a table holds, a row at
    position 0): for every row tile of every row, the mirrored range holds
    every tile with a key some row of the tile can see and nothing past the
    tile's last position (so a skipped tile is wholly masked: skipping it is
    exact); the ranks' shares cover it once, in order, and no rank is idle
    while another holds two or more tiles."""
    max_blocks = 32
    tpb = -(-block // ops.TILE)
    TH = T * H
    for n_blocks in sorted({1, 2, 3, 7, 19, 32}):
        for pos_last in sorted({(n_blocks - 1) * block, n_blocks * block - 1}):
            pos0 = max(pos_last - (T - 1), 0)
            for row0 in range(0, TH, ops.MLA_TC_ROWS):
                nr = min(ops.MLA_TC_ROWS, TH - row0)
                n = ops.mla_visible_tiles(pos0, H, row0, nr, block, max_blocks)
                last = pos0 + (row0 + nr - 1) // H
                for u in range(max_blocks * tpb):
                    j, t0 = divmod(u, tpb)
                    first_key = j * block + t0 * ops.TILE
                    assert (u < n) == (first_key <= last), (pos0, row0, u)
                assert n <= n_blocks * tpb
                for n_split in range(1, ops.MAX_SPLIT + 1):
                    shares = ops.mla_rank_tiles(n, n_split)
                    assert len(shares) == n_split
                    assert shares[0][0] == 0 and shares[-1][1] == n
                    for (a0, a1), (b0, b1) in zip(shares, shares[1:]):
                        assert a1 == b0 and a0 <= a1
                    sizes = [b - a for a, b in shares]
                    assert min(sizes) > 0 or max(sizes) <= 1


def _tc_model(qe, qr, c, k, bt, pos0, *, scale, block, n_split):
    """The tensor-core kernel's arithmetic in torch: each (b, 32-row tile)
    cut by the mirror into rank shares, each rank's online softmax over its
    tiles with fp32 logits of bf16 values and p·V as two bf16 products
    (p_hi = bf16(p), p_lo = bf16(p - p_hi)), the ranks merged in rank order.
    ``c``/``k`` are the pools dequantized (exact in bf16), (n, block, w)."""
    B, T, H, r = qe.shape
    TH, R = T * H, ops.MLA_TC_ROWS
    q = torch.cat([qe, qr], -1).reshape(B, TH, -1).float()
    kv = torch.cat([c, k], -1).float()
    out = torch.zeros(B, TH, r)
    tpb = -(-block // ops.TILE)
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    for b in range(B):
        p0 = int(pos0[b])
        for row0 in range(0, TH, R):
            nr = min(R, TH - row0)
            qpos = p0 + torch.arange(row0, row0 + nr) // H
            n = ops.mla_visible_tiles(p0, H, row0, nr, block, bt.shape[1])
            parts = []
            for u0, u1 in ops.mla_rank_tiles(n, n_split):
                m, l = torch.full((nr,), -1e30), torch.zeros(nr)
                acc = torch.zeros(nr, r)
                for u in range(u0, u1):
                    j, t0 = divmod(u, tpb)
                    tok0 = t0 * ops.TILE
                    tile = kv[int(bt[b, j]), tok0:min(block, tok0 + ops.TILE)]
                    keys = j * block + tok0 + torch.arange(tile.shape[0])
                    ok = keys[None] <= qpos[:, None]
                    x = torch.where(ok, (q[b, row0:row0 + nr] @ tile.T) * scale,
                                    torch.tensor(-1e30))
                    m_new = torch.maximum(m, x.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.where(ok, torch.exp(x - m_new[:, None]), torch.tensor(0.0))
                    l, m = l * alpha + p.sum(-1), m_new
                    hi = bf(p)
                    acc = acc * alpha[:, None] + hi @ tile[:, :r] + bf(p - hi) @ tile[:, :r]
                parts.append((m, l, acc))
            M = torch.stack([m for m, _, _ in parts]).max(0).values
            L, O = torch.zeros(nr), torch.zeros(nr, r)
            for m, l, acc in parts:
                f = torch.exp(m - M)
                L, O = L + l * f, O + acc * f[:, None]
            out[b, row0:row0 + nr] = O / torch.where(L == 0, torch.ones(()), L)[:, None]
    return out.reshape(B, T, H, r).to(torch.bfloat16)


@pytest.mark.parametrize("pool", ["float", "kv_f", "int8", "int4"])
@pytest.mark.parametrize("T", [1, 3])
def test_mla_tensor_core_model_matches_jax(pool, T):
    """The tensor-core kernel's arithmetic (``_tc_model``, with the
    mirrored tile cut and rank merge) against JAX's ``paged_attention_mla_ref``
    at deepseek-v3's widths (128 heads, r 512, rope 64, block 16, rows of up
    to ~300 tokens and one at position 0) at the bf16 bar.  SYMOG pools
    carry the wide spread (words over the full range, exponents over
    [-8, 4], queries scaled by 1 / (qmax x 2^4) for O(1) logits): there
    rounding p to bf16 alone misses the bar, and the hi / lo split holds."""
    (qe, qr, cp, kp, bt, pos0), kw = _mla_case(7 + T, pool=pool, T=T, block=16, B=2, H=128,
                                               r=512, rope=64, max_blocks=20)
    if pool in ("int8", "int4"):
        qmul = 1.0 / (tatt.KV_QMAX[4 if pool == "int4" else 8] * 2**4)
        qe, qr = qe * qmul, qr * qmul
    qe, qr = (_t(x, torch.bfloat16).float().numpy() for x in (qe, qr))  # bf16 queries
    if pool == "float":
        cp, kp = (_t(x, torch.bfloat16).float().numpy() for x in (cp, kp))  # a bf16 pool
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    every = _t(np.arange(cp.shape[0], dtype=np.int32)[None])  # each physical block once
    c, k = (dequant_logical(_t(x), tkw[e], every, kv_bits=kw["kv_bits"]).reshape(x.shape[0], 16, -1)
            if "kv_bits" in kw else _t(x).float() * kw.get("kv_scale", 1.0)
            for x, e in ((cp, "ckv_scale_exp"), (kp, "kr_scale_exp")))
    want = np.asarray(j_mla_ref(*(jnp.asarray(x) for x in (qe, qr, cp, kp, bt, pos0)),
                                **kw).astype(jnp.float32))
    for n_split in (1, 3, 8):
        got = _tc_model(_t(qe), _t(qr), c, k, _t(bt), _t(pos0), scale=kw["scale"], block=16,
                        n_split=n_split)
        np.testing.assert_allclose(got.float().numpy(), want, **ATTN_TOL["bfloat16"])


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------
MLA_KW = dict(d_model=32, n_heads=4, q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=8,
              qk_rope_dim=4, v_head_dim=8)


def _mla_layer(seed=5):
    jcfg, tcfg = jatt.MLAConfig(**MLA_KW), tatt.MLAConfig(**MLA_KW)
    jp = jatt.mla_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


def test_mla_apply_matches_jax():
    jcfg, tcfg, jp, tp = _mla_layer()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    want = jatt.mla_apply(jp, jnp.asarray(x), cfg=jcfg, positions=jnp.asarray(pos),
                          rope_base=1e4, compute_dtype=jnp.float32)
    got, (c_kv, k_rope) = tatt.mla_apply(tp, _t(x), cfg=tcfg, positions=_t(pos), rope_base=1e4,
                                         compute_dtype=torch.float32, return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(c_kv.shape) == (2, 9, 16) and tuple(k_rope.shape) == (2, 9, 4)
    # query-chunked prefill (T a multiple of the chunk) is the same attention
    chunked = tatt.mla_apply(tp, _t(x), cfg=tcfg, positions=_t(pos), rope_base=1e4,
                             compute_dtype=torch.float32, q_chunk=3)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), **TOL)


def test_mla_decode_dense_cache_matches_jax():
    jcfg, tcfg, jp, tp = _mla_layer()
    rng = np.random.default_rng(2)
    B, S = 2, 10
    c = rng.standard_normal((B, S, 16)).astype(np.float32)
    k = rng.standard_normal((B, S, 4)).astype(np.float32)
    x = rng.standard_normal((B, 1, 32)).astype(np.float32)
    for pos in (6, np.asarray([3, 8], np.int32)):
        jy, jc = jatt.mla_decode(jp, jnp.asarray(x), {"c_kv": jnp.asarray(c),
                                                      "k_rope": jnp.asarray(k)},
                                 jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos,
                                 cfg=jcfg, compute_dtype=jnp.float32)
        tcache = {"c_kv": _t(c), "k_rope": _t(k)}
        ty, tc = tatt.mla_decode(tp, _t(x), tcache, _t(pos) if isinstance(pos, np.ndarray)
                                 else pos, cfg=tcfg, compute_dtype=torch.float32)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for n in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


@pytest.mark.parametrize("pool", ["float", "int4"])
@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_mla_decode_paged_matches_jax(pool, backend):
    """The decode layer on a paged pool: the write (quantize-at-write for
    int4, one exponent per block) array_equal to JAX's, then the kernel's
    plain version or the composed read; row 1 opens a new block."""
    jcfg, tcfg, jp, tp = _mla_layer()
    rng = np.random.default_rng(3)
    B, block, mb = 2, 4, 3
    n = B * mb + 1
    x = rng.standard_normal((B, 1, 32)).astype(np.float32)
    if pool == "float":
        cache = {"c_kv": rng.standard_normal((n, block, 16)).astype(np.float32),
                 "k_rope": rng.standard_normal((n, block, 4)).astype(np.float32)}
    else:
        cache = {"c_kv": rng.integers(-7, 8, size=(n, block, 8)).astype(np.int8),
                 "k_rope": rng.integers(-7, 8, size=(n, block, 2)).astype(np.int8),
                 "c_kv_scale": rng.integers(-4, 2, size=n).astype(np.int32),
                 "k_rope_scale": rng.integers(-4, 2, size=n).astype(np.int32)}
    bt = (np.arange(B * mb) + 1).reshape(B, mb).astype(np.int32)
    pos = np.asarray([5, 8], np.int32)
    j_set_attn("composed")
    try:
        jy, jc = jatt.mla_decode(jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
                                 jnp.asarray(pos), cfg=jcfg, compute_dtype=jnp.float32,
                                 block_tables=jnp.asarray(bt))
    finally:
        j_set_attn("auto")
    tcache = {k: _t(v) for k, v in cache.items()}
    dispatch.set_attention_backend(backend)
    try:
        ty, tc = tatt.mla_decode(tp, _t(x), tcache, _t(pos), cfg=tcfg,
                                 compute_dtype=torch.float32, block_tables=_t(bt))
    finally:
        dispatch.set_attention_backend("auto")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-4, atol=2e-5)
    for name in cache:
        if pool == "float":
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)
        else:
            np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)


# ---------------------------------------------------------------------------
# reduced deepseek-v3
# ---------------------------------------------------------------------------
KINDS = ["float", "pack_tree"]


def _trees(kind):
    """(cfg, jax tree, port tree) per param kind, built once per module.  The
    float tree is the port's seeded ``init_lm`` carried into JAX arrays
    (JAX's eager init of the same tree takes ~20 s on the CPU; its
    structure is held to the port's by
    ``test_packed_artifact_per_expert_f_and_mtp_subtree``); the packed one
    is JAX's jitted ``symog_init`` + ``pack_tree`` of it."""
    if kind not in _TREES:
        cfg = jconfigs.get_reduced(ARCH)
        if kind == "pack_tree":
            scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
            jp = jax.jit(lambda p: jcore.pack_tree(p, jcore.symog_init(p, scfg), scfg))(
                _trees("float")[1])
        else:
            own = init_lm(0, tconfigs.get_reduced(ARCH), device="cpu")
            jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), own)
        _TREES[kind] = (cfg, jp, _bridge(jp))
    return _TREES[kind]


def _tokens(B=2, T=7, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(B, T)).astype(np.int32)


def test_packed_artifact_per_expert_f_and_mtp_subtree():
    cfg, jp, tp = _trees("pack_tree")
    assert cfg.layer_kinds() == ["D", "E", "E", "E"]
    n_moe = cfg.n_layers - cfg.n_dense_layers
    moe = tp["layers1"]["sub0"]["moe"]
    for name in ("gate_proj", "up_proj", "down_proj"):
        pk = moe["experts"][name]["kernel"]
        assert isinstance(pk, Packed) and tuple(pk.f.shape) == (n_moe, cfg.n_experts)
        np.testing.assert_array_equal(
            pk.f.numpy(), np.asarray(jp["layers1"]["sub0"]["moe"]["experts"][name]["kernel"].f))
        shared = moe["shared"][name]["kernel"]
        assert isinstance(shared, Packed) and shared.f.ndim == 0  # one f for the stack
    assert not isinstance(moe["router"]["kernel"], Packed)
    # MLA projections: multi-dim-out Packed leaves, one f each, shapes carried
    attn = tp["layers0"]["sub0"]["attn"]  # the unstacked dense layer
    want = {"q_b_proj": (24, 4, 12), "kv_b_k_proj": (16, 4, 8), "kv_b_v_proj": (16, 4, 8),
            "o_proj": (4, 8, 32)}
    for name, shape in want.items():
        pk = attn[name]["kernel"]
        assert isinstance(pk, Packed) and pk.f.ndim == 0 and pk.shape == shape, name
    assert not isinstance(attn["q_a_norm"]["scale"], Packed)
    assert isinstance(tp["layers1"]["sub0"]["attn"]["kv_b_k_proj"]["kernel"], Packed)
    # the mtp subtree bridges key for key (serving reads none of it), and the
    # port's own init builds JAX's tree: the same keys, shapes and dtypes
    mtp = tp["mtp"]
    assert set(mtp) == {"norm_h", "norm_e", "proj", "block", "final_norm"}
    assert isinstance(mtp["block"]["moe"]["experts"]["gate_proj"]["kernel"], Packed)
    assert tuple(mtp["block"]["moe"]["experts"]["gate_proj"]["kernel"].f.shape) == (
        cfg.n_experts,)
    want = jax.eval_shape(lambda key: j_init(key, cfg), jax.random.PRNGKey(0))
    own = init_lm(0, tconfigs.get_reduced(ARCH), device="cpu")

    def spec(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items() for k2, v2 in spec(v, f"{pre}/{k}").items()}
        return {pre: (tuple(t.shape), str(t.dtype).split(".")[-1])}

    assert spec(own) == spec(want)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_lm_matches_jax(kind):
    cfg, jp, tp = _trees(kind)
    tok = _tokens()
    want = _jit(j_forward, cfg=cfg, compute_dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(tok)}).logits
    got = forward_lm(tp, {"tokens": _t(tok)}, cfg, compute_dtype=torch.float32)
    assert tuple(got.logits.shape) == (2, 7, cfg.vocab_size)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_and_dense_decode_match_jax(kind):
    cfg, jp, tp = _trees(kind)
    tok, max_len = _tokens(), 12
    jl, jc = _jit(j_prefill, cfg=cfg, max_len=max_len, compute_dtype=jnp.float32)(
        jp, {"tokens": jnp.asarray(tok)})
    tl, tc = prefill_lm(tp, {"tokens": _t(tok)}, cfg, max_len=max_len,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for g in ("layers0", "layers1"):
        for n in ("c_kv", "k_rope"):
            np.testing.assert_allclose(tc[g]["sub0"][n].numpy(), np.asarray(jc[g]["sub0"][n]),
                                       **TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    j_step = _jit(j_decode, cfg=cfg, compute_dtype=jnp.float32)
    for step in range(3):
        jl, jc = j_step(jp, jc, jnp.asarray(nxt), jnp.int32(7 + step))
        tl, tc = decode_lm(tp, tc, _t(nxt), 7 + step, cfg, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


def _paged_case(kind):
    """The prompts' caches in c_kv/k_rope pools of both groups (the
    unstacked dense layer, the stacked MoE layers), and JAX's 3 paged
    dropless decode steps over them: (port pools, tables, [(tokens, pos,
    JAX logits)]), built once per param kind."""
    key = ("paged", kind)
    if key in _TREES:
        return _TREES[key]
    cfg, jp, _ = _trees(kind)
    block, nb, B = 4, 4, 2
    lens = [5, 9]
    n_phys = B * nb + 1
    widths = {"c_kv": cfg.kv_lora_rank, "k_rope": cfg.qk_rope_dim}
    leads = {"layers0": (), "layers1": (cfg.n_layers - cfg.n_dense_layers,)}
    jpool = {g: {n: jnp.zeros(lead + (n_phys, block, w)) for n, w in widths.items()}
             for g, lead in leads.items()}
    tpool = {g: {n: torch.zeros(lead + (n_phys, block, w)) for n, w in widths.items()}
             for g, lead in leads.items()}
    bt = (np.arange(B * nb) + 1).reshape(B, nb).astype(np.int32)
    rng = np.random.default_rng(3)
    j_pre = _jit(j_prefill, cfg=cfg, max_len=nb * block, compute_dtype=jnp.float32)
    for b, n in enumerate(lens):  # fill the prompts' caches through prefill
        tok = rng.integers(0, 256, size=(1, n)).astype(np.int32)
        _, jc = j_pre(jp, {"tokens": jnp.asarray(tok)})
        rows = torch.from_numpy(bt[b]).long()
        for g, lead in leads.items():
            for name, w in widths.items():
                src = np.asarray(jc[g]["sub0"][name])
                src = (src[:, 0] if lead else src[0]).reshape(lead + (nb, block, w))
                if lead:
                    jpool[g][name] = jpool[g][name].at[:, bt[b]].set(src)
                    tpool[g][name][:, rows] = _t(src)
                else:
                    jpool[g][name] = jpool[g][name].at[bt[b]].set(src)
                    tpool[g][name][rows] = _t(src)
    pos = np.asarray(lens, np.int32)
    jcaches = {g: {"sub0": p} for g, p in jpool.items()}
    tok = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
    steps = []
    j_step = _jit(j_decode, cfg=cfg, compute_dtype=jnp.float32)
    for _ in range(3):
        jl, jcaches = j_step(jp, jcaches, jnp.asarray(tok), jnp.asarray(pos),
                             active=jnp.asarray([True, True]), block_tables=jnp.asarray(bt))
        steps.append((tok, pos, np.asarray(jl)))
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1
    _TREES[key] = (tpool, bt, steps)
    return _TREES[key]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_paged_decode_dropless_matches_jax(kind, backend):
    """Scheduler-style decode over the paged c_kv/k_rope pools: per-row
    positions, ``active`` given, so MoE runs dropless, as in JAX."""
    cfg, _, tp = _trees(kind)
    tpool, bt, steps = _paged_case(kind)
    tcaches = {g: {"sub0": {n: t.clone() for n, t in p.items()}} for g, p in tpool.items()}
    active = _t(np.asarray([True, True]))
    dispatch.set_attention_backend(backend)
    try:
        for tok, pos, want in steps:
            tl, tcaches = decode_lm(tp, tcaches, _t(tok), _t(pos), cfg,
                                    compute_dtype=torch.float32, active=active,
                                    block_tables=_t(bt))
            np.testing.assert_allclose(tl.numpy(), want, **TOL)
    finally:
        dispatch.set_attention_backend("auto")


def test_generate_static_tokens_match_jax():
    cfg, jp, tp = _trees("pack_tree")
    tok = _tokens(B=3, T=6, seed=5)
    jeng = JEngine(cfg, jp, max_len=16, compute_dtype=jnp.float32)
    teng = ServeEngine(cfg, tp, max_len=16, compute_dtype=torch.float32, device="cpu")
    want = np.asarray(jeng.generate_static({"tokens": jnp.asarray(tok)}, 6))
    np.testing.assert_array_equal(teng.generate_static({"tokens": tok}, 6).numpy(), want)


def _engines(kv):
    """(jax engine, port engine) of the packed reduced deepseek per pool."""
    if kv not in _ENG:
        cfg = dataclasses.replace(jconfigs.get_reduced(ARCH), kv_cache_dtype=kv)
        jp = _trees("pack_tree")[1]
        _ENG[kv] = (JEngine(cfg, jp, max_len=MAX_LEN, compute_dtype=jnp.float32),
                    ServeEngine(cfg, _bridge(jp), max_len=MAX_LEN, compute_dtype=torch.float32,
                                device="cpu"))
    return _ENG[kv]


def _leaves(caches, prefix=()):
    if isinstance(caches, dict):
        for k in sorted(caches):
            yield from _leaves(caches[k], prefix + (k,))
    else:
        yield prefix, caches


@pytest.mark.parametrize("kv", ["bf16", "int8_fp", "int4_fp"])
def test_serve_matches_jax(kv):
    """Greedy serve through the scheduler (2 slots, blocks of 4, so decode
    opens new blocks): tokens and scheduler stats equal JAX's; quantized
    pools and their per-block exponents array_equal to JAX's, and a second
    serve gives the same tokens; the bf16 pool also equals the static loop."""
    jeng, teng = _engines(kv)
    assert teng.kv_quant_bits == {"int8_fp": 8, "int4_fp": 4, "bf16": 0}[kv]
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 256, size=L).astype(np.int32), b)
            for L, b in zip((3, 6, 4, 5, 7), (5, 3, 6, 4, 2))]
    sc = dict(n_slots=2, block_size=4)
    jcomps, jsched = jeng.serve([JRequest(tokens=p, max_new_tokens=b) for p, b in reqs],
                                JServeConfig(**sc), return_scheduler=True)
    tcomps, tsched = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                                ServeConfig(**sc), return_scheduler=True)
    for jc, tc in zip(jcomps, tcomps):
        assert tc.tokens == list(jc.tokens)
        assert tc.finish_reason == jc.finish_reason
    for key in ("decode_steps", "prefills", "preemptions"):
        assert tsched.stats[key] == jsched.stats[key], key
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jsched.caches)))
    tl = dict(_leaves(tsched.caches))
    assert sorted(jl) == sorted(tl)
    if kv == "bf16":
        assert {path[-1] for path in tl} == {"c_kv", "k_rope"}
        for (p, b), tc in zip(reqs, tcomps):
            static = teng.generate_static({"tokens": p[None]}, b)[0].numpy()
            np.testing.assert_array_equal(np.asarray(tc.tokens), static)
        return
    assert {path[-1] for path in tl} == {"c_kv", "k_rope", "c_kv_scale", "k_rope_scale"}
    cfg = teng.cfg
    for path, leaf in tl.items():
        if path[-1].endswith("_scale"):  # one exponent per physical block, no head axis
            assert leaf.dtype == torch.int32 and leaf.shape[-1] == tsched.n_blocks + 1
        else:
            w = cfg.kv_lora_rank if path[-1] == "c_kv" else cfg.qk_rope_dim
            assert leaf.dtype == torch.int8 and leaf.shape[-1] == (w // 2 if kv == "int4_fp"
                                                                   else w)
        np.testing.assert_array_equal(leaf.numpy(), jl[path], err_msg=str(path))
    again = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs], ServeConfig(**sc))
    assert [c.tokens for c in again] == [c.tokens for c in tcomps]


def test_deepseek_training_stays_refused():
    cfg, _, tp = _trees("float")
    with pytest.raises(NotImplementedError, match="MTP"):
        lm_train_loss(tp, {"tokens": _t(_tokens())}, cfg)
