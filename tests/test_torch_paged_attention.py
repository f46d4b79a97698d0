"""Port parity, paged attention (repro_torch.kernels.paged_attention and the
paged half of repro_torch.models.attention vs the JAX package).

On the CPU the port's wrapper runs its plain version (gather → mask →
softmax); it is held to the JAX Pallas kernel (interpret mode) and to JAX's
ref.py over GQA/MQA/MHA x T ∈ {1, 4} x window/softcap x block ∈ {8, 16},
plus an int8 KV_F pool and bf16 inputs, at 2e-4/2e-5 in fp32 and 5e-2 in
bf16 (the bars of tests/test_paged_attention.py).  The layer-level paged
index / scatter / gather must be exact.  The CUDA kernel is compared to the
plain version on the card (tests/test_torch_cuda.py; chip_smoke.py at serving
shapes)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.dispatch import set_attention_backend as j_set_attn  # noqa: E402
from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as j_ref  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.paged_attention import ops, paged_attention  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402

KV_SCALE = 2.0**-5
LAYOUTS = {"gqa": (2, 2), "mqa": (1, 4), "mha": (4, 1)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, *, B=3, T=1, K=2, G=2, hd=16, block=8, max_blocks=3, int8=False,
          dtype=np.float32):
    rng = np.random.default_rng(seed)
    n_blocks = B * max_blocks + 1
    bt = (rng.permutation(n_blocks - 1)[: B * max_blocks] + 1).reshape(B, max_blocks)
    pos_last = rng.integers(T - 1, max_blocks * block, size=B)
    pos0 = (pos_last - (T - 1)).astype(np.int32)
    q = rng.standard_normal((B, T, K, G, hd)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, block, K, hd)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, block, K, hd)).astype(np.float32)
    if int8:
        kp = np.clip(np.round(kp * 0.5 * 32), -127, 127).astype(np.int8)
        vp = np.clip(np.round(vp * 0.5 * 32), -127, 127).astype(np.int8)
    return q.astype(dtype), kp, vp, bt.astype(np.int32), pos0


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t.to(dtype) if dtype is not None else t


def _close(got, want, bf16=False):
    tol = dict(rtol=5e-2, atol=5e-2) if bf16 else dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)




@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("layout", ["gqa", "mqa", "mha"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (5, 8.0)])
def test_port_matches_jax_reference(block, layout, T, window, cap):
    K, G = LAYOUTS[layout]
    q, kp, vp, bt, pos0 = _case(block * 10 + T, T=T, K=K, G=G, block=block)
    kw = dict(scale=16**-0.5, cap=cap, window=window)
    want = j_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                 jnp.asarray(pos0), **kw)
    got = paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos0), **kw)
    assert tuple(got.shape) == q.shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("layout,T,window,cap", [
    ("gqa", 1, None, 0.0), ("gqa", 4, 7, 0.0), ("mqa", 1, 5, 8.0), ("mha", 4, None, 0.0),
])
def test_port_matches_pallas_interpret(layout, T, window, cap):
    K, G = LAYOUTS[layout]
    q, kp, vp, bt, pos0 = _case(T + 100, T=T, K=K, G=G, block=16)
    kw = dict(scale=16**-0.5, cap=cap, window=window)
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                   jnp.asarray(pos0), interpret=True, **kw)
    got = paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos0), **kw)
    _close(got.numpy(), want)


def test_int8_pool_and_bf16():
    q, kp, vp, bt, pos0 = _case(7, T=1, int8=True, block=16)
    kw = dict(scale=16**-0.5, kv_scale=KV_SCALE)
    want = j_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
                   jnp.asarray(pos0), interpret=True, **kw)
    got = paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos0), **kw)
    _close(got.numpy(), want)
    q, kp, vp, bt, pos0 = _case(8, T=4, block=8)
    want = j_ref(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
                 jnp.asarray(vp, jnp.bfloat16), jnp.asarray(bt), jnp.asarray(pos0),
                 scale=16**-0.5)
    got = paged_attention(_t(q, torch.bfloat16), _t(kp, torch.bfloat16), _t(vp, torch.bfloat16),
                          _t(bt), _t(pos0), scale=16**-0.5, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), bf16=True)
    assert ops.launches == 0  # CPU calls never count as kernel launches


def test_paged_index_update_gather_exact():
    rng = np.random.default_rng(2)
    block, B, mb = 4, 3, 5
    pool = rng.standard_normal((B * mb + 1, block, 2, 8)).astype(np.float32)
    bt = (rng.permutation(B * mb)[: B * mb] + 1).reshape(B, mb).astype(np.int32)
    pos = np.asarray([0, 7, 19], np.int32)
    new = rng.standard_normal((B, 2, 8)).astype(np.float32)
    j_idx = jatt.paged_token_index(jnp.asarray(bt), jnp.asarray(pos), block)
    t_idx = tatt.paged_token_index(_t(bt), _t(pos), block)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    j_pool = jatt.paged_update(jnp.asarray(pool), jnp.asarray(new), j_idx)
    t_pool = _t(pool.copy())
    out = tatt.paged_update(t_pool, _t(new), t_idx)
    assert out is t_pool  # in place
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(j_pool))
    np.testing.assert_array_equal(tatt.paged_gather(t_pool, _t(bt)).numpy(),
                                  np.asarray(jatt.paged_gather(j_pool, jnp.asarray(bt))))


@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_attn_decode_paged_matches_jax(backend):
    """The real layer entry point: paged attn_decode (scatter, then the
    kernel wrapper or the composed gather) vs JAX's composed layer."""
    import jax

    cfg_kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    jcfg, tcfg = jatt.AttnConfig(**cfg_kw), tatt.AttnConfig(**cfg_kw)
    jp = jatt.attn_init(jax.random.PRNGKey(3), jcfg)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    rng = np.random.default_rng(4)
    B, block, mb = 2, 4, 3
    x = rng.standard_normal((B, 1, 32)).astype(np.float32)
    k = rng.standard_normal((B * mb + 1, block, 2, 8)).astype(np.float32)
    v = rng.standard_normal((B * mb + 1, block, 2, 8)).astype(np.float32)
    bt = (np.arange(B * mb) + 1).reshape(B, mb).astype(np.int32)
    pos = np.asarray([5, 9], np.int32)
    j_set_attn("composed")
    try:
        jy, jc = jatt.attn_decode(jp, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                  jnp.asarray(pos), cfg=jcfg, rope_base=1e6,
                                  compute_dtype=jnp.float32, block_tables=jnp.asarray(bt))
    finally:
        j_set_attn("auto")
    cache = {"k": _t(k.copy()), "v": _t(v.copy())}
    dispatch.set_attention_backend(backend)
    try:
        ty, tc = tatt.attn_decode(tp, _t(x), cache, _t(pos), cfg=tcfg, rope_base=1e6,
                                  compute_dtype=torch.float32, block_tables=_t(bt))
    finally:
        dispatch.set_attention_backend("auto")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-4, atol=2e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the CUDA kernel's work split: the host's split count and the Python mirror
# of the visible-tile range it derives on the device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,K,TG,max_blocks,block", [
    (4, 8, 2, 32, 16), (4, 16, 1, 32, 16), (1, 1, 1, 1, 16), (3, 2, 40, 20, 8),
    (64, 8, 1, 32, 16), (2, 1, 8, 3, 64), (1, 2, 4, 5, 128), (8, 4, 32, 200, 16),
])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_n_split_rule(B, K, TG, max_blocks, block, n_sm):
    """A power of two, at most 8 thread blocks (one cluster), never more
    splits than blocks, no more than ~4 thread blocks an SM."""
    rows = ops._row_tile(TG)
    assert rows == min(TG, 4) or (TG == 3 and rows == 4)
    row_tiles = -(-TG // rows)
    s = ops._n_split(B, K, row_tiles, max_blocks, block, n_sm)
    assert s in (1, 2, 4, 8) and s <= max_blocks
    assert s == 1 or B * K * row_tiles * s <= 4 * n_sm


@pytest.mark.parametrize("block", [8, 16, 48])
@pytest.mark.parametrize("G,T", [(1, 1), (2, 1), (8, 4), (2, 4)])
@pytest.mark.parametrize("window", [None, 7, 40])
def test_split_covers_every_visible_tile_once(block, G, T, window):
    """Ragged rows (position 0 up to the last table slot): for every row
    tile, the mirrored tile range holds every tile with a key some row of the
    tile can see, and only tiles whose first or last keys reach a row's range
    (so a skipped tile is wholly masked: skipping it is exact); the warps'
    shares partition the range, in order."""
    max_blocks, w = 12, ops._NO_WINDOW if window is None else window
    n_tok = max_blocks * block
    TG, rows = T * G, ops._row_tile(T * G)
    tpb = -(-block // ops.TILE)
    for pos_last in sorted({T - 1, T, block - 1, block, n_tok // 2, n_tok - 1}):
        pos0 = pos_last - (T - 1)
        for row0 in range(0, TG, rows):
            nr = min(rows, TG - row0)
            u_lo, u_hi = ops.visible_tiles(pos0, G, row0, nr, w, block, max_blocks)
            qpos = [pos0 + (row0 + r) // G for r in range(nr)]
            for u in range(max_blocks * tpb):
                j, t0 = divmod(u, tpb)
                keys = range(j * block + t0 * ops.TILE, j * block + min(block, (t0 + 1) * ops.TILE))
                seen = any(k <= qp and qp - k < w for k in keys for qp in qpos)
                if seen:
                    assert u_lo <= u < u_hi, (pos0, row0, u)
                elif u_lo <= u < u_hi:  # inside the range: between the rows' first and last keys
                    assert keys[-1] >= qpos[0] - w + 1 and keys[0] <= qpos[-1]
            for n_split in (1, 2, 4, 8):
                shares = ops.worker_tiles(u_lo, u_hi, n_split)
                assert len(shares) == n_split * ops.WARPS
                assert shares[0][0] == u_lo and shares[-1][1] == u_hi
                for (a0, a1), (b0, b1) in zip(shares, shares[1:]):
                    assert a1 == b0 and a0 <= a1
                sizes = [b - a for a, b in shares]
                assert max(sizes) - min(sizes) <= 1
