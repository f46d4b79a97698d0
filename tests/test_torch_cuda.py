"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the ``cuda`` marker and skips (from a fixture) when
no CUDA device is present, as on a CPU-only machine.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no jax (the card's machine has none); the JAX parity of
the plain versions is held by the other tests/test_torch_*.py files.
Tolerances: fp32 rtol = atol = 1e-5 for the matmul (tests/test_kernels.py)
and 2e-4/2e-5 for attention (tests/test_paged_attention.py); bf16 1e-2, a
few roundings of the fp32 result, for both; rtol 1e-6, atol 1e-7 for the
SYMOG update (tests/test_kernels.py) and rtol 1e-5, atol 1e-7 for the fused
against the composed train update (tests/test_kernels.py:56-57)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pack  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul import fixedpoint_matmul, ops as fops  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul import fixedpoint_matmul_experts  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul import pack_weight  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul.ref import (  # noqa: E402
    fixedpoint_matmul_experts_ref,
    fixedpoint_matmul_ref,
)
from repro_torch.kernels.paged_attention import ops as aops, paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_mla  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_mla_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402

pytestmark = pytest.mark.cuda
LAYOUTS = {"gqa": (2, 2), "mqa": (1, 4), "mha": (4, 1)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with `pytest -m cuda`")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 256, 512), (4, 2048, 1024), (130, 512, 200), (3, 96, 40)])
def test_fixedpoint_matmul_matches_plain(dev, n_bits, dtype, M, K, N):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(M * 7 + n_bits)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.2).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, dt)
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    f = torch.tensor(3, dtype=torch.int32, device=dev)
    pw = pack_weight(w, f, n_bits)
    before = _counts()
    got = fixedpoint_matmul(x, pw, f, b, n_bits=n_bits, n_out=N)
    torch.cuda.synchronize()
    assert _launched(before, fops._pick_route(dt, M, True)) and got.dtype == dt
    want = fixedpoint_matmul_ref(x, pw, f, b, n_bits=n_bits, n_out=N).to(dt)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _counts():
    return (fops.launches, fops.tc_launches, fops.decode_launches, fops.experts_launches,
            fops.tc_experts_launches, fops.decode_experts_launches)


def _launched(before, route, experts=False):
    """Exactly one launch since ``before``, of ``route``'s kernel."""
    i = (3 if experts else 0) + fops.ROUTES.index(route)
    return all(a - b == (k == i) for k, (a, b) in enumerate(zip(_counts(), before)))


TC_BF16 = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of the fp32 result


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("N", [40, 200, 1024])
@pytest.mark.parametrize("K", [96, 2048])
@pytest.mark.parametrize("M", [16, 32, 130, 512])
def test_fixedpoint_matmul_tc_matches_plain(dev, M, K, N, bias, n_bits):
    """The tensor-core route (forced) against the plain version in bf16: rows
    of words that are not 16-byte aligned (N = 40, 200), a K that is not a
    multiple of the 64-row step (96), token counts past a 32-token tile;
    two calls give the same bits."""
    rng = np.random.default_rng(M + K + N + n_bits)
    w = torch.from_numpy((rng.standard_normal((K, N)) / K**0.5).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev) if bias else None
    f = torch.tensor(n_bits, dtype=torch.int32, device=dev)
    pw = pack_weight(w, f, n_bits)
    before = _counts()
    got = fixedpoint_matmul(x, pw, f, b, n_bits=n_bits, n_out=N, _route="tensor_core")
    torch.cuda.synchronize()
    assert _launched(before, "tensor_core") and got.dtype == torch.bfloat16
    want = fixedpoint_matmul_ref(x, pw, f, b, n_bits=n_bits, n_out=N).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **TC_BF16)
    again = fixedpoint_matmul(x, pw, f, b, n_bits=n_bits, n_out=N, _route="tensor_core")
    assert torch.equal(got, again)


@pytest.mark.parametrize("M,dtype,route", [
    (fops.DECODE_MAX_ROWS + 1, "bfloat16", "tensor_core"), (512, "bfloat16", "tensor_core"),
    (fops.DECODE_MAX_ROWS, "bfloat16", "decode"), (4, "bfloat16", "decode"),
    (1, "bfloat16", "decode"), (512, "float32", "streaming"), (4, "float32", "streaming"),
])
def test_fixedpoint_matmul_route_rule_launches(dev, M, dtype, route):
    """bf16 up to DECODE_MAX_ROWS rows launches the decode kernel, above it
    the tensor-core kernel; fp32 (the parity phases, the fp32 head) the
    streaming one."""
    rng = np.random.default_rng(M)
    w = torch.from_numpy((rng.standard_normal((256, 128)) * 0.1).astype(np.float32)).to(dev)
    f = torch.tensor(3, dtype=torch.int32, device=dev)
    x = torch.from_numpy(rng.standard_normal((M, 256)).astype(np.float32)).to(dev,
                                                                               getattr(torch, dtype))
    before = _counts()
    fixedpoint_matmul(x, pack_weight(w, f, 2), f, n_bits=2, n_out=128)
    torch.cuda.synchronize()
    assert _launched(before, route)


def test_fixedpoint_matmul_tc_refuses_what_it_does_not_take(dev):
    """Forcing the tensor-core route on fp32 x, or on rows of x that are not
    16-byte aligned, raises instead of computing another function."""
    pw = torch.zeros((64, 16), dtype=torch.int8, device=dev)
    f = torch.tensor(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fixedpoint_matmul(torch.zeros((8, 64), device=dev), pw, f, n_bits=2, n_out=64,
                          _route="tensor_core")
    with pytest.raises(ValueError):  # K = 60: rows not a multiple of 16 bytes
        fixedpoint_matmul(torch.zeros((8, 60), dtype=torch.bfloat16, device=dev), pw[:60], f,
                          n_bits=2, n_out=64, _route="tensor_core")


def test_fixedpoint_matmul_rejects_bad_operands(dev):
    x = torch.zeros((2, 64), device=dev)
    pw = torch.zeros((64, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        fixedpoint_matmul(x, pw, torch.tensor(1, device=dev), n_bits=2, n_out=64)  # int64 f
    with pytest.raises(ValueError):
        fixedpoint_matmul(x, pw[:32], torch.tensor(1, dtype=torch.int32, device=dev), n_bits=2,
                          n_out=64)


@pytest.mark.parametrize("layout,T,window,cap,block", [
    ("gqa", 1, None, 0.0, 16), ("gqa", 4, 7, 0.0, 8), ("mqa", 1, 5, 8.0, 16),
    ("mha", 4, None, 0.0, 8), ("gqa", 40, None, 0.0, 16),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_paged_attention_matches_plain(dev, layout, T, window, cap, block, dtype):
    K, G = LAYOUTS[layout]
    B, hd, mb = 3, 128, 20
    rng = np.random.default_rng(T * 3 + block)
    n_blocks = B * mb + 1
    bt = (rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb).astype(np.int32)
    pos0 = (rng.integers(T - 1, mb * block, size=B) - (T - 1)).astype(np.int32)
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd)).astype(np.float32)).to(dev, qdt)
    pools = [torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd)).astype(np.float32))
             for _ in range(2)]
    if dtype == "int8":
        pools = [torch.clamp(torch.round(p * 16), -127, 127).to(torch.int8) for p in pools]
    else:
        pools = [p.to(qdt) for p in pools]
    kp, vp = (p.to(dev) for p in pools)
    bt, pos0 = torch.from_numpy(bt).to(dev), torch.from_numpy(pos0).to(dev)
    kw = dict(scale=hd**-0.5, cap=cap, window=window,
              kv_scale=2.0**-5 if dtype == "int8" else 1.0)
    before = aops.launches
    got = paged_attention(q, kp, vp, bt, pos0, **kw)
    torch.cuda.synchronize()
    assert aops.launches == before + 1 and got.dtype == qdt
    want = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
    tol = dict(rtol=2e-4, atol=2e-5) if qdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _experts_case(dev, E, C, K, N, n_bits, dt, seed):
    """(x, packed words, f) as SYMOG makes a stack: Gaussian weights, expert
    e scaled by 2^s_e (s_e in [-2, 2]) and packed under its own optimal f;
    its rows of x scaled by 2^-s_e keep the outputs at unit scale, where the
    fp32 bar of tests/test_kernels.py applies."""
    from repro_torch.core import optimal_f, pack

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sc = torch.exp2(torch.randint(-2, 3, (E, 1, 1), generator=gen, device=dev).float())
    w = torch.randn((E, K, N), generator=gen, device=dev) * (sc / K**0.5)
    f = torch.stack([optimal_f(w[e], n_bits)[0] for e in range(E)]).to(torch.int32)
    pk = pack(w, f, n_bits)
    x = (torch.randn((E, C, K), generator=gen, device=dev) / sc).to(dt)
    return x, pk.data, pk.f


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,K,N", [(8, 4, 256, 128), (64, 4, 2048, 1024), (64, 4, 1024, 2048),
                                     (64, 80, 2048, 1024), (5, 80, 512, 96), (3, 1, 96, 40),
                                     (256, 4, 7168, 2048), (256, 4, 2048, 7168)])  # deepseek-v3
def test_fixedpoint_matmul_experts_matches_plain(dev, n_bits, dtype, E, C, K, N):
    dt = getattr(torch, dtype)
    x, words, f = _experts_case(dev, E, C, K, N, n_bits, dt, seed=E * 13 + C + n_bits)
    before = _counts()
    got = fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N)
    torch.cuda.synchronize()
    assert _launched(before, fops._pick_route(dt, C, True), experts=True) and got.dtype == dt
    want = fixedpoint_matmul_experts_ref(x, words, f, n_bits=n_bits, n_out=N).to(dt)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # deterministic: no atomics in any sum
    again = fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N)
    assert torch.equal(got, again)


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("E", [8, 64])
@pytest.mark.parametrize("C", [2, 5, 20, 80])
def test_fixedpoint_matmul_experts_tc_matches_plain(dev, C, E, n_bits):
    """The experts form on the tensor-core route (forced), bf16, at the
    prefill capacities of both MoE models; two calls give the same bits."""
    x, words, f = _experts_case(dev, E, C, 512, 192, n_bits, torch.bfloat16,
                                seed=E * 7 + C + n_bits)
    before = _counts()
    got = fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=192, _route="tensor_core")
    torch.cuda.synchronize()
    assert _launched(before, "tensor_core", experts=True)
    want = fixedpoint_matmul_experts_ref(x, words, f, n_bits=n_bits, n_out=192).bfloat16()
    torch.testing.assert_close(got.float(), want.float(), **TC_BF16)
    again = fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=192,
                                      _route="tensor_core")
    assert torch.equal(got, again)


@pytest.mark.parametrize("C,dtype,route", [
    (fops.DECODE_MAX_ROWS + 1, "bfloat16", "tensor_core"), (80, "bfloat16", "tensor_core"),
    (4, "bfloat16", "decode"), (80, "float32", "streaming"), (4, "float32", "streaming"),
])
def test_fixedpoint_matmul_experts_route_rule_launches(dev, C, dtype, route):
    x, words, f = _experts_case(dev, 4, C, 256, 64, 2, getattr(torch, dtype), seed=C)
    before = _counts()
    fixedpoint_matmul_experts(x, words, f, n_bits=2, n_out=64)
    torch.cuda.synchronize()
    assert _launched(before, route, experts=True)


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("K,N", [(96, 40), (2048, 200), (2048, 1024), (8192, 512)])
@pytest.mark.parametrize("M", list(range(1, 9)))
def test_fixedpoint_matmul_decode_matches_plain(dev, M, K, N, bias, n_bits):
    """The decode kernel (forced) against the plain version in bf16 at 1..8
    rows: rows of words that are not 16-byte aligned (N = 40, 200), a K of
    one short ring stage (96), a tall K split over a cluster (8192); two
    calls give the same bits."""
    rng = np.random.default_rng(M * 31 + K + N + n_bits)
    w = torch.from_numpy((rng.standard_normal((K, N)) / K**0.5).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev) if bias else None
    f = torch.tensor(n_bits, dtype=torch.int32, device=dev)
    pw = pack_weight(w, f, n_bits)
    before = _counts()
    got = fixedpoint_matmul(x, pw, f, b, n_bits=n_bits, n_out=N, _route="decode")
    torch.cuda.synchronize()
    assert _launched(before, "decode") and got.dtype == torch.bfloat16
    want = fixedpoint_matmul_ref(x, pw, f, b, n_bits=n_bits, n_out=N).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **TC_BF16)
    again = fixedpoint_matmul(x, pw, f, b, n_bits=n_bits, n_out=N, _route="decode")
    assert torch.equal(got, again)


def _routed(dev, E, C, K, rng, fill):
    """x (E, C, K) bf16 whose expert e holds rows[e] leading rows (the rest
    zero, as the MoE dispatch leaves them) and rows (E,) int32: random in
    0..C, all 0, or all C."""
    if fill == "random":
        rows = rng.integers(0, C + 1, size=E)
        rows[rng.random(E) < 0.5] = 0  # about half the experts empty
    else:
        rows = np.full(E, 0 if fill == "empty" else C)
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    x[np.arange(C)[None, :] >= rows[:, None]] = 0.0
    return (torch.from_numpy(x).to(dev, torch.bfloat16),
            torch.from_numpy(rows.astype(np.int32)).to(dev))


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("fill", ["random", "empty", "full"])
@pytest.mark.parametrize("E,C,K,N", [(1, 1, 96, 40), (1, 8, 256, 200), (8, 2, 256, 64),
                                     (8, 5, 512, 192), (8, 6, 128, 96), (8, 7, 512, 40),
                                     (64, 4, 2048, 1024), (64, 3, 1024, 2048),
                                     (256, 4, 512, 192), (256, 8, 1024, 64),
                                     (256, 1, 256, 7168)])
def test_fixedpoint_matmul_experts_decode_matches_plain(dev, E, C, K, N, fill, n_bits):
    """The experts form on the decode kernel (forced) with occupied-expert
    ``rows``: held to the plain version with the same rows; equal, bit for
    bit, to the same kernel computing every expert; every empty expert is
    given f = -200 (2^-f = inf in fp32), so a kernel that computed it would
    write NaN (0·inf) where the rows-given call must write +0; two calls
    give the same bits."""
    rng = np.random.default_rng(E * 17 + C * 5 + K + N + n_bits)
    x, rows = _routed(dev, E, C, K, rng, fill)
    sc = 2.0 ** rng.integers(-2, 3, size=(E, 1, 1))
    w = torch.from_numpy((rng.standard_normal((E, K, N)) * sc / K**0.5).astype(np.float32))
    f = torch.from_numpy(rng.integers(0, 4, size=E).astype(np.int32))
    words = pack(w, f, n_bits).data.to(dev)
    f = f.to(dev)
    ma = min(E, 32)
    call = dict(n_bits=n_bits, n_out=N, max_active=ma, _route="decode")
    before = _counts()
    got = fixedpoint_matmul_experts(x, words, f, rows=rows, **call)
    torch.cuda.synchronize()
    assert _launched(before, "decode", experts=True) and got.dtype == torch.bfloat16
    want = fixedpoint_matmul_experts_ref(x, words, f, n_bits=n_bits, n_out=N, rows=rows)
    torch.testing.assert_close(got.float(), want.bfloat16().float(), **TC_BF16)
    every = fixedpoint_matmul_experts(x, words, f, **call)  # rows=None: every expert
    assert torch.equal(got, every)
    f_inf = torch.where(rows > 0, f, torch.full_like(f, -200))
    skipped = fixedpoint_matmul_experts(x, words, f_inf, rows=rows, **call)
    assert torch.equal(skipped, got)
    empty = rows == 0
    assert not torch.signbit(skipped[empty].float()).any()
    if empty.any():  # the same kernel computing the empty experts writes NaN there
        assert torch.isnan(fixedpoint_matmul_experts(x, words, f_inf, **call)[empty]).all()
    again = fixedpoint_matmul_experts(x, words, f, rows=rows, **call)
    assert torch.equal(got, again)


@pytest.mark.parametrize("max_active", [1, 3, 64, 1000])
def test_fixedpoint_matmul_experts_decode_any_max_active(dev, max_active):
    """``max_active`` sizes the grid only: a bound far below the experts
    that hold rows (the clusters then walk several) or above E gives the
    same result as the plain version."""
    rng = np.random.default_rng(max_active)
    E, C, K, N = 64, 4, 512, 256
    x, rows = _routed(dev, E, C, K, rng, "random")
    w = torch.from_numpy((rng.standard_normal((E, K, N)) / K**0.5).astype(np.float32))
    f = torch.from_numpy(rng.integers(0, 4, size=E).astype(np.int32))
    words, f = pack(w, f, 2).data.to(dev), f.to(dev)
    got = fixedpoint_matmul_experts(x, words, f, n_bits=2, n_out=N, rows=rows,
                                    max_active=max_active)
    want = fixedpoint_matmul_experts_ref(x, words, f, n_bits=2, n_out=N, rows=rows)
    torch.testing.assert_close(got.float(), want.bfloat16().float(), **TC_BF16)


def test_fixedpoint_matmul_decode_refuses_what_it_does_not_take(dev):
    """Forcing the decode kernel on fp32 x, more than DECODE_MAX_ROWS rows,
    or rows of x that are not 16-byte aligned raises; ``rows`` of the wrong
    type, shape or device raises."""
    pw = torch.zeros((64, 16), dtype=torch.int8, device=dev)
    f = torch.tensor(1, dtype=torch.int32, device=dev)
    x16 = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fixedpoint_matmul(x16.float(), pw, f, n_bits=2, n_out=64, _route="decode")
    with pytest.raises(ValueError):
        fixedpoint_matmul(torch.zeros((9, 64), dtype=torch.bfloat16, device=dev), pw, f,
                          n_bits=2, n_out=64, _route="decode")
    with pytest.raises(ValueError):
        fixedpoint_matmul(torch.zeros((4, 60), dtype=torch.bfloat16, device=dev), pw[:60], f,
                          n_bits=2, n_out=64, _route="decode")
    xe = torch.zeros((4, 2, 64), dtype=torch.bfloat16, device=dev)
    we = torch.zeros((4, 64, 16), dtype=torch.int8, device=dev)
    fe = torch.ones(4, dtype=torch.int32, device=dev)
    for bad in (torch.ones(4, dtype=torch.int64, device=dev),
                torch.ones(3, dtype=torch.int32, device=dev), torch.ones(4, dtype=torch.int32)):
        with pytest.raises(ValueError):
            fixedpoint_matmul_experts(xe, we, fe, n_bits=2, n_out=64, rows=bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(7168, 64), (1536, 24576), (16384, 7168), (7168, 129280)])
def test_fixedpoint_matmul_deepseek_shapes(dev, dtype, K, N):
    """deepseek-v3's 2-D decode shapes at 2 bits: k_rope (16 words a row),
    q_b, o, the head; Gaussian weights under their optimal f, unit-scale
    outputs."""
    from repro_torch.core import optimal_f

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(K + N)
    w = torch.randn((K, N), generator=gen, device=dev) / K**0.5
    f = optimal_f(w, 2)[0].to(torch.int32)
    pw = pack_weight(w, f, 2)
    del w
    x = torch.randn((4, K), generator=gen, device=dev).to(dt)
    got = fixedpoint_matmul(x, pw, f, n_bits=2, n_out=N)
    want = fixedpoint_matmul_ref(x, pw, f, n_bits=2, n_out=N).to(dt)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_fixedpoint_matmul_experts_rejects_bad_operands(dev):
    x, words, f = _experts_case(dev, 4, 2, 64, 32, 2, torch.float32, seed=0)
    with pytest.raises(ValueError):  # f of the wrong shape
        fixedpoint_matmul_experts(x, words, f[:3], n_bits=2, n_out=32)
    with pytest.raises(ValueError):  # f not int32
        fixedpoint_matmul_experts(x, words, f.long(), n_bits=2, n_out=32)
    with pytest.raises(ValueError):  # word width of another n_bits
        fixedpoint_matmul_experts(x, words, f, n_bits=4, n_out=32)
    with pytest.raises(ValueError):  # operands on another device
        fixedpoint_matmul_experts(x, words.cpu(), f, n_bits=2, n_out=32)
    with pytest.raises(ValueError):
        fixedpoint_matmul_experts(x, words, f.cpu(), n_bits=2, n_out=32)


def _quant_pools(rng, n_blocks, block, K, hd, bits, wide):
    """SYMOG-quantized k/v pools: int8 words (int4: split-halves words, hd/2
    per row) and per-(block, head) exponents.  ``wide``: random mantissas
    under exponents spread over [-8, 4] (|value| up to 127·2^4).  Otherwise
    the pools a paged write makes of unit-scale k/v: values N(0,1)·2^s with
    s in [-3, 1] per (block, head), exponents calibrated from each block's
    first token (``block_scale_exp``), then ``quantize_fixed``."""
    from repro_torch.models.attention import KV_QMAX, block_scale_exp, pack_int4, quantize_fixed

    qmax = KV_QMAX[bits]
    pools, exps = [], []
    for _ in range(2):
        if wide:
            m = torch.from_numpy(rng.integers(-qmax, qmax + 1, size=(n_blocks, block, K, hd))
                                 .astype(np.int8))
            e = torch.from_numpy(rng.integers(-8, 5, size=(n_blocks, K)).astype(np.int32))
        else:
            s = rng.integers(-3, 2, size=(n_blocks, 1, K, 1)).astype(np.float32)
            x = torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd)).astype(np.float32)
                                 * np.exp2(s))
            e = block_scale_exp(x[:, 0], qmax)
            m = quantize_fixed(x, e[:, None], qmax)
        pools.append(pack_int4(m) if bits == 4 else m)
        exps.append(e)
    return pools, exps


def test_pack_int4_on_card_matches_cpu(dev):
    """The int4 pool words written on the card (integer shifts and casts of
    negative values) equal the CPU's, which the JAX parity tests hold."""
    from repro_torch.models.attention import pack_int4

    vals = torch.arange(-8, 8, dtype=torch.int8)
    lo, hi = torch.meshgrid(vals, vals, indexing="ij")
    x = torch.stack([lo.reshape(-1), hi.reshape(-1)], dim=-1)  # every nibble pair
    assert torch.equal(pack_int4(x.to(dev)).cpu(), pack_int4(x))


QUANT_LAYOUTS = dict(LAYOUTS, olmoe=(16, 1), internlm2=(8, 2))  # + the serving decode shapes


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout,T,window,cap,block", [
    ("mha", 1, None, 0.0, 16), ("gqa", 1, None, 0.0, 16), ("gqa", 1, 64, 2.0, 16),
    ("mqa", 4, 7, 0.0, 8), ("gqa", 40, None, 0.0, 16), ("olmoe", 1, None, 0.0, 16),
    ("internlm2", 1, None, 0.0, 16),
])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_paged_attention_quant_matches_plain(dev, bits, layout, T, window, cap, block, qdtype):
    """fp32 queries on serving-like pools at the fp32 bar; bf16 queries (the
    serving dtype) on the wide exponent spread at the bf16 bar.  (With
    |v| up to 2032, two correct fp32 implementations differ by ~1e-3 in
    sums that cancel: roundoff, where a wrong exponent is a factor of 2.)
    The olmoe / internlm2 layouts are the serving decode shapes: 4 rows of
    up to 320 cached tokens."""
    K, G = QUANT_LAYOUTS[layout]
    B, hd, mb = (4 if layout in ("olmoe", "internlm2") else 3), 128, 20
    rng = np.random.default_rng(T * 5 + block + bits)
    n_blocks = B * mb + 1
    bt = (rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb).astype(np.int32)
    pos0 = (rng.integers(T - 1, mb * block, size=B) - (T - 1)).astype(np.int32)
    qdt = getattr(torch, qdtype)
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd)).astype(np.float32)).to(dev, qdt)
    (kp, vp), (ke, ve) = _quant_pools(rng, n_blocks, block, K, hd, bits,
                                      wide=qdt == torch.bfloat16)
    kp, vp, ke, ve = (t.to(dev) for t in (kp, vp, ke, ve))
    bt, pos0 = torch.from_numpy(bt).to(dev), torch.from_numpy(pos0).to(dev)
    kw = dict(scale=hd**-0.5, cap=cap, window=window, k_scale_exp=ke, v_scale_exp=ve,
              kv_bits=bits)
    before = aops.quant_launches
    got = paged_attention(q, kp, vp, bt, pos0, **kw)
    torch.cuda.synchronize()
    assert aops.quant_launches == before + 1 and got.dtype == qdt
    want = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
    tol = dict(rtol=2e-4, atol=2e-5) if qdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_paged_attention_quant_rejects_bad_operands(dev):
    rng = np.random.default_rng(0)
    (kp, vp), (ke, ve) = _quant_pools(rng, 5, 8, 2, 16, 4, wide=True)
    kp, vp, ke, ve = (t.to(dev) for t in (kp, vp, ke, ve))
    q = torch.zeros((1, 1, 2, 1, 16), device=dev)
    bt = torch.ones((1, 2), dtype=torch.int32, device=dev)
    pos0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    kw = dict(scale=0.25, k_scale_exp=ke, v_scale_exp=ve)
    with pytest.raises(ValueError):  # int4 words read as int8: the word width is wrong
        paged_attention(q, kp, vp, bt, pos0, kv_bits=8, **kw)
    with pytest.raises(ValueError):  # exponents of the wrong shape
        paged_attention(q, kp, vp, bt, pos0, kv_bits=4, scale=0.25, k_scale_exp=ke[:3],
                        v_scale_exp=ve)
    with pytest.raises(ValueError):  # exponents on another device
        paged_attention(q, kp, vp, bt, pos0, kv_bits=4, scale=0.25, k_scale_exp=ke.cpu(),
                        v_scale_exp=ve)
    with pytest.raises(ValueError):  # kv_bits without exponents
        paged_attention(q, kp, vp, bt, pos0, kv_bits=4, scale=0.25)


GQA_POOLS = ["float32", "bfloat16", "int8", "q8", "q4"]  # the five pool codes


@pytest.mark.parametrize("pool", GQA_POOLS)
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (40, 5.0)])
def test_paged_attention_ragged_rows(dev, pool, G, T, window, cap):
    """Rows from position 0 to the table's last slot in one batch (one
    block visible to the first, all 32 to the last), their table entries past
    each row's length on the trash block 0.  Every block no row can see --
    the trash block, and blocks wholly before a window -- is filled with NaN
    in float pools: one read of it would reach the output (0 x NaN).  Held
    to the plain version on clean pools at the attention bar; a second call
    gives the same bits."""
    K, hd, block, mb = 2, 128, 16, 32
    B = 6
    rng = np.random.default_rng(G * 10 + T + (window or 0))
    pos_last = np.linspace(T - 1, mb * block - 1, B).round().astype(np.int64)
    pos0 = (pos_last - (T - 1)).astype(np.int32)
    n_blocks = B * mb + 1
    ids = rng.permutation(n_blocks - 1)[: B * mb].reshape(B, mb) + 1
    bt = np.zeros((B, mb), np.int32)
    hidden = [0]  # physical blocks no row sees
    w = aops._NO_WINDOW if window is None else window
    for b in range(B):
        n_own = pos_last[b] // block + 1
        bt[b, :n_own] = ids[b, :n_own]
        u_lo, u_hi = aops.visible_tiles(int(pos0[b]), G, 0, T * G, w, block, mb)
        hidden += [int(ids[b, j]) for j in range(n_own) if not u_lo <= j < u_hi]
    qdt = torch.bfloat16 if pool in ("bfloat16",) else torch.float32
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd)).astype(np.float32)).to(dev, qdt)
    kw = dict(scale=hd**-0.5, cap=cap, window=window)
    if pool in ("q8", "q4"):
        bits = 8 if pool == "q8" else 4
        (kp, vp), (ke, ve) = _quant_pools(rng, n_blocks, block, K, hd, bits, wide=False)
        kw.update(k_scale_exp=ke.to(dev), v_scale_exp=ve.to(dev), kv_bits=bits)
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd))
                                   .astype(np.float32)) for _ in range(2))
        if pool == "int8":
            kp, vp = (torch.clamp(torch.round(x * 16), -127, 127).to(torch.int8) for x in (kp, vp))
            kw["kv_scale"] = 2.0**-5
        else:
            kp, vp = kp.to(getattr(torch, pool)), vp.to(getattr(torch, pool))
    kp, vp = kp.to(dev), vp.to(dev)
    bt_d, pos0_d = torch.from_numpy(bt).to(dev), torch.from_numpy(pos0).to(dev)
    want = paged_attention_ref(q, kp, vp, bt_d, pos0_d, **kw)
    if pool in ("float32", "bfloat16"):
        kp[hidden], vp[hidden] = float("nan"), float("nan")
    counter = "quant_launches" if pool in ("q8", "q4") else "launches"
    before = getattr(aops, counter)
    got = paged_attention(q, kp, vp, bt_d, pos0_d, **kw)
    again = paged_attention(q, kp, vp, bt_d, pos0_d, **kw)
    torch.cuda.synchronize()
    assert getattr(aops, counter) == before + 2 and got.dtype == qdt
    assert bool(torch.isfinite(got).all())
    tol = dict(rtol=2e-4, atol=2e-5) if qdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("pool", GQA_POOLS)
@pytest.mark.parametrize("hd,block,T,G", [(8, 4, 1, 2), (72, 20, 3, 1), (256, 32, 1, 2),
                                          (136, 64, 2, 4), (128, 8, 1, 1)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_paged_attention_head_dims_and_blocks(dev, pool, hd, block, T, G, misaligned):
    """Head dims from 8 to 256 (one or two 4-dim slots a lane, idle lanes),
    blocks shorter than, longer than and not a multiple of the kernel's
    16-token tile, rows whose copies into shared memory take 16-, 4- or
    1-byte pieces (``misaligned``: the pools start one element past an
    aligned address); held to the plain version, two calls bit-identical."""
    K, B, mb = 2, 3, 6
    rng = np.random.default_rng(hd + block + T)
    n_blocks = B * mb + 1
    bt = (rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb).astype(np.int32)
    pos0 = (rng.integers(T - 1, mb * block, size=B) - (T - 1)).astype(np.int32)
    qdt = torch.bfloat16 if pool == "bfloat16" else torch.float32
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd)).astype(np.float32)).to(dev, qdt)
    kw = dict(scale=hd**-0.5, window=9 if T == 3 else None)
    if pool in ("q8", "q4"):
        bits = 8 if pool == "q8" else 4
        (kp, vp), (ke, ve) = _quant_pools(rng, n_blocks, block, K, hd, bits, wide=False)
        kw.update(k_scale_exp=ke.to(dev), v_scale_exp=ve.to(dev), kv_bits=bits)
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd))
                                   .astype(np.float32)) for _ in range(2))
        if pool == "int8":
            kp, vp = (torch.clamp(torch.round(x * 16), -127, 127).to(torch.int8) for x in (kp, vp))
            kw["kv_scale"] = 2.0**-5
        else:
            kp, vp = kp.to(getattr(torch, pool)), vp.to(getattr(torch, pool))
    kp, vp = kp.to(dev), vp.to(dev)
    if misaligned:  # the same pools, one element past an aligned start
        kp, vp = (torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape) for x in (kp, vp))
    bt_d, pos0_d = torch.from_numpy(bt).to(dev), torch.from_numpy(pos0).to(dev)
    got = paged_attention(q, kp, vp, bt_d, pos0_d, **kw)
    again = paged_attention(q, kp, vp, bt_d, pos0_d, **kw)
    want = paged_attention_ref(q, kp, vp, bt_d, pos0_d, **kw)
    torch.cuda.synchronize()
    tol = dict(rtol=2e-4, atol=2e-5) if qdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)


def test_paged_attention_rejects_head_dims_it_does_not_take(dev):
    q = torch.zeros((1, 1, 1, 1, 12), device=dev)
    pool = torch.zeros((2, 4, 1, 12), device=dev)
    bt = torch.ones((1, 1), dtype=torch.int32, device=dev)
    pos0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # not a multiple of 8
        paged_attention(q, pool, pool, bt, pos0, scale=1.0)
    q, pool = torch.zeros((1, 1, 1, 1, 264), device=dev), torch.zeros((2, 4, 1, 264), device=dev)
    with pytest.raises(ValueError):  # above 256
        paged_attention(q, pool, pool, bt, pos0, scale=1.0)


def test_kv_exponent_on_card_matches_cpu(dev):
    """The SYMOG exponent and quantizer write the same bits on the card as on
    the CPU (whose bits tests/test_torch_kv_exponent.py holds to jitted JAX),
    at every step point and its neighbours, and the arithmetic behind the
    step points on 1M random amaxes."""
    from repro_torch.models import attention as tatt
    from repro_torch.models import kv_exponent

    for qmax in (127, 7):
        th = kv_exponent.exponent_thresholds(qmax)
        a = torch.cat([th, torch.nextafter(th, torch.zeros(())), torch.nextafter(th, th * 2)])
        x = a[:, None] * torch.tensor([[1.0, -0.5, 0.25]])
        cpu = tatt.block_scale_exp(x, qmax)
        assert torch.equal(tatt.block_scale_exp(x.to(dev), qmax).cpu(), cpu)
        assert torch.equal(tatt.quantize_fixed(x.to(dev), cpu.to(dev), qmax).cpu(),
                           tatt.quantize_fixed(x, cpu, qmax))
        r = torch.exp2(torch.from_numpy(np.random.default_rng(qmax).uniform(-34, 34, 1 << 20))
                       .float())
        assert torch.equal(kv_exponent.jitted_exponent(r.to(dev), qmax).cpu(),
                           kv_exponent.jitted_exponent(r, qmax))
    assert torch.equal(kv_exponent._exp_f32(torch.arange(-20.0, 21.0, device=dev) * -0.6931472)
                       .cpu(), kv_exponent._exp_f32(torch.arange(-20.0, 21.0) * -0.6931472))


def _mla_operands(rng, dev, *, B, T, H, r, rope, block, mb, pool, qdt):
    """MLA decode operands: bf16 / fp32 queries; pools of the query dtype,
    KV_F int8, or SYMOG words with one exponent per physical block: the
    wide spread (random words, exponents over [-8, 4]) with bf16 queries,
    the words a paged write makes of unit-scale c_kv / k_rope with fp32
    queries (as the quantized GQA cases above); row 0 at position 0.  On
    the wide spread the queries are scaled by 1 / the pool's largest value
    (127 or 7 x 2^4) so that the logits stay O(1) as in serving: with unit
    queries they reach ~1e3, and in a near-tied row the fp32 summation order
    alone then moves the output past the bf16 bar (the kernel's and the
    plain version's errors against fp64 are alike: chip_smoke.py 3f)."""
    from repro_torch.models.attention import KV_QMAX, block_scale_exp, pack_int4, quantize_fixed

    n_blocks = B * mb + 1
    bt = (rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb).astype(np.int32)
    pos0 = (rng.integers(T - 1, mb * block, size=B) - (T - 1)).astype(np.int32)
    pos0[0] = 0
    wide = pool in ("int8", "int4") and qdt == torch.bfloat16
    q_mult = 1.0 / ((127 if pool == "int8" else 7) * 2**4) if wide else 1.0
    q_eff = torch.from_numpy(rng.standard_normal((B, T, H, r)).astype(np.float32) * q_mult)
    q_rope = torch.from_numpy(rng.standard_normal((B, T, H, rope)).astype(np.float32) * q_mult)
    q_eff, q_rope = q_eff.to(dev, qdt), q_rope.to(dev, qdt)
    kw = dict(scale=(128 + 64) ** -0.5)
    pools, exps = [], []
    for w in (r, rope):
        x = torch.from_numpy(rng.standard_normal((n_blocks, block, w)).astype(np.float32))
        if pool == "float":
            pools.append(x.to(qdt))
        elif pool == "kv_f":
            pools.append(torch.clamp(torch.round(x * 16), -127, 127).to(torch.int8))
        else:
            bits = 4 if pool == "int4" else 8
            qmax = KV_QMAX[bits]
            if wide:
                m = torch.from_numpy(rng.integers(-qmax, qmax + 1, size=(n_blocks, block, w))
                                     .astype(np.int8))
                e = torch.from_numpy(rng.integers(-8, 5, size=n_blocks).astype(np.int32))
            else:
                s = rng.integers(-3, 2, size=(n_blocks, 1, 1)).astype(np.float32)
                x = x * torch.from_numpy(np.exp2(s))
                e = block_scale_exp(x[:, 0], qmax)
                m = quantize_fixed(x, e[:, None], qmax)
            pools.append(pack_int4(m) if bits == 4 else m)
            exps.append(e.to(dev))
    if pool == "kv_f":
        kw["kv_scale"] = 2.0**-5
    elif exps:
        kw.update(ckv_scale_exp=exps[0], kr_scale_exp=exps[1], kv_bits=4 if pool == "int4" else 8)
    bt, pos0 = torch.from_numpy(bt).to(dev), torch.from_numpy(pos0).to(dev)
    return (q_eff, q_rope, pools[0].to(dev), pools[1].to(dev), bt, pos0), kw


MLA_COUNTERS = ("mla_launches", "mla_quant_launches", "mla_tc_launches", "mla_tc_quant_launches")


def _mla_counts():
    return tuple(getattr(aops, c) for c in MLA_COUNTERS)


def _mla_launched(before, route: str, quant: bool):
    """Exactly one MLA launch since ``before``: counted under its pool's
    family (float / quantized), and under the tensor-core route's own
    counter when ``route`` is 'tc'."""
    want = [0, 0, 0, 0]
    want[1 if quant else 0] = 1
    if route == "tc":
        want[3 if quant else 2] = 1
    return [a - b for a, b in zip(_mla_counts(), before)] == want


def _mla_routes(args, kw):
    """The routes that take a call: 'partial' always, 'tc' where the rule
    sends it (bf16 queries over a pool exact in bf16, widths of 16)."""
    q_eff, q_rope, cp = args[:3]
    rule = aops._mla_route(q_eff.dtype, cp.dtype, kw.get("kv_bits", 0), kw.get("kv_scale", 1.0),
                           q_eff.shape[-1], q_rope.shape[-1])
    return rule, ["partial"] + (["tc"] if rule == "tc" else [])


@pytest.mark.parametrize("pool", ["float", "kv_f", "int8", "int4"])
@pytest.mark.parametrize("shape", [
    # deepseek-v3's decode (H 128, r 512, rope 64, 4 rows of up to 320 tokens),
    # T = 3, and small widths that take the kernel's scalar (unvectorized) loads
    dict(B=4, T=1, H=128, r=512, rope=64, block=16, mb=20),
    dict(B=3, T=3, H=8, r=64, rope=16, block=8, mb=9),
    dict(B=2, T=2, H=5, r=36, rope=6, block=4, mb=7),
])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_paged_attention_mla_matches_plain(dev, pool, shape, qdtype):
    """Every route that takes the call (the rule's choice unforced, then each
    route forced) against the plain version at the attention bar, counted
    under its route, the same bits on a second call."""
    qdt = getattr(torch, qdtype)
    rng = np.random.default_rng(shape["H"] + shape["T"])
    args, kw = _mla_operands(rng, dev, pool=pool, qdt=qdt, **shape)
    quant = "kv_bits" in kw
    rule, routes = _mla_routes(args, kw)
    assert rule == ("tc" if qdt == torch.bfloat16 and shape["r"] % 16 == 0 else "partial")
    want = paged_attention_mla_ref(*args, **kw)
    tol = dict(rtol=2e-4, atol=2e-5) if qdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for route in [None] + routes:
        before = _mla_counts()
        got = paged_attention_mla(*args, **kw, _route=route)
        torch.cuda.synchronize()
        assert _mla_launched(before, route or rule, quant), route
        assert got.dtype == qdt and got.shape == args[0].shape
        torch.testing.assert_close(got.float(), want.float(), **tol)
        # deterministic: the same call gives the same bits
        assert torch.equal(paged_attention_mla(*args, **kw, _route=route), got)


MLA_POOLS = ["bfloat16", "float32", "kv_f", "int8", "int4"]


@pytest.mark.parametrize("pool", MLA_POOLS)
@pytest.mark.parametrize("T,H", [(1, 128), (3, 8), (4, 5), (1, 40)])
def test_paged_attention_mla_ragged_rows(dev, pool, T, H):
    """Rows from position 0 to the table's last slot in one batch (one block
    visible to the first, all 32 to the last), their table entries past each
    row's length on the trash block 0.  Every block no row can see -- the
    trash block and the blocks past each row's last position -- is poisoned:
    NaN in float pools, exponent 1000 (2^1000 = inf) in SYMOG pools, so that
    one read of it reaches the output (0 x NaN, 0 x inf).  The queries are
    the head of a buffer whose tail is NaN: a padded row of the last row
    tile (T·H not a multiple of 32 or 16) that read its query would do the
    same.  Every route that takes the call, held to the plain version on
    clean pools at the attention bar; a second call gives the same bits."""
    r, rope, block, mb, B = 64, 16, 16, 32, 6
    rng = np.random.default_rng(T * 100 + H)
    pos_last = np.linspace(T - 1, mb * block - 1, B).round().astype(np.int64)
    pos0 = (pos_last - (T - 1)).astype(np.int32)
    n_blocks = B * mb + 1
    ids = rng.permutation(n_blocks - 1)[: B * mb].reshape(B, mb) + 1
    bt = np.zeros((B, mb), np.int32)
    hidden = [0]  # physical blocks no row sees
    for b in range(B):
        n_own = pos_last[b] // block + 1
        bt[b, :n_own] = ids[b, :n_own]
        hidden += [int(x) for x in ids[b, n_own:]]
    qdt = torch.float32 if pool == "float32" else torch.bfloat16
    kind = {"bfloat16": "float", "float32": "float"}.get(pool, pool)
    args, kw = _mla_operands(np.random.default_rng(1), dev, B=B, T=T, H=H, r=r, rope=rope,
                             block=block, mb=mb, pool=kind, qdt=qdt)
    q_eff, q_rope, cp, kp, _, _ = args
    bt_d, pos0_d = torch.from_numpy(bt).to(dev), torch.from_numpy(pos0).to(dev)
    clean = (q_eff, q_rope, cp, kp, bt_d, pos0_d)
    want = paged_attention_mla_ref(*clean, **kw)

    def nan_tail(x):  # x's values at the head of a buffer of NaN
        buf = torch.full((x.numel() + 64 * x.shape[-1],), float("nan"), dtype=x.dtype, device=dev)
        buf[: x.numel()] = x.reshape(-1)
        return buf[: x.numel()].view(x.shape)

    cp, kp = cp.clone(), kp.clone()
    if "kv_bits" in kw:
        for k in ("ckv_scale_exp", "kr_scale_exp"):
            kw[k] = kw[k].clone()
            kw[k][hidden] = 1000
    elif cp.is_floating_point():
        cp[hidden], kp[hidden] = float("nan"), float("nan")
    poisoned = (nan_tail(q_eff), nan_tail(q_rope), cp, kp, bt_d, pos0_d)
    tol = dict(rtol=2e-4, atol=2e-5) if qdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    _, routes = _mla_routes(clean, kw)
    assert routes == (["partial"] if pool == "float32" else ["partial", "tc"])
    for route in routes:
        got = paged_attention_mla(*poisoned, **kw, _route=route)
        again = paged_attention_mla(*poisoned, **kw, _route=route)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), route
        torch.testing.assert_close(got.float(), want.float(), **tol, msg=route)
        assert torch.equal(got, again), route


@pytest.mark.parametrize("pool", ["float", "kv_f", "int8", "int4"])
@pytest.mark.parametrize("T", [1, 3])
def test_mla_tensor_cores_match_partial(dev, pool, T):
    """The tensor-core kernel against mla_partial on the same bf16 inputs at
    deepseek-v3's widths (H 128, r 512, rope 64): both round one fp32
    result to bf16, so they agree at the bf16 bar."""
    rng = np.random.default_rng(40 + T)
    args, kw = _mla_operands(rng, dev, B=4, T=T, H=128, r=512, rope=64, block=16, mb=20,
                             pool=pool, qdt=torch.bfloat16)
    tc = paged_attention_mla(*args, **kw, _route="tc")
    fp = paged_attention_mla(*args, **kw, _route="partial")
    torch.testing.assert_close(tc.float(), fp.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("n_split", range(1, 9))
@pytest.mark.parametrize("pool", ["float", "int4"])
def test_mla_tensor_cores_cluster_sizes(dev, n_split, pool):
    """Clusters of 1..8 ranks, forced: some ranks hold no tile (short rows,
    the row at position 0), the merge reads every rank in rank order; held
    to the plain version, the same bits on a second call."""
    rng = np.random.default_rng(n_split)
    args, kw = _mla_operands(rng, dev, B=3, T=2, H=24, r=128, rope=32, block=16, mb=6,
                             pool=pool, qdt=torch.bfloat16)
    before = _mla_counts()
    got = paged_attention_mla(*args, **kw, _route="tc", _split=n_split)
    torch.cuda.synchronize()
    assert _mla_launched(before, "tc", pool == "int4")
    want = paged_attention_mla_ref(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    assert torch.equal(paged_attention_mla(*args, **kw, _route="tc", _split=n_split), got)


def test_mla_tensor_cores_refuse_what_they_do_not_take(dev):
    """Forcing the tensor-core route where the rule would not take it
    raises, and launches nothing: fp32 queries, an fp32 pool, a KV_F scale
    that is not a power of two, a bf16 pool under a scale, widths not of
    16, a cluster of 9; and a cluster size is the tensor-core route's."""
    rng = np.random.default_rng(3)
    args, kw = _mla_operands(rng, dev, B=2, T=1, H=8, r=64, rope=16, block=8, mb=3,
                             pool="float", qdt=torch.bfloat16)
    q_eff, q_rope, cp, kp, bt, pos0 = args
    kf = _mla_operands(rng, dev, B=2, T=1, H=8, r=64, rope=16, block=8, mb=3, pool="kv_f",
                       qdt=torch.bfloat16)[0]
    odd = _mla_operands(rng, dev, B=2, T=1, H=8, r=36, rope=6, block=8, mb=3, pool="float",
                        qdt=torch.bfloat16)[0]
    s = kw["scale"]
    before = _mla_counts()
    cases = [
        ((q_eff.float(), q_rope.float(), cp.float(), kp.float(), bt, pos0), {}),  # fp32 q
        ((q_eff, q_rope, cp.float(), kp.float(), bt, pos0), {}),  # fp32 pool
        (kf, dict(kv_scale=0.03)),  # KV_F scale not a power of two
        (args, dict(kv_scale=0.5)),  # a bf16 pool under a scale
        (odd, {}),  # r 36, rope 6
    ]
    for a, extra in cases:
        with pytest.raises(ValueError):
            paged_attention_mla(*a, scale=s, **extra, _route="tc")
    with pytest.raises(ValueError):
        paged_attention_mla(*args, scale=s, _route="tc", _split=9)
    with pytest.raises(ValueError):
        paged_attention_mla(*args, scale=s, _route="partial", _split=2)
    with pytest.raises(ValueError):
        paged_attention_mla(*args, scale=s, _route="wgmma")
    assert _mla_counts() == before


def test_paged_attention_mla_rejects_bad_operands(dev):
    rng = np.random.default_rng(0)
    args, kw = _mla_operands(rng, dev, B=2, T=1, H=4, r=32, rope=16, block=8, mb=3, pool="int4",
                             qdt=torch.bfloat16)
    q_eff, q_rope, cp, kp, bt, pos0 = args
    ce, re = kw["ckv_scale_exp"], kw["kr_scale_exp"]
    s = kw["scale"]
    with pytest.raises(ValueError):  # int4 words read as int8: the word width is wrong
        paged_attention_mla(*args, scale=s, ckv_scale_exp=ce, kr_scale_exp=re, kv_bits=8)
    with pytest.raises(ValueError):  # exponents of the wrong shape
        paged_attention_mla(*args, scale=s, ckv_scale_exp=ce[:3], kr_scale_exp=re, kv_bits=4)
    with pytest.raises(ValueError):  # exponents on another device
        paged_attention_mla(*args, scale=s, ckv_scale_exp=ce.cpu(), kr_scale_exp=re, kv_bits=4)
    with pytest.raises(TypeError):  # q_eff and q_rope of different dtypes
        paged_attention_mla(q_eff, q_rope.float(), cp, kp, bt, pos0, scale=s, ckv_scale_exp=ce,
                            kr_scale_exp=re, kv_bits=4)
    with pytest.raises(ValueError):  # int64 tables
        paged_attention_mla(q_eff, q_rope, cp, kp, bt.long(), pos0, scale=s, ckv_scale_exp=ce,
                            kr_scale_exp=re, kv_bits=4)


def _symog_case(dev, n, n_bits, case, seed):
    """(w, g, v, kw) on the card: 'random', 'ties' (half of w exactly on
    (k+½)Δ, g = v = 0, λ_eff = 1: a wrong rounding moves v' by Δ), 'clip'
    (a third of |w| far above Δ·qmax) or 'misaligned' (views 4 bytes off a
    16-byte boundary: the scalar path)."""
    rng = np.random.default_rng(seed)
    delta, q = 2.0**-3, 2 ** (n_bits - 1) - 1
    w = (rng.standard_normal(n) * 0.3).astype(np.float32)
    g = (rng.standard_normal(n) * 0.05).astype(np.float32)
    v = (rng.standard_normal(n) * 0.01).astype(np.float32)
    kw = dict(delta=delta, lam_eff=0.7, lr=0.01, mu=0.9, n_bits=n_bits)
    if case == "ties":
        k = rng.integers(-q - 1, q + 1, size=n // 2)
        w[: n // 2] = (k + 0.5) * delta
        g[:], v[:] = 0.0, 0.0
        kw.update(lam_eff=1.0, lr=1e-3)
    if case == "clip":
        w[: n // 3] = rng.choice([-1.0, 1.0], size=n // 3) * (q + 3) * delta
    ts = [torch.from_numpy(a).to(dev) for a in (w, g, v)]
    if case == "misaligned":
        ts = [torch.cat([torch.zeros(1, device=dev), t])[1:] for t in ts]
    return ts, kw


@pytest.mark.parametrize("n,n_bits,case", [
    (1_000_003, 2, "random"), (1 << 20, 4, "random"), (7, 2, "random"), (4096, 2, "ties"),
    (4099, 4, "ties"), (65536, 2, "clip"), (65536, 4, "clip"), (10_001, 2, "misaligned"),
])
def test_symog_update_matches_plain(dev, n, n_bits, case):
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update import symog_update
    from repro_torch.kernels.symog_update.ref import symog_update_ref

    (w, g, v), kw = _symog_case(dev, n, n_bits, case, seed=n % 97)
    want_w, want_v = symog_update_ref(w, g, v, **kw)
    before = sops.launches
    got_w, got_v = symog_update(w, g, v, **kw)
    torch.cuda.synchronize()
    assert sops.launches == before + 1 and got_w is w and got_v is v
    torch.testing.assert_close(got_w, want_w, rtol=1e-6, atol=1e-7)  # tests/test_kernels.py
    torch.testing.assert_close(got_v, want_v, rtol=1e-6, atol=1e-7)


def test_symog_update_rejects_bad_operands_on_card(dev):
    from repro_torch.kernels.symog_update import symog_update

    w = torch.zeros(64, device=dev)
    kw = dict(delta=0.25, lam_eff=0.1, lr=0.01, mu=0.9)
    with pytest.raises(TypeError):
        symog_update(w, w.to(torch.bfloat16), w.clone(), **kw)
    with pytest.raises(ValueError):
        symog_update(w, w.cpu(), w.clone(), **kw)
    with pytest.raises(ValueError):
        symog_update(w, w.clone(), w.clone(), **dict(kw, delta=torch.tensor(0.25)))  # CPU Δ


def test_fused_train_step_matches_composed(dev):
    """A 2-layer internlm2-shaped model: from one set of grads the fused
    route (8 kernel launches: embed + 7 stacked projections) equals the
    composed route; then one whole fused train step runs on the kernels."""
    import dataclasses

    from repro_torch import configs, core, optim
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm, lm_train_loss
    from repro_torch.nn.tree import flatten_with_paths, tree_map
    from repro_torch.train import (composed_update, fused_update, init_train_state,
                                   make_train_step)
    from repro_torch.train.trainer import _accum_grads

    cfg = dataclasses.replace(configs.get_config("internlm2-1.8b"), n_layers=2, d_model=512,
                              n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=8192)
    tx = optim.sgd(momentum=0.9)
    scfg = core.SymogConfig(n_bits=2, total_steps=10)
    st = init_train_state(init_lm(0, cfg, device=dev), tx, scfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device=dev)
    _, _, grads = _accum_grads(lambda p, b: lm_train_loss(p, b, cfg), st.params,
                               {"tokens": tok}, 1)
    lam, lr = core.lambda_at(scfg, 5), 0.01
    cp, cv = composed_update(st.params, grads, st.opt_state, st.symog, scfg, tx, lr=lr, lam=lam)
    before = sops.launches
    fp, fv = fused_update(tree_map(torch.clone, st.params), grads,
                          tree_map(torch.clone, st.opt_state), st.symog, scfg, tx, lr=lr, lam=lam)
    torch.cuda.synchronize()
    assert sops.launches == before + 8
    for (path, a), (_, b) in zip(flatten_with_paths(fp), flatten_with_paths(cp)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=path)
    for (path, a), (_, b) in zip(flatten_with_paths(fv), flatten_with_paths(cv)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=path)
    step = make_train_step(cfg, tx, core.constant(0.01), symog_cfg=scfg)
    before = sops.launches
    st, m = step(st, {"tokens": tok})
    torch.cuda.synchronize()
    assert sops.launches == before + 8 and bool(torch.isfinite(m["loss"]))


@pytest.mark.parametrize("bits", [0, 4])
@pytest.mark.parametrize("T,pos0,window,K,G,hd,q_mult,cap", [
    (32, 0, 1024, 4, 2, 256, 1.0, 0.0), (160, 0, 64, 4, 2, 256, 1.0, 0.0),
    (96, 40, None, 4, 2, 256, 1.0, 0.0), (1, 300, None, 1, 48, 128, 1.0, 0.0),
    (24, 8, 16, 1, 48, 128, 1.0, 0.0),
    (2048, 0, 64, 4, 2, 256, 4.0, 0.0), (2048, 1000, 64, 4, 2, 256, 4.0, 2.0),
])
def test_paged_attention_tail_prefill_shapes(dev, bits, T, pos0, window, K, G, hd, q_mult, cap):
    """The tail-prefill launches (B 1, T = a bucket of query rows from pos0)
    and the dense configs' decode shapes: head_dim 256 (gemma3), K 1 and
    G 48 (granite), windows that bind; bf16 queries over a bf16 pool or an
    int4 SYMOG pool at the bf16 bar, bit-identical over two calls.

    Over ~1,000 keys unit queries give outputs the bar cannot tell from a
    dropped tile; the q_mult 4 cases (window 64, binding on every row past
    64, one under a softcap of 2) are sharp enough that the plain version
    with its window a block wider or narrower, or its causal horizon one
    key later, fails the bar the kernel passes."""
    block = 16
    mb = max(24, -(-(pos0 + T) // block))
    rng = np.random.default_rng(T + pos0 + bits)
    n_blocks = mb + 1
    bt = torch.from_numpy((rng.permutation(mb) + 1).astype(np.int32)[None]).to(dev)
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal((1, T, K, G, hd)).astype(np.float32) * q_mult).to(
        dev, torch.bfloat16)
    kw = dict(scale=hd**-0.5, window=window, cap=cap)
    if bits:
        (kp, vp), (ke, ve) = _quant_pools(rng, n_blocks, block, K, hd, bits, wide=False)
        kp, vp = kp.to(dev), vp.to(dev)
        kw.update(k_scale_exp=ke.to(dev), v_scale_exp=ve.to(dev), kv_bits=bits)
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd)).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    got = paged_attention(q, kp, vp, bt, p0, **kw)
    again = paged_attention(q, kp, vp, bt, p0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = paged_attention_ref(q, kp, vp, bt, p0, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    if q_mult != 1.0:
        for fp0, fkw in ((p0, dict(kw, window=window + block)),
                         (p0, dict(kw, window=window - block)), (p0 + 1, kw)):
            bad = paged_attention_ref(q, kp, vp, bt, fp0, **fkw)
            assert not torch.allclose(got.float(), bad.float(), rtol=1e-2, atol=1e-2)


def test_sampler_on_card_matches_cpu(dev):
    """The sampler's uniforms are integer hashing up to one exact conversion,
    so the card's equal the CPU's bit for bit; the draws agree too."""
    from repro_torch.serve import sample_tokens
    from repro_torch.serve.engine import sample_uniform

    streams = torch.arange(256, dtype=torch.int64) * 1_000_003 + 7
    assert torch.equal(sample_uniform(123, streams.to(dev), 4096).cpu(),
                       sample_uniform(123, streams, 4096))
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 512)).astype(
        np.float32))
    for top_k in (0, 50):
        got = sample_tokens(logits.to(dev), streams.to(dev), 123, 0.7, top_k).cpu()
        assert torch.equal(got, sample_tokens(logits, streams, 123, 0.7, top_k))
