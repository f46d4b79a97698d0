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


PREFILL_POOLS = ["bf16", "kv_f", "q8", "q4"]  # pool codes 1-4: exact in bf16


def _prefill_case(dev, rng, *, pool, B, T, K, G, hd, block, mb, pos0, wide=True):
    """bf16 queries and a pool the prefill route takes: bf16, KV_F int8 x
    2^-5, or SYMOG int8 / int4 words (``wide``: under the wide exponent
    spread, |v| up to 127·2^4; else as a paged write makes them of
    unit-scale k / v); a shuffled block table; ``pos0`` per row."""
    n_blocks = B * mb + 1
    bt = (rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd)).astype(np.float32))
    kw = {}
    if pool in ("q8", "q4"):
        bits = 8 if pool == "q8" else 4
        (kp, vp), (ke, ve) = _quant_pools(rng, n_blocks, block, K, hd, bits, wide=wide)
        kw = dict(k_scale_exp=ke.to(dev), v_scale_exp=ve.to(dev), kv_bits=bits)
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd))
                                   .astype(np.float32)) for _ in range(2))
        if pool == "kv_f":
            kp, vp = (torch.clamp(torch.round(x * 16), -127, 127).to(torch.int8) for x in (kp, vp))
            kw["kv_scale"] = 2.0**-5
        else:
            kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    return (q.to(dev, torch.bfloat16), kp.to(dev), vp.to(dev), torch.from_numpy(bt).to(dev),
            torch.tensor(pos0, dtype=torch.int32, device=dev), kw)


def _prefill_counts():
    return (aops.launches, aops.quant_launches, aops.prefill_launches,
            aops.prefill_quant_launches)


@pytest.mark.parametrize("pool", PREFILL_POOLS)
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T,G", [(63, 1), (32, 2), (65, 1), (64, 8)])  # T·G 63 / 64 / 65 / 512
@pytest.mark.parametrize("window,cap", [(None, 0.0), (40, 5.0)])
def test_paged_attention_prefill_matches_plain(dev, monkeypatch, pool, hd, T, G, window, cap):
    """The tensor-core prefill route against the plain version at the bf16
    bar over ragged rows (from position 0, mid-block, and running to the
    table's last slot), two calls bit-identical, its launch counted under
    both its route's counter and the row's; the decode route forced on the
    same inputs holds the same bar.  SYMOG pools under the wide exponent
    spread up to hd 128; at hd 256 its logits reach the thousands, where
    two fp32 sums of q.k in another order (the plain version's and any
    kernel's) move a near-one-hot softmax past the bf16 bar, so hd 256
    takes the pools a paged write makes (gemma3's serving shape)."""
    K, block, B = 2, 16, 3
    mb = -(-(200 + T) // block)
    rng = np.random.default_rng(hd + T * 7 + G)
    pos0 = [0, 21, mb * block - T]
    q, kp, vp, bt, p0, kw = _prefill_case(dev, rng, pool=pool, B=B, T=T, K=K, G=G, hd=hd,
                                          block=block, mb=mb, pos0=pos0, wide=hd <= 128)
    kw.update(scale=hd**-0.5, cap=cap, window=window)
    quant = pool in ("q8", "q4")
    route = aops._gqa_route(q.dtype, aops._pool_code(kp.dtype, kw.get("kv_bits", 0)),
                            kw.get("kv_scale", 1.0), hd, block, T * G)
    assert route == ("prefill" if T * G >= aops.PREFILL_MIN_ROWS else "decode")
    # the prefill kernel at every T·G here, below the rule's threshold too
    monkeypatch.setattr(aops, "PREFILL_MIN_ROWS", 1)
    before = _prefill_counts()
    got = paged_attention(q, kp, vp, bt, p0, **kw)
    again = paged_attention(q, kp, vp, bt, p0, **kw)
    torch.cuda.synchronize()
    after = _prefill_counts()
    assert [a - b for a, b in zip(after, before)] == ([0, 2, 0, 2] if quant else [2, 0, 2, 0])
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    want = paged_attention_ref(q, kp, vp, bt, p0, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    dec = paged_attention(q, kp, vp, bt, p0, _route="decode", **kw)
    torch.cuda.synchronize()
    assert _prefill_counts()[2:] == after[2:]  # the forced decode route: not gqa_prefill
    torch.testing.assert_close(dec.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("pool", ["bf16", "q4"])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_attention_prefill_ragged_rows_and_splits(dev, pool, window):
    """Four query tiles a KV head (T 100, G 2) on rows from position 0 to
    the table's last slot, their spare table entries on the trash block;
    every block no row sees (the trash block, blocks wholly before every
    window) filled with NaN in the bf16 pool: a read of it would reach the
    output through p . v.  B 1 and K 1 put 4 query tiles on the card, so the
    key range splits over a cluster; held to the plain version on clean
    pools, two calls bit-identical."""
    K, G, hd, block, mb, T = 1, 2, 128, 16, 40, 100
    for B in (5, 1):
        rng = np.random.default_rng(B + (window or 0))
        pos_last = np.linspace(T - 1, mb * block - 1, B).round().astype(np.int64)
        pos0 = (pos_last - (T - 1)).astype(np.int32)
        q, kp, vp, _, p0, kw = _prefill_case(dev, rng, pool=pool, B=B, T=T, K=K, G=G, hd=hd,
                                             block=block, mb=mb, pos0=pos0.tolist())
        ids = rng.permutation(kp.shape[0] - 1)[: B * mb].reshape(B, mb) + 1
        bt = np.zeros((B, mb), np.int32)
        hidden = [0]
        w = aops._NO_WINDOW if window is None else window
        for b in range(B):
            n_own = pos_last[b] // block + 1
            bt[b, :n_own] = ids[b, :n_own]
            lo = max(0, int(pos0[b]) - w + 1) // block
            hidden += [int(ids[b, j]) for j in range(n_own) if j < lo]
        bt = torch.from_numpy(bt).to(dev)
        kw.update(scale=hd**-0.5, window=window)
        want = paged_attention_ref(q, kp, vp, bt, p0, **kw)
        if pool == "bf16":
            kp[hidden], vp[hidden] = float("nan"), float("nan")
        got = paged_attention(q, kp, vp, bt, p0, _route="prefill", **kw)
        again = paged_attention(q, kp, vp, bt, p0, _route="prefill", **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    assert aops._prefill_split(1, 1, 4, mb, block, 132) == 4


def test_paged_attention_prefill_refuses_what_it_does_not_take(dev):
    """A forced 'prefill' raises ValueError where the rule gives 'decode':
    fp32 queries, an fp32 pool, a bf16 pool under a scale, hd not a multiple
    of 16, a block not a multiple of 16, too few rows, a misaligned pool."""
    rng = np.random.default_rng(0)
    base = dict(pool="bf16", B=1, T=32, K=2, G=2, hd=64, block=16, mb=4, pos0=[0])
    q, kp, vp, bt, p0, kw = _prefill_case(dev, rng, **base)
    paged_attention(q, kp, vp, bt, p0, scale=0.125, _route="prefill")  # taken
    bad = [
        (q.float(), kp, vp, bt, dict()),
        (q, kp.float(), vp.float(), bt, dict()),
        (q, kp, vp, bt, dict(kv_scale=0.5)),
        (q[:, :4], kp, vp, bt, dict()),
        (q, *(torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape) for x in (kp, vp)),
         bt, dict()),
    ]
    q72, k72, v72, bt72, _, _ = _prefill_case(dev, rng, **dict(base, hd=72))
    bad.append((q72, k72, v72, bt72, dict()))
    q8, k8, v8, bt8, _, _ = _prefill_case(dev, rng, **dict(base, block=8, mb=8))
    bad.append((q8, k8, v8, bt8, dict()))
    for qq, kk, vv, bb, extra in bad:
        with pytest.raises(ValueError):
            paged_attention(qq, kk, vv, bb, p0, scale=0.125, _route="prefill", **extra)


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
    # the speculative verify's shape: T = k + 1 = 5 query rows a batch row
    dict(B=4, T=5, H=128, r=512, rope=64, block=16, mb=20),
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
@pytest.mark.parametrize("T,H", [(1, 128), (3, 8), (4, 5), (1, 40), (5, 128)])
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


@pytest.mark.parametrize("pool", ["bfloat16", "q4"])
def test_paged_attention_verify_shape(dev, pool):
    """The speculative verify's launch (internlm2: K 8, G 2, hd 128; B 4,
    T 5 = k + 1): ragged pos0 of about 300 tokens, and a row whose last
    query positions run past its table's end (max_blocks·block), which
    the kernel clamps to the table's last slot.  Every physical block no
    row's table names is NaN in the bf16 pool (exponent 1000 in the int4
    one): a read of any column past a table reaches the output.  Held to
    the plain version on clean pools, the same bits on a second call."""
    K, G, hd, block, mb, B, T = 8, 2, 128, 16, 32, 4, 5
    rng = np.random.default_rng(55)
    pos0 = np.asarray([290, 301, 312, mb * block - 2], np.int32)  # the last: 510..514
    n_blocks = 2 * B * mb + 1
    ids = rng.permutation(n_blocks - 1)[: B * mb].reshape(B, mb) + 1
    bt = np.zeros((B, mb), np.int32)
    for b in range(B):
        n_own = min(mb, (int(pos0[b]) + T - 1) // block + 1)
        bt[b, :n_own] = ids[b, :n_own]
    hidden = sorted(set(range(n_blocks)) - set(bt[bt > 0].tolist()))
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd)).astype(np.float32)).to(
        dev, torch.bfloat16)
    kw = dict(scale=hd**-0.5)
    if pool == "q4":
        (kp, vp), (ke, ve) = _quant_pools(rng, n_blocks, block, K, hd, 4, wide=False)
        kw.update(k_scale_exp=ke.to(dev), v_scale_exp=ve.to(dev), kv_bits=4)
        kp, vp = kp.to(dev), vp.to(dev)
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd)).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    bt_d, pos0_d = torch.from_numpy(bt).to(dev), torch.from_numpy(pos0).to(dev)
    want = paged_attention_ref(q, kp, vp, bt_d, pos0_d, **kw)
    if pool == "q4":
        for k in ("k_scale_exp", "v_scale_exp"):
            kw[k] = kw[k].clone()
            kw[k][hidden] = 1000
    else:
        kp, vp = kp.clone(), vp.clone()
        kp[hidden], vp[hidden] = float("nan"), float("nan")
    got = paged_attention(q, kp, vp, bt_d, pos0_d, **kw)
    again = paged_attention(q, kp, vp, bt_d, pos0_d, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("T,pos0,window", [(256, 1000, 1024), (256, 1024, None),
                                           (32, 1000, 1024), (3, 9, 8)])
def test_paged_attention_chunk_and_hit_shapes(dev, T, pos0, window):
    """gemma3's chunk and prefix-hit tails (B 1, K 4, G 2, hd 256, int4
    pool): T 256 from a mid-block start (1,000) and from a block boundary
    (1,024), T 32 from 1,000, and a short chunk under a binding window,
    held to the plain version; blocks past the tail's last position are
    poisoned (exponent 1000)."""
    K, G, hd, block = 4, 2, 256, 16
    mb = -(-(pos0 + T) // block) + 2
    rng = np.random.default_rng(T + pos0)
    n_blocks = mb + 1
    bt = (rng.permutation(mb) + 1).astype(np.int32)
    n_own = (pos0 + T - 1) // block + 1
    hidden = [0] + bt[n_own:].tolist()
    bt[n_own:] = 0
    (kp, vp), (ke, ve) = _quant_pools(rng, n_blocks, block, K, hd, 4, wide=False)
    q = torch.from_numpy(rng.standard_normal((1, T, K, G, hd)).astype(np.float32)).to(
        dev, torch.bfloat16)
    bt_d = torch.from_numpy(bt[None]).to(dev)
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    kw = dict(scale=hd**-0.5, window=window, kv_bits=4, k_scale_exp=ke.to(dev),
              v_scale_exp=ve.to(dev))
    kp, vp = kp.to(dev), vp.to(dev)
    want = paged_attention_ref(q, kp, vp, bt_d, p0, **kw)
    for k in ("k_scale_exp", "v_scale_exp"):
        kw[k] = kw[k].clone()
        kw[k][hidden] = 1000
    got = paged_attention(q, kp, vp, bt_d, p0, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, paged_attention(q, kp, vp, bt_d, p0, **kw))
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def _reduced_engines(dev, arch="gemma3-4b", kv="bf16"):
    """(quantize_tree engine, pack_tree tree) of ``arch``'s reduced config
    on ``dev``, fp32 compute, from the port's seeded init_lm."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, quantize_tree, symog_init
    from repro_torch.models import init_lm
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(configs.get_reduced(arch), kv_cache_dtype=kv)
    params = init_lm(0, cfg, device=dev)
    scfg = SymogConfig(n_bits=2, total_steps=1)
    st = symog_init(params, scfg)
    eng = ServeEngine(cfg, quantize_tree(params, st, scfg), max_len=32,
                      compute_dtype=torch.float32, device=dev)
    return eng, pack_tree(params, st, scfg)


@pytest.mark.parametrize("kv", ["bf16", "int4_fp"])
def test_cow_copy_on_card_matches_cpu(dev, kv):
    from repro_torch.serve import Scheduler, ServeConfig

    eng, _ = _reduced_engines(dev, kv=kv)
    sched = Scheduler(eng, ServeConfig(n_slots=1, block_size=4))
    gen = torch.Generator().manual_seed(0)
    host = {}
    for g, sub in sched.caches.items():
        for name, leaf in sub["sub0"].items():
            host[g, name] = torch.randint(-100, 100, leaf.shape, generator=gen).to(leaf.dtype)
            leaf.copy_(host[g, name].to(dev))
    cpu = {g: {"sub0": {name: host[g, name].clone() for name in sub["sub0"]}}
           for g, sub in sched.caches.items()}
    fns = eng.scheduler_fns(greedy=True, top_k=0)
    fns.cow_copy(sched.caches, 3, 6)
    fns.cow_copy(cpu, 3, 6)
    torch.cuda.synchronize()
    for g, sub in sched.caches.items():
        for name, leaf in sub["sub0"].items():
            assert torch.equal(leaf.cpu(), cpu[g]["sub0"][name]), (g, name)
            assert not torch.equal(leaf.cpu(), host[g, name]), (g, name)


@pytest.mark.parametrize("kv", ["bf16", "int4_fp"])
def test_speculative_serve_on_card_matches_generate_static(dev, kv):
    """Reduced gemma3, fp32: the quantize_tree target with its 2-bit
    pack_tree twin as the draft (the draft's matmuls and both pools'
    attention on the kernels; the verify launches the GQA kernel at T = k +
    1).  From a float pool it serves the greedy stream of the card's static
    loop (dense caches).  An int4 pool rounds k/v, which the static loop's
    caches do not, so there the bar is a repeat giving the same tokens."""
    from repro_torch.serve import Request, ServeConfig, SpeculativeConfig

    eng, draft = _reduced_engines(dev, kv=kv)
    rng = np.random.default_rng(8)
    reqs = [Request(tokens=rng.integers(0, eng.cfg.vocab_size, size=L).astype(np.int32),
                    max_new_tokens=b) for L, b in ((3, 9), (11, 12), (6, 5))]
    sc = ServeConfig(n_slots=2, block_size=4, speculative=SpeculativeConfig(draft=draft, k=4))
    before = aops.quant_launches if kv != "bf16" else aops.launches
    comps, sched = eng.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    assert sched.stats["spec_steps"] > 0
    assert (aops.quant_launches if kv != "bf16" else aops.launches) > before
    if kv != "bf16":
        assert [c.tokens for c in eng.serve(reqs, sc)] == [c.tokens for c in comps]
        return
    for r, c in zip(reqs, comps):
        want = eng.generate_static({"tokens": torch.from_numpy(np.asarray(r.tokens)[None])},
                                   r.max_new_tokens)[0].tolist()
        assert c.tokens == want


def _packed_engine(dev, kv="int4_fp"):
    """Reduced internlm2, 2-bit packed, fp32 compute, on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import SymogConfig, symog_init
    from repro_torch.models import init_lm
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(configs.get_reduced("internlm2-1.8b"), kv_cache_dtype=kv)
    params = init_lm(0, cfg, device=dev)
    scfg = SymogConfig(n_bits=2, total_steps=1)
    return ServeEngine.from_symog(cfg, params, symog_init(params, scfg), scfg, max_len=32,
                                  compute_dtype=torch.float32, device=dev)


@pytest.mark.parametrize("kv", ["bf16", "int4_fp"])
def test_async_streams_on_card_match_sync(dev, kv):
    """The async front end steps the scheduler on worker threads: its
    streams (``tokens()``, per-request ``on_token``) equal the synchronous
    serve's tokens, and the worker threads ran the kernels (the packed
    matmul and the attention kernel of the pool's kind)."""
    import asyncio

    from repro_torch.serve import Request, ServeConfig

    eng = _packed_engine(dev, kv)
    rng = np.random.default_rng(4)
    reqs = [Request(tokens=rng.integers(0, eng.cfg.vocab_size, size=L).astype(np.int32),
                    max_new_tokens=b) for L, b in ((3, 7), (9, 5), (5, 9), (12, 4))]
    sc = ServeConfig(n_slots=2, block_size=4)
    want = [c.tokens for c in eng.serve(reqs, sc)]
    streamed = {}

    async def main():
        async with eng.serve_async(sc) as srv:
            ids = [srv.submit(r, on_token=lambda i, t: streamed.setdefault(i, []).append(t))
                   for r in reqs]
            streams = await asyncio.gather(*[_collect(srv.tokens(i)) for i in ids])
            return ids, streams, await srv.drain()

    async def _collect(agen):
        return [t async for t in agen]

    before = (fops.decode_launches + fops.launches,
              aops.quant_launches if kv != "bf16" else aops.launches)
    ids, streams, comps = asyncio.run(main())
    torch.cuda.synchronize()
    after = (fops.decode_launches + fops.launches,
             aops.quant_launches if kv != "bf16" else aops.launches)
    assert all(a > b for a, b in zip(after, before))
    assert [c.tokens for c in comps] == want == streams
    assert [streamed[i] for i in ids] == want


def test_cancel_on_card_frees_blocks(dev):
    """A request cancelled mid-decode on the card: its blocks return to the
    pool at once (audit clean), the survivor's tokens equal an undisturbed
    serve's, and the cancelled prefix is the undisturbed stream's."""
    from repro_torch.serve import Request, Scheduler, ServeConfig

    eng = _packed_engine(dev)
    rng = np.random.default_rng(5)
    reqs = [Request(tokens=rng.integers(0, eng.cfg.vocab_size, size=L).astype(np.int32),
                    max_new_tokens=10) for L in (4, 6)]
    sc = ServeConfig(n_slots=2, block_size=4)
    want = [c.tokens for c in eng.serve(reqs, sc)]
    sched = Scheduler(eng, sc)
    ids = [sched.submit(r) for r in reqs]
    for _ in range(3):
        sched.step()
    victim = next(s for s in sched._slots if s is not None and s.index == ids[0])
    free, n = sched.pool.n_free, len(victim.blocks)
    assert sched.cancel(ids[0])
    assert sched.pool.n_free == free + n
    sched.pool.check([s.blocks for s in sched._slots if s is not None])
    comps = sched.run()
    assert comps[0].finish_reason == "cancelled" and comps[0].tokens == want[0][:4]
    assert comps[1].tokens == want[1]
    sched.pool.check()
    assert sched.pool.n_live == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(32, 48), (2048, 8192), (2048, 92544)])
def test_plain_matmul_rows_do_not_depend_on_the_batch(dev, dtype, K, N):
    """``dense_apply`` on a float kernel and ``embed_logits`` give a row the
    same bits whether it rides with 2, 3, 14 or 19 other rows (a decode at
    3 or 4 slots, a verify of T 5 at 3 or 4 slots): the row count picks
    cuBLAS's kernel, so the card pads rows to a multiple of ROW_TILE."""
    from repro_torch.models.layers import ROW_TILE, dense_apply, embed_logits

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy((rng.standard_normal((K, N)) * K**-0.5).astype(np.float32)).to(dev, dt)
    x = torch.from_numpy(rng.standard_normal((ROW_TILE + 5, K)).astype(np.float32)).to(dev, dt)
    outs = [dense_apply({"kernel": w}, x[:m]) for m in (3, 4, 15, 20, ROW_TILE)]
    heads = [embed_logits({"embedding": w.t()}, x[:m]) for m in (3, 4, 15, 20)]
    torch.cuda.synchronize()
    for y in outs[1:]:
        assert torch.equal(y[:3], outs[0])
    for y in heads[1:]:
        assert torch.equal(y[:3], heads[0])
    torch.testing.assert_close(outs[-1].float(), (x[:ROW_TILE].float() @ w.float()),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("shape,lead,misaligned", [
    ((6, 8, 256, 128), (6, 8), False),  # olmoe's stacked experts (L, E, D, F), scaled down
    ((32, 448, 256), (32,), False),  # deepseek's MTP expert stack (E, D, F), scaled down
    ((3, 5, 7, 9), (3, 5), False),  # groups of 63: the scalar path
    ((6, 8, 16, 8), (6, 8), True),  # groups of 128 from a pointer 4 bytes off 16
])
@pytest.mark.parametrize("n_bits", [2, 4])
def test_grouped_symog_update_matches_plain(dev, shape, lead, misaligned, n_bits):
    """A Δ per leading group (f per (layer, expert)) equals the plain
    version bit for bit, over two calls from the same inputs."""
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update import symog_update
    from repro_torch.kernels.symog_update.ref import symog_update_ref

    rng = np.random.default_rng(sum(shape) + n_bits)
    f = rng.integers(1, 6, size=lead)
    d = np.exp2(-f.astype(np.float32)).reshape(lead + (1,) * (len(shape) - len(lead)))
    arrs = [(rng.standard_normal(shape) * s).astype(np.float32)
            for s in (1.3 * d, 0.05, 0.01)]
    delta = torch.from_numpy(np.exp2(-f.astype(np.float32))).to(dev)
    kw = dict(delta=delta, lam_eff=0.9, lr=0.01, mu=0.9, n_bits=n_bits)

    def operands():
        ts = [torch.from_numpy(a).to(dev) for a in arrs]
        if misaligned:
            ts = [torch.cat([torch.zeros(1, device=dev), t.reshape(-1)])[1:].view(shape)
                  for t in ts]
        return ts

    want_w, want_v = symog_update_ref(*operands(), **kw)
    outs = []
    for _ in range(2):
        w, g, v = operands()
        before = sops.launches
        symog_update(w, g, v, **kw)
        torch.cuda.synchronize()
        assert sops.launches == before + 1
        outs.append((w, v))
    for w, v in outs:
        assert torch.equal(w, want_w) and torch.equal(v, want_v)


@pytest.mark.parametrize("shape,lead,misaligned", [
    ((1 << 20,), (), False),  # one Δ
    ((6, 8, 256, 128), (6, 8), False),  # a Δ per (layer, expert)
    ((3, 5, 7, 9), (3, 5), False),  # groups of 63: the scalar path
    ((6, 8, 16, 8), (6, 8), True),  # groups of 128 from a pointer 4 bytes off 16
])
@pytest.mark.parametrize("n_bits", [2, 4])
def test_clipped_symog_update_and_norm_pass_match_plain(dev, shape, lead, misaligned, n_bits):
    """The clip form: ``gscale`` (a device scalar != 1) equals the plain
    version bit for bit, and the norm pass Σ (g + λ_eff·(w − q))² equals the
    fp64 sum of the plain version's terms at rtol 1e-5; both give the same
    bits over two calls."""
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update import symog_sqnorm, symog_update
    from repro_torch.kernels.symog_update.ref import _total_grad, symog_update_ref

    rng = np.random.default_rng(sum(shape) + n_bits + 1)
    f = rng.integers(1, 6, size=lead) if lead else np.array(3)
    d = np.exp2(-f.astype(np.float32)).reshape(lead + (1,) * (len(shape) - len(lead)))
    arrs = [(rng.standard_normal(shape) * s).astype(np.float32) for s in (1.3 * d, 0.05, 0.01)]
    delta = torch.from_numpy(np.exp2(-f.astype(np.float32)).reshape(-1)).to(dev)
    gscale = torch.tensor(0.37, dtype=torch.float32, device=dev)
    kw = dict(delta=delta, lam_eff=0.9, n_bits=n_bits)

    def operands():
        ts = [torch.from_numpy(a).to(dev) for a in arrs]
        if misaligned:
            ts = [torch.cat([torch.zeros(1, device=dev), t.reshape(-1)])[1:].view(shape)
                  for t in ts]
        return ts

    w0, g0, v0 = operands()
    want_w, want_v = symog_update_ref(w0, g0, v0, lr=0.01, mu=0.9, gscale=gscale, **kw)
    want_sq = np.sum(np.square(_total_grad(w0, g0, delta, 0.9, n_bits)[2].cpu().numpy()
                               .astype(np.float64)))
    outs, sqs = [], []
    for _ in range(2):
        w, g, v = operands()
        before = (sops.launches, sops.sqnorm_launches)
        sqs.append(symog_sqnorm(w, g, **kw))
        symog_update(w, g, v, lr=0.01, mu=0.9, gscale=gscale, **kw)
        torch.cuda.synchronize()
        assert (sops.launches, sops.sqnorm_launches) == (before[0] + 1, before[1] + 1)
        outs.append((w, v))
    for w, v in outs:
        assert torch.equal(w, want_w) and torch.equal(v, want_v)
    assert sqs[0].shape == () and torch.equal(sqs[0], sqs[1])
    np.testing.assert_allclose(float(sqs[0]), want_sq, rtol=1e-5)


@pytest.mark.parametrize("case,shape,dim", [
    ("column", (3, 256, 8, 64), 2),  # a stacked q_proj-like leaf, its K heads cut in 2
    ("odd_column", (2, 7, 10), 2),  # a shard of 35 elements a layer: the scalar tail
    ("expert_slice", (6, 8, 128, 64), 1),  # a rank's 4 of 8 experts, a Δ per (layer, expert)
])
@pytest.mark.parametrize("n_bits", [2, 4])
def test_symog_update_on_training_shards(dev, case, shape, dim, n_bits):
    """One tensor-parallel rank's shard of a leaf (its second half along
    ``dim``, a contiguous copy as ``shard_train_state`` makes it) with the
    WHOLE leaf's λ_eff = λ·2/M_l: ``symog_update`` equals its plain version
    bit for bit and ``symog_sqnorm`` its plain version at rtol 1e-5, each
    the same bits over two calls."""
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update import symog_sqnorm, symog_update
    from repro_torch.kernels.symog_update.ref import symog_sqnorm_ref, symog_update_ref

    rng = np.random.default_rng(sum(shape) + n_bits + 2)
    lead = shape[:2] if case == "expert_slice" else ()
    f = rng.integers(1, 6, size=lead) if lead else np.array(3)
    d = np.exp2(-f.astype(np.float32)).reshape(lead + (1,) * (len(shape) - len(lead)))
    whole = [(rng.standard_normal(shape) * s).astype(np.float32) for s in (1.3 * d, 0.05, 0.01)]
    half = shape[dim] // 2
    w, g, v = (torch.from_numpy(a).to(dev).narrow(dim, half, half).contiguous() for a in whole)
    f_local = f[:, half:] if lead else f
    delta = torch.from_numpy(np.exp2(-f_local.astype(np.float32)).reshape(-1)).to(dev)
    kw = dict(delta=delta, lam_eff=10.0 * np.exp(9.0) * 2.0 / int(np.prod(shape)), n_bits=n_bits)
    want_w, want_v = symog_update_ref(w, g, v, lr=0.01, mu=0.9, **kw)
    want_sq = float(symog_sqnorm_ref(w, g, **kw))
    outs, sqs = [], []
    for _ in range(2):
        w2, v2 = w.clone(), v.clone()
        before = (sops.launches, sops.sqnorm_launches)
        sqs.append(symog_sqnorm(w2, g, **kw))
        symog_update(w2, g, v2, lr=0.01, mu=0.9, **kw)
        torch.cuda.synchronize()
        assert (sops.launches, sops.sqnorm_launches) == (before[0] + 1, before[1] + 1)
        outs.append((w2, v2))
    for a, b in outs:
        assert torch.equal(a, want_w) and torch.equal(b, want_v)
    assert torch.equal(sqs[0], sqs[1])
    np.testing.assert_allclose(float(sqs[0]), want_sq, rtol=1e-5)


def test_moe_train_step_repeats_bit_identical(dev):
    """Reduced olmoe at bf16 compute: two backward passes from one state give
    the same grads bit for bit (the MoE gathers' slot-order backward), and
    the fused update, run twice, the same params and momentum."""
    from repro_torch import configs, core, optim
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm, lm_train_loss
    from repro_torch.nn.tree import flatten_with_paths, tree_map
    from repro_torch.train import fused_update, init_train_state
    from repro_torch.train.trainer import _accum_grads

    cfg = configs.get_reduced("olmoe-1b-7b")
    tx = optim.sgd(momentum=0.9)
    scfg = core.SymogConfig(n_bits=2, total_steps=10)
    st = init_train_state(init_lm(0, cfg, device=dev), tx, scfg)
    tok = torch.randint(0, cfg.vocab_size, (4, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))

    def grads():
        return _accum_grads(lambda p, b: lm_train_loss(p, b, cfg), st.params, {"tokens": tok}, 1)

    (l1, m1, g1), (l2, m2, g2) = grads(), grads()
    assert torch.equal(l1, l2) and all(torch.equal(m1[k], m2[k]) for k in m1)
    for (path, a), (_, b) in zip(flatten_with_paths(g1), flatten_with_paths(g2)):
        assert torch.equal(a, b), path
    runs = []
    for _ in range(2):
        before = sops.launches
        runs.append(fused_update(tree_map(torch.clone, st.params), g1,
                                 tree_map(torch.clone, st.opt_state), st.symog, scfg, tx,
                                 lr=0.01, lam=core.lambda_at(scfg, 3)))
        assert sops.launches == before + sum(st.symog.mask.values())
    for tree_a, tree_b in zip(*runs):
        for (path, a), (_, b) in zip(flatten_with_paths(tree_a), flatten_with_paths(tree_b)):
            assert torch.equal(a, b), path


def test_cnn_train_step_on_card_matches_cpu(dev):
    """One SYMOG step on the card (the fused route, one launch per
    quantizable leaf, fp32 convolutions without TF32) against the same step
    on the CPU (the composed route).  LeNet-5 (full width, batch 4): loss,
    params at rtol 1e-5 / atol 1e-6 and momentum (the step's gradient) at
    tests/test_torch_train.py's grad bar, rtol 1e-4 / atol 1e-6.  Reduced
    VGG7 (BN): the loss and BN's new running stats at rtol 1e-5 / atol 1e-6;
    its grads are not held to the CPU's, since with BN a ReLU input within
    fp32 noise of 0 (one in ~1e6; the step has ~1e5) moves a channel's
    gradient by O(1e-2) on whichever side takes the other branch.  So for
    both models the card's own grads also go through the fused and the
    composed update, both on the card, held leaf by leaf at rtol 1e-5 /
    atol 1e-7 (chip_smoke.py's step-1 bar): that check takes no branch."""
    from repro_torch import core, optim
    from repro_torch.data import SyntheticImages, SyntheticImagesConfig
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import PAPER_CNNS, cnn_apply, cnn_init, reduced_cnn
    from repro_torch.nn.tree import flatten_with_paths, tree_map, tree_to
    from repro_torch.train import (CNNTrainState, composed_update, fused_update,
                                   make_cnn_train_step, softmax_xent)
    from repro_torch.train.trainer import _loss_and_grads

    STEP, GRAD = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-4, atol=1e-6)
    UPDATE = dict(rtol=1e-5, atol=1e-7)

    def fused_vs_composed(cfg, st, batch, tx, scfg):
        def loss_fn(params, bt):
            logits, _ = cnn_apply(params, st.bn_state, bt["images"], cfg, train=True)
            loss = softmax_xent(logits, bt["labels"])
            return loss, {"loss": loss}

        bt = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        _, _, g = _loss_and_grads(loss_fn, st.params, bt)
        lam = core.lambda_at(scfg, 0)
        before = sops.launches
        fused = fused_update(tree_map(torch.clone, st.params), g,
                             tree_map(torch.clone, st.opt_state), st.symog, scfg, tx,
                             lr=0.01, lam=lam)
        assert sops.launches == before + sum(st.symog.mask.values())
        composed = composed_update(tree_map(torch.clone, st.params), g,
                                   tree_map(torch.clone, st.opt_state), st.symog, scfg, tx,
                                   lr=0.01, lam=lam)
        for tree_a, tree_b in zip(fused, composed):
            for (path, a), (_, c) in zip(flatten_with_paths(tree_a), flatten_with_paths(tree_b)):
                torch.testing.assert_close(a, c, **UPDATE,
                                           msg=lambda m, p=path: f"{cfg.name} {p}: {m}")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for cfg, batch in ((PAPER_CNNS["lenet5"], 4), (reduced_cnn("vgg7", 0.125), 8)):
            data = SyntheticImages(SyntheticImagesConfig(
                n_classes=cfg.n_classes, hw=cfg.input_hw, channels=cfg.in_channels,
                global_batch=batch, seed=3))
            b = next(data)
            tx = optim.sgd(momentum=0.9)
            scfg = core.SymogConfig(n_bits=2)
            out = {}
            for where in ("cpu", dev):
                params, bn = cnn_init(1, cfg, device="cpu")
                params, bn = tree_to(params, where), tree_to(bn, where)
                st = CNNTrainState(params, bn, tx.init(params), core.symog_init(params, scfg), 0)
                if where != "cpu":
                    fused_vs_composed(cfg, st, b, tx, scfg)
                step = make_cnn_train_step(cfg, tx, core.constant(0.01), symog_cfg=scfg)
                before = sops.launches
                out[str(where)] = step(st, b)
                launched = sops.launches - before
                assert launched == (0 if where == "cpu" else sum(st.symog.mask.values()))
            (cs, cm), (gs, gm) = out["cpu"], out[str(dev)]
            torch.testing.assert_close(gm["loss"].cpu(), cm["loss"], **STEP)
            trees = [(gs.bn_state, cs.bn_state, STEP)]
            if not cs.bn_state:
                # momentum after one step is the gradient: the grads' bar
                trees += [(gs.params, cs.params, STEP), (gs.opt_state, cs.opt_state, GRAD)]
            for a_tree, b_tree, tol in trees:
                for (path, a), (_, c) in zip(flatten_with_paths(a_tree),
                                             flatten_with_paths(b_tree)):
                    torch.testing.assert_close(a.cpu(), c, **tol,
                                               msg=lambda m, p=path: f"{cfg.name} {p}: {m}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# the recurrent families (mamba2, recurrentgemma)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M", [4, 512])
@pytest.mark.parametrize("K,N", [(2560, 80), (2560, 128), (2560, 5120), (5120, 2560),
                                 (2560, 256), (7680, 2560)])
def test_fixedpoint_matmul_recurrent_shapes(dev, M, K, N):
    """Row 1 at the recurrent families' projections (chip_smoke.py phase
    14a): mamba2's in_proj_dt (N 80: 20 bytes of 2-bit words a row), B / C
    (N 128), z / x and out_proj; recurrentgemma's k / v (N 256) and its
    MLP's down_proj; bf16 x, 2-bit, on the rule's kernel (decode at M 4,
    tensor cores at M 512), bit-identical over two calls."""
    rng = np.random.default_rng(K + N + M)
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    f = torch.tensor(4, dtype=torch.int32, device=dev)
    pw = pack_weight(w, f, 2)
    before = _counts()
    got = fixedpoint_matmul(x, pw, f, None, n_bits=2, n_out=N)
    again = fixedpoint_matmul(x, pw, f, None, n_bits=2, n_out=N)
    torch.cuda.synchronize()
    assert fops.decode_launches - before[2] + fops.tc_launches - before[1] == 2
    assert torch.equal(got, again)
    want = fixedpoint_matmul_ref(x, pw, f, None, n_bits=2, n_out=N).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **TC_BF16)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_recurrentgemma_decode_shape(dev, int8):
    """Row 2 at recurrentgemma-2b's local attention (phase 14b): B 4, MQA
    K 1 G 10, head_dim 256, rows of ~3,000 cached tokens under the 2,048
    window; a bf16 pool and a KV_F int8 pool (scale 2^-5), bf16 queries,
    bit-identical over two calls and at the bf16 bar of the plain version;
    the plain version with the window a block narrower misses it."""
    rng = np.random.default_rng(14 + int8)
    B, K, G, hd, block, mb = 4, 1, 10, 256, 16, 200
    bt = torch.from_numpy((rng.permutation(B * mb) + 1).astype(np.int32).reshape(B, mb)).to(dev)
    pos0 = torch.from_numpy(rng.integers(2900, 3100, size=B).astype(np.int32)).to(dev)
    kp, vp = (torch.from_numpy(rng.standard_normal((B * mb + 1, block, K, hd)).astype(
        np.float32)).to(dev) for _ in range(2))
    kw = dict(scale=hd**-0.5, window=2048)
    if int8:
        kp, vp = (torch.clamp(torch.round(t * 16), -127, 127).to(torch.int8) for t in (kp, vp))
        kw["kv_scale"] = 2.0**-5
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((B, 1, K, G, hd)).astype(np.float32) * 4.0).to(
        dev, torch.bfloat16)
    got = paged_attention(q, kp, vp, bt, pos0, **kw)
    again = paged_attention(q, kp, vp, bt, pos0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    bad = paged_attention_ref(q, kp, vp, bt, pos0, **dict(kw, window=2048 - block))
    assert not torch.allclose(got.float(), bad.float(), rtol=1e-2, atol=1e-2)


def _recurrent_engines(dev, arch):
    """Reduced ``arch``, 2-bit packed from a seeded init on the CPU, fp32:
    (card engine, CPU engine) over the same artifact."""
    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.models import init_lm
    from repro_torch.serve import ServeEngine

    cfg = configs.get_reduced(arch)
    params = init_lm(0, cfg, device="cpu")
    scfg = SymogConfig(n_bits=2, total_steps=1)
    packed = pack_tree(params, symog_init(params, scfg), scfg)
    return tuple(ServeEngine(cfg, packed, max_len=32, compute_dtype=torch.float32, device=d)
                 for d in (dev, "cpu"))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_recurrent_serve_on_card_matches_cpu(dev, arch):
    """A greedy serve of reduced mamba2 / recurrentgemma under a pool that
    preempts: token-identical on the card (matmul kernels; the GQA kernel
    for recurrentgemma's local attention) and on the CPU."""
    from repro_torch.serve import Request, ServeConfig

    card, cpu = _recurrent_engines(dev, arch)
    rng = np.random.default_rng(9)
    reqs = [Request(tokens=rng.integers(0, card.cfg.vocab_size, size=L), max_new_tokens=b)
            for L, b in ((14, 10), (13, 12), (11, 7), (5, 9))]
    sc = ServeConfig(n_slots=2, block_size=4, n_blocks=8)
    before = (fops.launches, aops.launches)
    got, sched = card.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    assert sched.stats["preemptions"] > 0 and fops.launches > before[0]
    assert (aops.launches > before[1]) == (arch == "recurrentgemma-2b")
    assert [c.tokens for c in got] == [c.tokens for c in cpu.serve(reqs, sc)]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_inactive_row_frozen_on_card(dev, arch):
    """``decode_lm`` on the card with row 1 inactive: every cache leaf of
    that row (SSD / RG-LRU state, conv window, dense k/v) keeps its bits
    over three steps, and row 0's logits equal the CPU's."""
    from repro_torch.models import decode_lm, prefill_lm, scan_groups
    from repro_torch.nn.tree import flatten_with_paths

    card, cpu = _recurrent_engines(dev, arch)
    cfg = card.cfg
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9)).astype(
        np.int32))
    caches = {}
    for name, eng in (("card", card), ("cpu", cpu)):
        _, caches[name] = eng._with_backend(prefill_lm, eng.params, {"tokens": tok.to(eng.device)},
                                            cfg, max_len=32, compute_dtype=torch.float32)
    before = {p: t.clone() for p, t in flatten_with_paths(caches["card"])}
    active = torch.tensor([True, False])
    for s in range(3):
        cur = torch.full((2, 1), 5 + s, dtype=torch.int32)
        out = {}
        for name, eng in (("card", card), ("cpu", cpu)):
            out[name], caches[name] = eng._with_backend(
                decode_lm, eng.params, caches[name], cur.to(eng.device),
                torch.tensor([9 + s, 9 + s], dtype=torch.int32, device=eng.device), cfg,
                compute_dtype=torch.float32, active=active.to(eng.device))
        torch.testing.assert_close(out["card"][0].cpu(), out["cpu"][0], rtol=1e-4, atol=1e-4)
    groups = scan_groups(cfg)
    for p, t in flatten_with_paths(caches["card"]):
        stacked = next(g for g in groups if p.startswith(g.name + "/")).stacked
        axis = 1 if stacked else 0  # the batch axis after a stacked layer axis
        assert torch.equal(t.select(axis, 1), before[p].select(axis, 1)), p


# ---------------------------------------------------------------------------
# the encoder-decoder and VLM families (whisper, paligemma)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M", [4, 1500])
@pytest.mark.parametrize("K,N", [(1280, 1280), (1280, 5120), (5120, 1280)])
def test_fixedpoint_matmul_whisper_biased_shapes(dev, M, K, N):
    """Row 1 at whisper-large-v3's biased projections (chip_smoke.py phase
    15a): q / k / v / o and the cross-attention's (1280 -> 1280), fc1 and
    fc2, at a decode step's 4 rows and the encoder's 1,500; bf16 x, 2-bit,
    an fp32 bias, on the rule's kernel, bit-identical over two calls."""
    rng = np.random.default_rng(K + N + M + 15)
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    b = torch.from_numpy((rng.standard_normal(N) * 0.1).astype(np.float32)).to(dev)
    f = torch.tensor(4, dtype=torch.int32, device=dev)
    pw = pack_weight(w, f, 2)
    before = _counts()
    got = fixedpoint_matmul(x, pw, f, b, n_bits=2, n_out=N)
    again = fixedpoint_matmul(x, pw, f, b, n_bits=2, n_out=N)
    torch.cuda.synchronize()
    route = fops._pick_route(torch.bfloat16, M, True)
    assert route == ("decode" if M == 4 else "tensor_core")
    assert fops.decode_launches - before[2] + fops.tc_launches - before[1] == 2
    assert torch.equal(got, again)
    want = fixedpoint_matmul_ref(x, pw, f, b, n_bits=2, n_out=N).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **TC_BF16)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("arch", ["whisper-large-v3", "paligemma-3b"])
def test_paged_attention_encdec_vlm_decode_shape(dev, arch, int8):
    """Row 2 at whisper's decode self-attention (phase 15b: MHA, K 20, G 1,
    head_dim 64, ~300 cached tokens) and paligemma's (MQA, K 1, G 8,
    head_dim 256, the 256-patch prefix + ~300 tokens); bf16 and KV_F int8
    pools, bf16 queries, bit-identical over two calls and at the bf16 bar
    of the plain version.  Each row's newest key points along its first
    query (3.9 a lane), so it takes most of that query's weight: the plain
    version one key short misses the bar."""
    rng = np.random.default_rng(24 + int8)
    K, G, hd, mb, lo = (20, 1, 64, 32, 280) if arch == "whisper-large-v3" else (1, 8, 256, 48, 536)
    B, block = 4, 16
    bt_np = (rng.permutation(B * mb) + 1).astype(np.int32).reshape(B, mb)
    pos0_np = rng.integers(lo, lo + 40, size=B).astype(np.int32)
    kp, vp = (rng.standard_normal((B * mb + 1, block, K, hd)).astype(np.float32)
              for _ in range(2))
    q_np = rng.standard_normal((B, 1, K, G, hd)).astype(np.float32) * 4.0
    for b in range(B):
        kp[bt_np[b, pos0_np[b] // block], pos0_np[b] % block] = np.sign(q_np[b, 0, :, 0]) * 3.9
    bt, pos0 = torch.from_numpy(bt_np).to(dev), torch.from_numpy(pos0_np).to(dev)
    kp, vp = torch.from_numpy(kp).to(dev), torch.from_numpy(vp).to(dev)
    kw = dict(scale=hd**-0.5)
    if int8:
        kp, vp = (torch.clamp(torch.round(t * 32), -127, 127).to(torch.int8) for t in (kp, vp))
        kw["kv_scale"] = 2.0**-5
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    q = torch.from_numpy(q_np).to(dev, torch.bfloat16)
    before = aops.launches
    got = paged_attention(q, kp, vp, bt, pos0, **kw)
    again = paged_attention(q, kp, vp, bt, pos0, **kw)
    torch.cuda.synchronize()
    assert aops.launches - before == 2 and torch.equal(got, again)
    want = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    bad = paged_attention_ref(q, kp, vp, bt, pos0 - 1, **kw)
    assert not torch.allclose(got.float(), bad.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "paligemma-3b"])
def test_encdec_vlm_serve_on_card_matches_cpu(dev, arch):
    """A greedy serve of reduced whisper / paligemma, each request with its
    own frames / patches, under a pool that preempts: token-identical on the
    card (the streaming matmul kernel, the GQA kernel; the encoder and the
    cross-attention in plain torch) and on the CPU."""
    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.models import init_lm
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = configs.get_reduced(arch)
    params = init_lm(0, cfg, device="cpu")
    scfg = SymogConfig(n_bits=2, total_steps=1)
    packed = pack_tree(params, symog_init(params, scfg), scfg)
    off = cfg.prefix_len if cfg.family == "vlm" else 0
    card, cpu = (ServeEngine(cfg, packed, max_len=32 + off, compute_dtype=torch.float32,
                             device=d) for d in (dev, "cpu"))
    rng = np.random.default_rng(11)
    name, n = ("patches", cfg.prefix_len) if off else ("frames", cfg.encoder_len)
    shape = ((6, 14), (5, 16), (7, 10), (3, 9)) if off else ((14, 10), (13, 12), (11, 7), (5, 9))
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=L), max_new_tokens=b,
                    extras={name: (rng.standard_normal((1, n, cfg.d_model)) * 0.1).astype(
                        np.float32)}) for L, b in shape]
    sc = ServeConfig(n_slots=2, block_size=4, n_blocks=(32 + off) // 4)
    before = (fops.launches, aops.launches)
    got, sched = card.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    assert sched.stats["preemptions"] > 0
    assert fops.launches > before[0] and aops.launches > before[1]
    assert [c.tokens for c in got] == [c.tokens for c in cpu.serve(reqs, sc)]


# ---------------------------------------------------------------------------
# SYMOG training of the recurrent, encoder-decoder and VLM families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "whisper-large-v3"])
def test_recurrent_encdec_train_step_on_card_matches_cpu(dev, arch):
    """Reduced mamba2 (SSD) and whisper (encoder, cross-attention, frames),
    fp32: one fused SYMOG step on the card (one launch per quantizable
    leaf) against the composed step on the CPU, loss and every param and
    momentum leaf at rtol 1e-5 / atol 1e-7 (chip_smoke.py's TRAIN_TOL)."""
    from repro_torch import configs, core, optim
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm
    from repro_torch.nn.tree import flatten_with_paths, tree_to
    from repro_torch.train import init_train_state, make_train_step

    tol = dict(rtol=1e-5, atol=1e-7)
    cfg = configs.get_reduced(arch)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal((4, cfg.encoder_len, cfg.d_model)) * 0.1).astype(
            np.float32)
    out = {}
    for where in ("cpu", dev):
        tx = optim.sgd(momentum=0.9)
        scfg = core.SymogConfig(n_bits=2)
        st = init_train_state(tree_to(init_lm(0, cfg, device="cpu"), where), tx, scfg)
        step = make_train_step(cfg, tx, core.constant(0.01), symog_cfg=scfg,
                               compute_dtype=torch.float32)
        before = sops.launches
        out[str(where)] = step(st, batch)
        torch.cuda.synchronize()
        assert sops.launches - before == (0 if where == "cpu" else sum(st.symog.mask.values()))
    (cs, cm), (gs, gm) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(gm["loss"].cpu(), cm["loss"], rtol=1e-5, atol=0)
    for a_tree, b_tree in ((gs.params, cs.params), (gs.opt_state, cs.opt_state)):
        for (path, a), (_, c) in zip(flatten_with_paths(a_tree), flatten_with_paths(b_tree)):
            assert bool(torch.isfinite(a).all()), path
            torch.testing.assert_close(a.cpu(), c, **tol, msg=lambda m, p=path: f"{p}: {m}")


def _ssd_select_after_exp(x, dt, A, Bm, Cm, *, chunk):
    """``ssd_scan_ref``'s formula in the JAX package's order: the decay's
    exp first, then the select to the lower triangle (in fp32 its upper
    entries overflow to inf and a backward gives NaN)."""
    B, T, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc = T // Q
    xf, dtc = x.reshape(B, nc, Q, H, P), dt.reshape(B, nc, Q, H)
    Bc, Cc = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)
    cum = torch.cumsum(dtc * A, dim=2)
    total = cum[:, :, -1, :]
    bx = dtc[..., None] * xf
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], decay, 0.0)
    scores = torch.einsum("bciN,bcjN->bcij", Cc, Bc)
    w = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)
    y_diag = torch.matmul(w, bx.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    decay_out = torch.exp(total[:, :, None, :] - cum)
    wx = (decay_out[..., None] * bx).reshape(B, nc, Q, H * P)
    S = torch.matmul(Bc.transpose(2, 3), wx).reshape(B, nc, N, H, P).permute(0, 1, 3, 2, 4)
    Ac = torch.exp(total)
    h = torch.zeros((B, H, N, P), dtype=x.dtype, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = Ac[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)
    ch = torch.matmul(Cc[:, :, None], h_prev).permute(0, 1, 3, 2, 4)
    y = (y_diag + ch * torch.exp(cum)[..., None]).reshape(B, T, H, P)
    return y, h.transpose(-1, -2)


def test_ssd_scan_overflowing_exponents_on_card(dev):
    """``ssd_scan_ref`` on the card at inputs whose upper-triangle exponents
    reach ~600 (mamba2's regime at full width): the forward bit-identical
    to the select-after-exp formula on the card, whose grads are not
    finite, while the port's are finite and within rtol 1e-4 of the CPU's."""
    from repro_torch.models.ssd import ssd_scan_ref

    rng = np.random.default_rng(0)
    B, T, H, P, N, Q = 2, 32, 2, 4, 3, 16
    arrays = (rng.standard_normal((B, T, H, P)), rng.uniform(0.6, 1.4, (B, T, H)),
              np.array([-0.9, -40.0]), rng.standard_normal((B, T, N)),
              rng.standard_normal((B, T, N)))
    ct = torch.from_numpy(rng.standard_normal((B, T, H, P)).astype(np.float32))
    ins = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    grads = {}
    for where in ("cpu", dev):
        live = [t.to(where).requires_grad_(True) for t in ins]
        y, h = ssd_scan_ref(*live, chunk=Q)
        grads[str(where)] = torch.autograd.grad((y * ct.to(where)).sum() + h.sum(), live)
        if where != "cpu":
            old = [t.detach().clone().requires_grad_(True) for t in live]
            y0, h0 = _ssd_select_after_exp(*old, chunk=Q)
            assert torch.equal(y.detach(), y0.detach()) and torch.equal(h.detach(), h0.detach())
            g0 = torch.autograd.grad((y0 * ct.to(where)).sum() + h0.sum(), old)
            assert not all(bool(torch.isfinite(g).all()) for g in g0)
    for name, g, c in zip(("x", "dt", "A", "Bm", "Cm"), grads[str(dev)], grads["cpu"]):
        assert bool(torch.isfinite(g).all()), name
        atol = 1e-5 * max(1.0, float(c.abs().max()))
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=atol,
                                   msg=lambda m, n=name: f"{n}: {m}")


# ---------------------------------------------------------------------------
# the kernels on a tensor- / expert-parallel rank's local shards (the shapes
# a (1, 2) mesh gives them; chip_smoke.py phase 18 runs them under the ranks)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("part", ["column", "row"])
def test_fixedpoint_matmul_on_tensor_parallel_shards(dev, part, dtype, n_bits):
    """internlm2's gate_proj (column: whole words of N/2 columns) and
    down_proj (row: K/2 rows) cut for model rank r of 2: each shard's
    launch equals the plain version on it; the row shards' fp32 partials
    sum to the whole product."""
    dt = getattr(torch, dtype)
    K, N, M, m = (2048, 8192, 4, 2) if part == "column" else (8192, 2048, 4, 2)
    rng = np.random.default_rng(K + n_bits)
    w = torch.from_numpy((rng.standard_normal((K, N)) * K**-0.5).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, dt)
    f = torch.tensor(4, dtype=torch.int32, device=dev)
    pw = pack_weight(w, f, n_bits)
    per = 8 // n_bits
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    parts = []
    for r in range(m):
        if part == "column":
            words, xs, n = pw[:, r * N // per // m:(r + 1) * N // per // m], x, N // m
        else:
            words, xs, n = pw[r * K // m:(r + 1) * K // m], x[:, r * K // m:(r + 1) * K // m], N
        words = words.contiguous()
        before = _counts()
        got = fixedpoint_matmul(xs.contiguous(), words, f, n_bits=n_bits, n_out=n)
        torch.cuda.synchronize()
        assert _launched(before, fops._pick_route(dt, M, True))
        want = fixedpoint_matmul_ref(xs, words, f, n_bits=n_bits, n_out=n).to(dt)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        parts.append(got.float())
    whole = fixedpoint_matmul_ref(x, pw, f, n_bits=n_bits, n_out=N).float()
    got = torch.cat(parts, dim=-1) if part == "column" else parts[0] + parts[1]
    torch.testing.assert_close(got, whole, **(tol if dt == torch.float32 else
                                              dict(rtol=2e-2, atol=2e-2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fixedpoint_matmul_experts_on_local_expert_shards(dev, dtype):
    """olmoe's 64-expert gate stack cut to a rank's 32 (words and one f
    each, as a (1, 2) mesh's expert parallelism gives them): the launch on
    the local stack equals the plain version and the whole stack's rows."""
    dt = getattr(torch, dtype)
    x, words, f = _experts_case(dev, 64, 4, 2048, 1024, 2, dt, seed=27)
    whole = fixedpoint_matmul_experts_ref(x, words, f, n_bits=2, n_out=1024).to(dt)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for r in range(2):
        sl = slice(32 * r, 32 * (r + 1))
        before = _counts()
        got = fixedpoint_matmul_experts(x[sl].contiguous(), words[sl].contiguous(),
                                        f[sl].contiguous(), n_bits=2, n_out=1024)
        torch.cuda.synchronize()
        assert _launched(before, fops._pick_route(dt, 4, True), experts=True)
        torch.testing.assert_close(got.float(), whole[sl].float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_on_local_kv_heads(dev, dtype):
    """internlm2's decode shape (K 8, G 2, hd 128) and its K/2 heads on a
    rank of 2: the launch over the local pool slice equals the plain
    version and the whole launch's heads."""
    qdt = getattr(torch, dtype)
    B, T, K, G, hd, block, mb = 4, 1, 8, 2, 128, 16, 20
    rng = np.random.default_rng(8)
    n_blocks = B * mb + 1
    bt = torch.from_numpy((rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb)
                          .astype(np.int32)).to(dev)
    pos0 = torch.from_numpy(rng.integers(0, mb * block, size=B).astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd)).astype(np.float32)).to(dev, qdt)
    kp, vp = (torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd)).astype(np.float32))
              .to(dev, qdt) for _ in range(2))
    kw = dict(scale=hd**-0.5, cap=0.0, window=None, kv_scale=1.0)
    whole = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
    tol = dict(rtol=2e-4, atol=2e-5) if qdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for r in range(2):
        hs = slice(K // 2 * r, K // 2 * (r + 1))
        before = aops.launches
        got = paged_attention(q[:, :, hs].contiguous(), kp[:, :, hs].contiguous(),
                              vp[:, :, hs].contiguous(), bt, pos0, **kw)
        torch.cuda.synchronize()
        assert aops.launches == before + 1
        torch.testing.assert_close(got.float(), whole[:, :, hs].float(), **tol)


# ---------------------------------------------------------------------------
# the kernels at one model rank's shapes of mamba2, recurrentgemma, whisper
# and paligemma on a (1, 2) mesh (chip_smoke.py phase 20 runs them under the
# ranks): (family, projection, K, N, bias) — whisper's column-parallel
# projections keep their biases' halves, its row-parallel ones add theirs
# after the reduce
# ---------------------------------------------------------------------------
FAMILY_RANK_SHAPES = [
    ("mamba2", "in_proj_x", 2560, 2560, False), ("mamba2", "in_proj_B", 2560, 128, False),
    ("mamba2", "in_proj_dt", 2560, 40, False),
    ("recurrentgemma", "in_proj_x", 2560, 1280, False),
    ("recurrentgemma", "out_proj", 1280, 2560, False),
    ("recurrentgemma", "gate_proj", 2560, 3840, False),
    ("recurrentgemma", "down_proj", 3840, 2560, False),
    ("whisper", "q_proj", 1280, 640, True), ("whisper", "o_proj", 640, 1280, False),
    ("whisper", "fc1", 1280, 2560, True), ("whisper", "fc2", 2560, 1280, False),
    ("paligemma", "gate_proj", 2048, 8192, False), ("paligemma", "down_proj", 8192, 2048, False),
]


@pytest.mark.parametrize("M", [4, 512])
@pytest.mark.parametrize("family,name,K,N,bias", FAMILY_RANK_SHAPES,
                         ids=[f"{a}-{b}" for a, b, *_ in FAMILY_RANK_SHAPES])
def test_fixedpoint_matmul_at_family_rank_shapes(dev, family, name, K, N, bias, M):
    """One rank's projection, 2-bit, bf16: the route the rule picks (the
    decode kernel at M 4, the tensor cores at 512) equals the plain version."""
    rng = np.random.default_rng(K * 3 + N)
    w = torch.from_numpy((rng.standard_normal((K, N)) * K**-0.5).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    b = (torch.from_numpy(rng.standard_normal(N).astype(np.float32) * 0.1).to(dev)
         if bias else None)
    f = torch.tensor(4, dtype=torch.int32, device=dev)
    pw = pack_weight(w, f, 2)
    before = _counts()
    got = fixedpoint_matmul(x, pw, f, b, n_bits=2, n_out=N)
    torch.cuda.synchronize()
    assert _launched(before, fops._pick_route(torch.bfloat16, M, True))
    want = fixedpoint_matmul_ref(x, pw, f, b, n_bits=2, n_out=N).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_row_parallel_bias_added_once_after_the_sum(dev):
    """whisper's fc2 (5,120 -> 1,280, biased) cut by rows for 2 ranks: the
    kernels' fp32 partials without the bias, summed, plus the bias once,
    equal the whole biased product; the bias on each partial would be off by b."""
    K, N, M = 5120, 1280, 4
    rng = np.random.default_rng(51)
    w = torch.from_numpy((rng.standard_normal((K, N)) * K**-0.5).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    f = torch.tensor(4, dtype=torch.int32, device=dev)
    pw = pack_weight(w, f, 2)
    parts = [fixedpoint_matmul(x[:, r * K // 2:(r + 1) * K // 2].contiguous(),
                               pw[r * K // 2:(r + 1) * K // 2].contiguous(), f, n_bits=2, n_out=N)
             for r in range(2)]
    torch.cuda.synchronize()
    whole = fixedpoint_matmul_ref(x, pw, f, b, n_bits=2, n_out=N)
    torch.testing.assert_close(parts[0] + parts[1] + b, whole, rtol=1e-5, atol=1e-5)
    assert float((parts[0] + parts[1] + 2 * b - whole).abs().max()) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_on_whisper_local_heads(dev, dtype):
    """whisper's decode shape (MHA K 20, hd 64) and one rank's 10 heads: the
    launch over the local pool slice equals the plain version and the whole
    launch's heads."""
    qdt = getattr(torch, dtype)
    B, T, K, G, hd, block, mb = 4, 1, 20, 1, 64, 16, 20
    rng = np.random.default_rng(20)
    n_blocks = B * mb + 1
    bt = torch.from_numpy((rng.permutation(n_blocks - 1)[: B * mb] + 1).reshape(B, mb)
                          .astype(np.int32)).to(dev)
    pos0 = torch.from_numpy(rng.integers(0, mb * block, size=B).astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd)).astype(np.float32)).to(dev, qdt)
    kp, vp = (torch.from_numpy(rng.standard_normal((n_blocks, block, K, hd)).astype(np.float32))
              .to(dev, qdt) for _ in range(2))
    kw = dict(scale=hd**-0.5, cap=0.0, window=None, kv_scale=1.0)
    whole = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
    tol = dict(rtol=2e-4, atol=2e-5) if qdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for r in range(2):
        hs = slice(K // 2 * r, K // 2 * (r + 1))
        before = aops.launches
        got = paged_attention(q[:, :, hs].contiguous(), kp[:, :, hs].contiguous(),
                              vp[:, :, hs].contiguous(), bt, pos0, **kw)
        torch.cuda.synchronize()
        assert aops.launches == before + 1
        torch.testing.assert_close(got.float(), whole[:, :, hs].float(), **tol)
