"""Port parity, fixed-point matmul (repro_torch.kernels.fixedpoint_matmul vs
repro.kernels.fixedpoint_matmul).

On the CPU the port's wrapper runs its plain version (unpack, fp32 matmul);
it is held to the JAX Pallas kernel in interpret mode and to JAX's ref.py at
rtol = atol = 1e-5 (the bar of tests/test_kernels.py).  The packed layer
(``packed_dense_apply``, including o_proj's two contracted input dims) is
held to the JAX layer the same way.  The route rule that picks one of the
three CUDA kernels on the card, the decode kernel's block shape and the
mirror of its occupied-expert walk are pure functions, tested here; the kernels
themselves are compared to the plain version on the card
(tests/test_torch_cuda.py; chip_smoke.py at the serving path's full-width
shapes)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.dispatch import set_packed_backend as j_set_backend  # noqa: E402
from repro.kernels.fixedpoint_matmul import fixedpoint_matmul as j_fpmm  # noqa: E402
from repro.kernels.fixedpoint_matmul import pack_weight as j_pack_weight  # noqa: E402
from repro.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_ref as j_ref  # noqa: E402
from repro.core.packing import Packed as JPacked  # noqa: E402
from repro.models.quantized import packed_dense_apply as j_pda  # noqa: E402
from repro_torch.core import pack  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul import fixedpoint_matmul, ops  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul import pack_weight  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_ref  # noqa: E402
from repro_torch.models.quantized import packed_dense_apply  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, M, K, N, n_bits, f, bias=False):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    pw = np.array(j_pack_weight(jnp.asarray(w), f, n_bits))  # writable copy for torch
    return w, x, b, pw




def test_pack_weight_bit_exact():
    w, _, _, pw = _case(0, 1, 64, 96, 2, 3)
    np.testing.assert_array_equal(pack_weight(torch.from_numpy(w), 3, 2).numpy(), pw)


@pytest.mark.parametrize("mkn", [(4, 32, 64), (130, 256, 200), (1, 128, 128)])
@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("f", [-1, 3])
def test_port_matches_pallas_interpret(mkn, n_bits, f):
    M, K, N = mkn
    w, x, _, pw = _case(M + K + N + n_bits, M, K, N, n_bits, f)
    want = np.asarray(j_fpmm(jnp.asarray(x), jnp.asarray(pw), f, n_bits=n_bits, n_out=N,
                             interpret=True))
    got = fixedpoint_matmul(torch.from_numpy(x), torch.from_numpy(pw),
                            torch.tensor(f, dtype=torch.int32), n_bits=n_bits, n_out=N)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = fixedpoint_matmul_ref(torch.from_numpy(x), torch.from_numpy(pw), f, n_bits=n_bits,
                                n_out=N)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(j_ref(jnp.asarray(x), jnp.asarray(pw), f, n_bits=n_bits, n_out=N)),
        **TOL)


@pytest.mark.parametrize("mkn", [(32, 64, 96), (128, 64, 96), (128, 96, 40)])
@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_pallas_interpret_prefill(mkn, n_bits, dtype):
    """Prefill-like row counts (a 32- and a 128-token bucket) at a narrow K
    and N, with bias: the plain version the CPU runs against the Pallas
    kernel in interpret mode; bf16 x (the tensor-core route's dtype on the
    card) at the bf16 bar, one rounding of the fp32 result."""
    M, K, N = mkn
    w, x, b, pw = _case(M * 3 + K + n_bits, M, K, N, n_bits, 2, bias=True)
    want = np.asarray(j_fpmm(jnp.asarray(x), jnp.asarray(pw), 2, jnp.asarray(b), n_bits=n_bits,
                             n_out=N, interpret=True))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = fixedpoint_matmul(xt, torch.from_numpy(pw), torch.tensor(2, dtype=torch.int32),
                            torch.from_numpy(b), n_bits=n_bits, n_out=N)
    assert got.dtype == xt.dtype and tuple(got.shape) == (M, N)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:  # the reference from the same bf16-rounded x
        want16 = np.asarray(j_fpmm(jnp.asarray(xt.float().numpy()), jnp.asarray(pw), 2,
                                   jnp.asarray(b), n_bits=n_bits, n_out=N, interpret=True))
        np.testing.assert_allclose(got.float().numpy(), want16, rtol=1e-2, atol=1e-2)


ROWS = ops.DECODE_MAX_ROWS


@pytest.mark.parametrize("dtype,rows,aligned,route", [
    (torch.bfloat16, ROWS + 1, True, "tensor_core"),  # one row past the decode kernel
    (torch.bfloat16, ROWS, True, "decode"),  # the decode kernel's last row count
    (torch.bfloat16, 4, True, "decode"),  # decode: 4 slots, C = 4 per expert
    (torch.bfloat16, 1, True, "decode"),  # one row
    (torch.bfloat16, 512, True, "tensor_core"),  # a 512-token bucket
    (torch.bfloat16, 512, False, "streaming"),  # rows of x not 16-byte aligned
    (torch.bfloat16, 4, False, "streaming"),
    (torch.float32, 512, True, "streaming"),  # fp32 stays off the tensor cores
    (torch.float32, 4, True, "streaming"),  # the fp32 head at decode, the parity phases
    (torch.float32, 1, True, "streaming"),  # the fp32 head at prefill (last position)
])
def test_route_rule(dtype, rows, aligned, route):
    assert ops._pick_route(dtype, rows, aligned) == route


@pytest.mark.parametrize("rows", list(range(1, 9)))
def test_decode_rows_take_the_decode_kernel(rows):
    """Every bf16 decode call (M = n_slots, C per expert) up to the decode
    kernel's n8 tile takes it, and the tensor cores take every aligned bf16
    call past it."""
    assert 4 <= ops.DECODE_MAX_ROWS <= 8 and ops.TC_MIN_ROWS == ops.DECODE_MAX_ROWS + 1
    want = "decode" if rows <= ops.DECODE_MAX_ROWS else "tensor_core"
    assert ops._pick_route(torch.bfloat16, rows, True) == want


@pytest.mark.parametrize("experts,K,nbytes,want", [
    (1, 2048, 512, (1, 4)),  # internlm2 q_proj at decode: 1 MB, 16 narrow tiles split 4 ways
    (1, 2048, 2048, (4, 4)),  # gate_proj: 16 line tiles split 4 ways, 64 blocks
    (1, 8192, 512, (1, 4)),  # down_proj
    (1, 7168, 16, (1, 8)),  # deepseek k_rope (N = 64): one tile, clusters of 8
    (1, 1536, 6144, (4, 2)),  # deepseek q_b_proj: 48 line tiles
    (1, 16384, 1792, (2, 8)),  # deepseek o_proj: 29 MB, 28 tiles of 64 word bytes
    (1, 7168, 32320, (4, 2)),  # the deepseek head
    (32, 7168, 512, (4, 2)),  # a deepseek gate stack, 32 experts bound: 128 line tiles
    (32, 2048, 1792, (4, 1)),  # a deepseek down stack: 448 tiles
    (32, 2048, 256, (4, 4)),  # an olmoe gate stack
    (1, 96, 10, (1, 1)),  # one K step: no K to split
])
def test_decode_tile(experts, K, nbytes, want):
    assert ops._decode_tile(experts, K, nbytes, 132) == want


@pytest.mark.parametrize("E", [1, 8, 64, 256])
@pytest.mark.parametrize("col_tiles", [1, 3])
def test_active_experts_cover_each_occupied_expert_once(E, col_tiles):
    """The mirror of the decode kernel's walk: whatever max_active (below
    the true count too) and tile count, every (occupied expert, tile) item
    is computed by exactly one cluster, no empty expert by any, and each
    cluster's items come in expert order."""
    rng = np.random.default_rng(E + col_tiles)
    for fill in ("random", "empty", "full"):
        rows = {"random": rng.integers(0, 3, size=E) * (rng.random(E) < 0.4),
                "empty": np.zeros(E, np.int64), "full": np.full(E, 4)}[fill]
        occ = [e for e in range(E) if rows[e] > 0]
        want = sorted((e, c) for e in occ for c in range(col_tiles))
        for max_active in sorted({1, 2, max(1, len(occ) // 2), max(1, len(occ)), E, E + 5}):
            walk = ops.active_experts(rows, max_active, col_tiles)
            assert len(walk) == max(1, min(max_active, E)) * col_tiles
            assert sorted(item for items in walk for item in items) == want
            assert all(items == sorted(items) for items in walk)


@pytest.mark.parametrize("rows,K,nbytes,E,want", [
    (20, 7168, 512, 256, (0, 1)),  # a deepseek expert stack at a 512-token bucket: lines
    (5, 2048, 256, 64, (0, 1)),  # an olmoe stack at a 32-token bucket
    (512, 2048, 2048, 1, (0, 1)),  # gate_proj at a 512-token bucket: 256 line tiles
    (128, 7168, 32320, 1, (0, 1)),  # the deepseek head at M = 128
    (512, 2048, 512, 1, (1, 1)),  # q_proj at 512 tokens: 64 line tiles, 256 narrow ones
    (32, 2048, 2048, 1, (2, 2)),  # gate_proj at 32 tokens: 64 narrow tiles, 2 a cluster
    (32, 2048, 256, 1, (2, 4)),  # k_proj at 32 tokens: 8 tiles, clusters of 4 split K
    (128, 7168, 16, 1, (2, 4)),  # k_rope (N = 64) at a 128-token bucket: 4 tiles
    (256, 2048, 512, 1, (2, 1)),  # 128 narrow tiles: 132 // 128 = 1
    (32, 256, 16, 1, (2, 1)),  # one 256-row step: no K to split
])
def test_tc_tile(rows, K, nbytes, E, want):
    assert ops._tc_tile(rows, K, nbytes, 132, E) == want


def test_route_override_checked():
    """The private route override names a route and refuses the tensor cores
    for what the kernel does not take (the check runs before any launch)."""
    x16 = torch.zeros((16, 64), dtype=torch.bfloat16)
    assert ops._route_for(x16, 16, 64, None) == "tensor_core"
    assert ops._route_for(x16, 16, 64, "streaming") == "streaming"
    assert ops._route_for(x16[:8], 8, 64, None) == "decode"
    assert ops._route_for(x16[:8], 8, 64, "tensor_core") == "tensor_core"
    with pytest.raises(ValueError):
        ops._route_for(x16, 16, 64, "tensor-cores")
    with pytest.raises(ValueError):
        ops._route_for(torch.zeros((8, 64)), 8, 64, "tensor_core")
    with pytest.raises(ValueError):
        ops._route_for(torch.zeros((8, 60), dtype=torch.bfloat16), 8, 60, "tensor_core")
    with pytest.raises(ValueError):  # the decode kernel: bf16, aligned, 1..8 rows
        ops._route_for(x16, 16, 64, "decode")
    with pytest.raises(ValueError):
        ops._route_for(torch.zeros((4, 64)), 4, 64, "decode")
    with pytest.raises(ValueError):
        ops._route_for(torch.zeros((4, 60), dtype=torch.bfloat16), 4, 60, "decode")


def test_bias_batched_input_and_bf16():
    w, x, b, pw = _case(5, 6, 32, 48, 2, 2, bias=True)
    x3 = x.reshape(2, 3, 32)
    want = np.asarray(j_fpmm(jnp.asarray(x3), jnp.asarray(pw), 2, jnp.asarray(b), n_bits=2,
                             n_out=48, interpret=True))
    got = fixedpoint_matmul(torch.from_numpy(x3), torch.from_numpy(pw), 2, torch.from_numpy(b),
                            n_bits=2, n_out=48)
    assert tuple(got.shape) == (2, 3, 48)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # bf16 activations come back in bf16 (the serving call sites' out_dtype)
    got16 = fixedpoint_matmul(torch.from_numpy(x3).bfloat16(), torch.from_numpy(pw), 2,
                              torch.from_numpy(b), n_bits=2, n_out=48)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_cpu_calls_do_not_count_launches():
    _, x, _, pw = _case(1, 2, 32, 64, 2, 1)
    before = (ops.launches, ops.tc_launches, ops.decode_launches)
    fixedpoint_matmul(torch.from_numpy(x), torch.from_numpy(pw), 1, n_bits=2, n_out=64)
    # bf16 at a decode size: no launch either
    fixedpoint_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(pw), 1, n_bits=2,
                      n_out=64)
    _, x, _, pw = _case(1, 64, 32, 64, 2, 1)  # bf16 at a prefill size: no launch either
    fixedpoint_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(pw), 1, n_bits=2,
                      n_out=64)
    assert (ops.launches, ops.tc_launches, ops.decode_launches) == before


@pytest.mark.parametrize("backend", ["kernel", "unpack"])
@pytest.mark.parametrize("n_in,shape", [(1, (32, 4, 8)), (2, (4, 8, 32))])
def test_packed_dense_apply_matches_jax(backend, n_in, shape):
    """q_proj-like (D -> H,hd) and o_proj-like (H,hd -> D, n_in=2) packed
    layers, with bias, against the JAX layer under its interpret/unpack path."""
    rng = np.random.default_rng(11 + n_in)
    w = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    b = rng.standard_normal(shape[n_in:]).astype(np.float32)
    x = rng.standard_normal((2, 3) + shape[:n_in]).astype(np.float32)
    tp = pack(torch.from_numpy(w), torch.tensor(2, dtype=torch.int32), 2)
    jp = JPacked(data=jnp.asarray(tp.data.numpy()), n_bits=2, f=jnp.asarray(2, jnp.int32))
    try:
        j_set_backend("interpret" if backend == "kernel" else "unpack")
        want = np.asarray(j_pda({"kernel": jp, "bias": jnp.asarray(b)}, jnp.asarray(x), n_in=n_in))
    finally:
        j_set_backend("auto")
    try:
        dispatch.set_packed_backend(backend)
        got = packed_dense_apply({"kernel": tp, "bias": torch.from_numpy(b)}, torch.from_numpy(x),
                                 n_in=n_in)
    finally:
        dispatch.set_packed_backend("auto")
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
