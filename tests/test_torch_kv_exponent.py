"""Port parity, the SYMOG KV exponent against the JAX package's JITTED form.

The JAX serving path runs ``block_scale_exp`` inside jitted traces (the
admission scatter, the decode step), and XLA's fused fp32 arithmetic steps
at other amaxes than eager JAX or torch's ``log2`` do.  Near the points
where the exponent steps (amax close to qmax·2^k) a wrong exponent halves
or doubles a block's scale, so every case here is array_equal:

  - ``block_scale_exp`` at the amaxes where the port once differed, at
    qmax·2^k for k in -12..12 (qmax 127 and 7), each with its two fp32 (or
    bf16) neighbours, from fp32 and bf16 entries;
  - the arithmetic it rests on (``kv_exponent.jitted_exponent``) on random
    amaxes over the whole clamped range;
  - the factor each exponent quantizes under (XLA's jitted ``exp2(-e)``);
  - the words and exponents of the admission scatter (``_scatter_blocks_quant``)
    and of decode writes (``paged_quant_update``) at those amaxes, int8 and
    int4 pools, against JAX's jitted functions; every amax a KV_F int8
    prefill cache can hold, for the int8 pool.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jatt  # noqa: E402
from repro.serve.engine import _scatter_blocks_quant as j_scatter_quant  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import kv_exponent  # noqa: E402
from repro_torch.serve.engine import _scatter_blocks_quant  # noqa: E402

QMAX = {8: 127, 4: 7}
# (bits, amax): where the port's exponent once differed from jitted JAX
KNOWN = [(8, 63.5), (8, 127.0), (8, 254.0), (8, 508.0), (8, 65024.0), (8, 130048.0), (4, 3.5)]
POWERS = range(-12, 13)
_JIT = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit_exp(qmax):
    if qmax not in _JIT:
        _JIT[qmax] = jax.jit(lambda x: jatt.block_scale_exp(x, qmax))
    return _JIT[qmax]


def _with_neighbours(a: float, dtype: str) -> np.ndarray:
    """a and the next value below and above it in ``dtype`` (as fp32)."""
    if dtype == "float32":
        a32 = np.float32(a)
        return np.asarray([np.nextafter(a32, np.float32(0)), a32,
                           np.nextafter(a32, np.float32(np.inf))], np.float32)
    b = np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.uint16).astype(np.int32)
    bits = (np.asarray([b - 1, b, b + 1]) << 16).astype(np.uint32)
    return bits.view(np.float32)


def _entries(amaxes: np.ndarray, width: int = 16, seed: int = 0) -> np.ndarray:
    """(N, 2, width) fp32 entries: entry i's head 0 reaches +amax_i, head 1
    -amax_i, every other lane strictly inside (-amax_i, amax_i)."""
    rng = np.random.default_rng(seed)
    n = len(amaxes)
    u = rng.uniform(-0.99, 0.99, size=(n, 2, width)).astype(np.float32)
    x = (u * amaxes[:, None, None]).astype(np.float32)
    x[:, 0, 3] = amaxes
    x[:, 1, 7] = -amaxes
    return x


def _check_exp(amaxes, bits, dtype):
    qmax = QMAX[bits]
    x = _entries(amaxes)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert torch.equal(tx.float().abs().amax(-1)[:, 0], torch.from_numpy(amaxes))
    want = np.asarray(_jit_exp(qmax)(jx))
    got = tatt.block_scale_exp(tx, qmax)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"amaxes {amaxes}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,amax", KNOWN)
def test_block_scale_exp_matches_jitted_jax_at_known_amaxes(bits, amax, dtype):
    _check_exp(_with_neighbours(amax, dtype), bits, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", POWERS)
def test_block_scale_exp_matches_jitted_jax_at_qmax_powers(k, bits, dtype):
    _check_exp(_with_neighbours(QMAX[bits] * 2.0**k, dtype), bits, dtype)


@pytest.mark.parametrize("bits", [8, 4])
def test_jitted_exponent_arithmetic_matches_jax(bits):
    """The fp32 arithmetic the thresholds come from, on 200k random amaxes
    (log-uniform over the clamped range and beyond), zero, inf and NaN."""
    qmax = QMAX[bits]
    rng = np.random.default_rng(bits)
    a = np.exp2(rng.uniform(-34, 34, size=200_000)).astype(np.float32)
    a = np.concatenate([a, np.asarray([0.0, 2.0**-30, np.inf, np.nan], np.float32)])
    want = np.asarray(_jit_exp(qmax)(jnp.asarray(a)[:, None]))
    got = kv_exponent.jitted_exponent(torch.from_numpy(a), qmax)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tatt.block_scale_exp(torch.from_numpy(a)[:, None], qmax).numpy(),
                                  want)


@pytest.mark.parametrize("bits", [8, 4])
def test_exponent_thresholds_are_the_step_points(bits):
    """Threshold i is the least amax of exponent KV_EXP_MIN + 1 + i: jitted
    JAX gives that exponent there and one less at the fp32 value below."""
    qmax = QMAX[bits]
    th = kv_exponent.exponent_thresholds(qmax).numpy()
    assert th.shape == (40,) and np.all(np.diff(th) > 0)
    below = np.nextafter(th, np.float32(0))
    steps = np.arange(kv_exponent.KV_EXP_MIN + 1, kv_exponent.KV_EXP_MAX + 1)
    np.testing.assert_array_equal(np.asarray(_jit_exp(qmax)(jnp.asarray(th)[:, None])), steps)
    np.testing.assert_array_equal(np.asarray(_jit_exp(qmax)(jnp.asarray(below)[:, None])),
                                  steps - 1)


def test_quant_scales_match_jitted_exp2():
    """The factor each exponent quantizes under is XLA's jitted
    ``exp2(-e)``, not a power of two for |e| >= 13, at all 41 exponents."""
    e = np.arange(kv_exponent.KV_EXP_MIN, kv_exponent.KV_EXP_MAX + 1, dtype=np.int32)
    want = np.asarray(jax.jit(lambda e: jnp.exp2(-e.astype(jnp.float32)))(jnp.asarray(e)))
    np.testing.assert_array_equal(kv_exponent.quant_scales().numpy(), want)
    x = np.full((len(e), 1), 0.0, np.float32)
    x[:, 0] = np.float32(100.5) / want  # lands on a tie only under the exact factor
    jq = np.asarray(jax.jit(lambda x, e: jatt.quantize_fixed(x, e, 127))(jnp.asarray(x),
                                                                      jnp.asarray(e)))
    np.testing.assert_array_equal(tatt.quantize_fixed(torch.from_numpy(x), torch.from_numpy(e),
                                                      127).numpy(), jq)


def _scatter_amaxes(bits):
    """Every amax of the exponent cases above for this pool, as fp32."""
    qmax = QMAX[bits]
    vals = [a for b, a in KNOWN if b == bits] + [qmax * 2.0**k for k in POWERS]
    return np.concatenate([_with_neighbours(a, "float32") for a in vals])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_admission_scatter_matches_jitted_jax(bits, dtype):
    """Admission of a prefill cache whose blocks' first tokens carry the
    amaxes above: pool words and exponents array_equal to JAX's jitted
    ``_scatter_blocks_quant``."""
    amaxes = _scatter_amaxes(bits)
    if dtype == "bfloat16":  # the bf16 values nearest those amaxes, and their neighbours
        amaxes = np.unique(np.concatenate([_with_neighbours(a, dtype) for a in amaxes[1::3]]))
    block, hd = 4, 16
    n = len(amaxes)
    first = _entries(amaxes, width=hd, seed=bits)  # (n, 2 heads, hd): block j's first token
    rest = _entries(amaxes, width=hd, seed=bits + 1)[:, None] * np.float32(0.5)
    src = np.concatenate([first[:, None], np.repeat(rest, block - 1, axis=1)], axis=1)
    src = src.reshape(1, n * block, 2, hd)
    w = hd // 2 if bits == 4 else hd
    pool = np.zeros((n + 1, block, 2, w), np.int8)
    exp = np.zeros((n + 1, 2), np.int32)
    bt = np.arange(1, n + 1, dtype=np.int32)
    jsrc = jnp.asarray(src, dtype)
    jfn = jax.jit(j_scatter_quant, static_argnums=(4, 5))
    jp, je = jfn(jnp.asarray(pool), jnp.asarray(exp), jsrc, jnp.asarray(bt), 0, n)
    tp, te = torch.from_numpy(pool), torch.from_numpy(exp)
    tsrc = torch.from_numpy(np.array(jsrc.astype(jnp.float32))).to(getattr(torch, dtype))
    _scatter_blocks_quant(tp, te, tsrc, torch.from_numpy(bt), 0, n)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_admission_scatter_kv_f_int8_every_amax():
    """An int8_fp pool admits a KV_F int8 prefill cache: its amaxes are
    k / 32 for k = 0..127, every one of them here."""
    block, hd = 4, 16
    ks = np.arange(128)
    n = len(ks)
    src = np.zeros((1, n * block, 2, hd), np.int8)
    rng = np.random.default_rng(3)
    for j, k in enumerate(ks):
        tile = rng.integers(-k, k + 1, size=(block, 2, hd)) if k else np.zeros((block, 2, hd))
        tile[0, 0, 5], tile[0, 1, 9] = k, -k
        src[0, j * block:(j + 1) * block] = tile
    pool = np.zeros((n + 1, block, 2, hd), np.int8)
    exp = np.zeros((n + 1, 2), np.int32)
    bt = np.arange(1, n + 1, dtype=np.int32)
    jfn = jax.jit(j_scatter_quant, static_argnums=(4, 5))
    jp, je = jfn(jnp.asarray(pool), jnp.asarray(exp), jnp.asarray(src), jnp.asarray(bt), 0, n)
    tp, te = torch.from_numpy(pool), torch.from_numpy(exp)
    _scatter_blocks_quant(tp, te, torch.from_numpy(src), torch.from_numpy(bt), 0, n)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_writes_match_jitted_jax(bits):
    """Decode writes (``paged_quant_update``): each new entry opens a block
    with one of the amaxes above; words and exponents array_equal to JAX's
    jitted update."""
    amaxes = _scatter_amaxes(bits)
    block, hd = 4, 16
    n = len(amaxes)
    w = hd // 2 if bits == 4 else hd
    new = _entries(amaxes, width=hd, seed=7)
    idx = (np.arange(1, n + 1) * block).astype(np.int32)  # slot 0 of blocks 1..n
    pool = np.zeros((n + 1, block, 2, w), np.int8)
    exp = np.zeros((n + 1, 2), np.int32)
    jp, je = jax.jit(jatt.paged_quant_update)(jnp.asarray(pool), jnp.asarray(exp),
                                               jnp.asarray(new), jnp.asarray(idx))
    tp, te = torch.from_numpy(pool), torch.from_numpy(exp)
    tatt.paged_quant_update(tp, te, torch.from_numpy(new), torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

