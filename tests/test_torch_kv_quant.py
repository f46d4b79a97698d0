"""Port parity, SYMOG-quantized paged KV pools (repro_torch vs the JAX
package, DESIGN.md §11), on the CPU.

  - the quantizer: ``block_scale_exp``, ``quantize_fixed``, ``pack_int4`` /
    ``unpack_int4`` and ``paged_quant_update`` are array_equal to JAX, and
    so is the admission's ``_scatter_blocks_quant`` (float and KV_F int8
    prefill caches, unstacked and stacked groups);
  - quantized paged attention (the plain version of the CUDA kernel) is
    held to JAX's ref.py and to the Pallas ``_attn_kernel_quant`` in
    interpret mode over int8 / int4, G = 1 / 2, a window, a softcap and
    exponents that vary per block and head (negative ones included), at
    2e-4/2e-5 in fp32 and 5e-2 in bf16 (tests/test_paged_attention.py);
  - the decode layer on a quantized pool: written leaves array_equal to
    JAX, outputs on both attention backends close to JAX's;
  - greedy ``serve()`` of reduced olmoe-1b-7b with ``int8_fp``, ``int4_fp``
    and ``bf16`` pools, for ``quantize_tree`` and ``pack_tree`` params, with
    small blocks so decode opens new ones: token-identical to JAX
    ``serve()`` and, for the quantized pools, pool and exponent leaves
    array_equal to JAX's; serving twice gives identical tokens; the bf16
    pool also equals the static dense-cache loop (a quantized pool rounds
    KV that the dense loop keeps, so JAX claims no such equality for it);
  - what stays refused: an unknown kv_cache_dtype, and the tail prefill on
    MoE and MLA configs (all-attention decoders serve quantized pools
    through it: tests/test_torch_tail_prefill.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.kernels.dispatch import set_attention_backend as j_set_attn  # noqa: E402
from repro.kernels.paged_attention import paged_attention as j_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as j_ref  # noqa: E402
from repro.kernels.paged_attention.ref import unpack_int4 as j_unpack_int4  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.engine import _scatter_blocks_quant as j_scatter_quant  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.paged_attention import ops, paged_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ref import unpack_int4  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.engine import _scatter_blocks_quant  # noqa: E402

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


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _close(got, want, bf16=False):
    tol = dict(rtol=5e-2, atol=5e-2) if bf16 else dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------
def test_pack_unpack_int4_round_trip_matches_jax():
    vals = np.arange(-8, 8, dtype=np.int32)
    lo, hi = np.meshgrid(vals, vals, indexing="ij")
    x = np.stack([lo.ravel(), hi.ravel()], axis=-1)  # every (lo, hi) nibble pair
    packed = tatt.pack_int4(_t(x))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (256, 1)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jatt.pack_int4(jnp.asarray(x))))
    np.testing.assert_array_equal(unpack_int4(packed).numpy(), x)
    words = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(unpack_int4(_t(words)).numpy(),
                                  np.asarray(j_unpack_int4(jnp.asarray(words))))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_scale_exp_and_quantize_fixed_match_jax(bits, dtype):
    """Per-(entry, head) exponents over heads 2^±10 apart, amax at exact
    powers of two and a zero head: exponents and mantissas array_equal."""
    qmax = tatt.KV_QMAX[bits]
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((6, 3, 16)).astype(np.float32)
    x *= np.exp2(np.asarray([-10.0, 0.0, 10.0], np.float32))[None, :, None]
    x[0, 0, :] = 0.0
    x[1, 1, 3] = 4.0  # amax exactly 2^2
    x[2, 2, 5] = -0.5  # amax exactly 2^-1
    jx = jnp.asarray(x, dtype)
    tx = _t(x, getattr(torch, dtype))
    je = jatt.block_scale_exp(jx, qmax)
    te = tatt.block_scale_exp(tx, qmax)
    assert te.dtype == torch.int32 and tuple(te.shape) == (6, 3)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert int(te.min()) >= tatt.KV_EXP_MIN and int(te.max()) <= tatt.KV_EXP_MAX
    jq = jatt.quantize_fixed(jx, je, qmax)
    tq = tatt.quantize_fixed(tx, te, qmax)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert int(tq.abs().max()) <= qmax


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_quant_update_matches_jax(bits):
    """Decode-shaped writes: block-start entries calibrate their block,
    others write under the block's existing exponent (their candidate goes
    to the trash row); pool and exponent leaves array_equal to JAX."""
    rng = np.random.default_rng(10 + bits)
    n_blocks, block, K, hd = 7, 4, 2, 16
    w = hd // 2 if bits == 4 else hd
    pool = rng.integers(-7, 8, size=(n_blocks, block, K, w)).astype(np.int8)
    exp = rng.integers(-3, 3, size=(n_blocks, K)).astype(np.int32)
    jp, je, tp, te = jnp.asarray(pool), jnp.asarray(exp), _t(pool), _t(exp)
    for step, idx in enumerate([[4, 9, 16], [5, 10, 17], [8, 12, 18]]):
        new = (rng.standard_normal((3, K, hd)) * (step + 1)).astype(np.float32)
        jp, je = jatt.paged_quant_update(jp, je, jnp.asarray(new), jnp.asarray(idx))
        out = tatt.paged_quant_update(tp, te, _t(new), _t(np.asarray(idx, np.int64)))
        assert out[0] is tp and out[1] is te  # in place
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("src_kind", ["float", "kv_f_int8"])
def test_scatter_blocks_quant_matches_jax(bits, axis, src_kind):
    """Admission: a batch-of-one prefill cache (compute dtype for int4_fp,
    KV_F int8 for int8_fp) written into the quantized pool, bucket blocks
    past the allocated prefix into the trash block."""
    rng = np.random.default_rng(bits * 7 + axis)
    L, n_phys, block, K, hd, max_len, p_blocks = 2, 9, 4, 2, 16, 24, 3
    lead = (L,) if axis else ()
    w = hd // 2 if bits == 4 else hd
    pool = np.zeros(lead + (n_phys, block, K, w), np.int8)
    exp = np.zeros(lead + (n_phys, K), np.int32)
    src = rng.standard_normal(lead + (1, max_len, K, hd)).astype(np.float32)
    if src_kind == "kv_f_int8":
        src = np.clip(np.round(src * 32), -127, 127).astype(np.int8)
    bt = np.asarray([3, 5, 0, 0, 0, 0], np.int32)  # 2 allocated, the rest trash
    jp, je = j_scatter_quant(jnp.asarray(pool), jnp.asarray(exp), jnp.asarray(src),
                             jnp.asarray(bt), axis, p_blocks)
    tp, te = _t(pool), _t(exp)
    _scatter_blocks_quant(tp, te, _t(src), _t(bt), axis, p_blocks)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


# ---------------------------------------------------------------------------
# quantized paged attention: the plain version vs JAX ref and Pallas interpret
# ---------------------------------------------------------------------------
def _quant_case(seed, *, bits, B=3, T=1, K=2, G=2, hd=16, block=8, max_blocks=3):
    """Pools of int8 / split-halves int4 words with per-(block, head)
    exponents in [-8, 4]."""
    rng = np.random.default_rng(seed)
    n_blocks = B * max_blocks + 1
    bt = (rng.permutation(n_blocks - 1)[: B * max_blocks] + 1).reshape(B, max_blocks)
    pos0 = (rng.integers(T - 1, max_blocks * block, size=B) - (T - 1)).astype(np.int32)
    q = rng.standard_normal((B, T, K, G, hd)).astype(np.float32)
    qmax = tatt.KV_QMAX[bits]
    pools, exps = [], []
    for _ in range(2):
        m = rng.integers(-qmax, qmax + 1, size=(n_blocks, block, K, hd)).astype(np.int8)
        pools.append(np.asarray(jatt.pack_int4(jnp.asarray(m))) if bits == 4 else m)
        exps.append(rng.integers(-8, 5, size=(n_blocks, K)).astype(np.int32))
    return q, pools[0], pools[1], exps[0], exps[1], bt.astype(np.int32), pos0


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout,T,window,cap", [
    ("mha", 1, None, 0.0), ("gqa", 1, None, 0.0), ("gqa", 1, 5, 8.0), ("gqa", 4, 7, 0.0),
    ("mha", 4, None, 2.0),
])
def test_quant_attention_matches_jax_ref_and_pallas(bits, layout, T, window, cap):
    K, G = {"gqa": (2, 2), "mha": (4, 1)}[layout]
    q, kp, vp, ke, ve, bt, pos0 = _quant_case(bits * 100 + T, bits=bits, T=T, K=K, G=G)
    kw = dict(scale=16**-0.5, cap=cap, window=window, kv_bits=bits)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, pos0)]
    want = j_ref(*jargs, k_scale_exp=jnp.asarray(ke), v_scale_exp=jnp.asarray(ve), **kw)
    pallas = j_paged(*jargs, k_scale_exp=jnp.asarray(ke), v_scale_exp=jnp.asarray(ve),
                     interpret=True, **kw)
    got = paged_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(pos0), k_scale_exp=_t(ke),
                          v_scale_exp=_t(ve), **kw)
    assert tuple(got.shape) == q.shape
    _close(got.numpy(), want)
    _close(got.numpy(), pallas)
    # bf16 queries (the serving dtype) against the JAX ref on the same bf16 q
    want16 = j_ref(jnp.asarray(q, jnp.bfloat16), *jargs[1:], k_scale_exp=jnp.asarray(ke),
                   v_scale_exp=jnp.asarray(ve), **kw)
    got16 = paged_attention(_t(q, torch.bfloat16), _t(kp), _t(vp), _t(bt), _t(pos0),
                            k_scale_exp=_t(ke), v_scale_exp=_t(ve), **kw)
    assert got16.dtype == torch.bfloat16
    _close(got16.float().numpy(), np.asarray(want16, np.float32), bf16=True)
    assert ops.launches == ops.quant_launches == 0  # CPU calls never count as launches


def test_quant_attention_validates_its_arguments():
    q, kp, vp, ke, ve, bt, pos0 = _quant_case(0, bits=4)
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(pos0))
    with pytest.raises(ValueError):
        paged_attention(*args, scale=0.25, kv_bits=4)  # no exponents
    with pytest.raises(ValueError):
        paged_attention(*args, scale=0.25, k_scale_exp=_t(ke), v_scale_exp=_t(ve))  # no bits
    with pytest.raises(ValueError):
        paged_attention(*args, scale=0.25, k_scale_exp=_t(ke), v_scale_exp=_t(ve), kv_bits=2)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_attn_decode_quantized_pool_matches_jax(bits, backend):
    """The decode layer on a quantized pool: quantize-at-write through
    ``_paged_write`` (pool and exponents array_equal to JAX), then the
    kernel wrapper or the composed ``_paged_read``; row 1 opens a block."""
    cfg_kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=True)
    jcfg, tcfg = jatt.AttnConfig(**cfg_kw), tatt.AttnConfig(**cfg_kw)
    jp = jatt.attn_init(jax.random.PRNGKey(5), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(6 + bits)
    B, block, mb, w = 2, 4, 3, (4 if bits == 4 else 8)
    x = rng.standard_normal((B, 1, 32)).astype(np.float32)
    k = rng.integers(-7, 8, size=(B * mb + 1, block, 2, w)).astype(np.int8)
    v = rng.integers(-7, 8, size=(B * mb + 1, block, 2, w)).astype(np.int8)
    ke = rng.integers(-4, 2, size=(B * mb + 1, 2)).astype(np.int32)
    ve = rng.integers(-4, 2, size=(B * mb + 1, 2)).astype(np.int32)
    bt = (np.arange(B * mb) + 1).reshape(B, mb).astype(np.int32)
    pos = np.asarray([5, 8], np.int32)  # row 1 writes the first slot of its block 2
    j_set_attn("composed")
    try:
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "k_scale": jnp.asarray(ke),
                  "v_scale": jnp.asarray(ve)}
        jy, jc = jatt.attn_decode(jp, jnp.asarray(x), jcache, jnp.asarray(pos), cfg=jcfg,
                                  rope_base=1e6, compute_dtype=jnp.float32,
                                  block_tables=jnp.asarray(bt))
    finally:
        j_set_attn("auto")
    cache = {"k": _t(k), "v": _t(v), "k_scale": _t(ke), "v_scale": _t(ve)}
    dispatch.set_attention_backend(backend)
    try:
        ty, tc = tatt.attn_decode(tp, _t(x), cache, _t(pos), cfg=tcfg, rope_base=1e6,
                                  compute_dtype=torch.float32, block_tables=_t(bt))
    finally:
        dispatch.set_attention_backend("auto")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-4, atol=2e-5)
    for n in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]), err_msg=n)


# ---------------------------------------------------------------------------
# serving reduced olmoe-1b-7b from quantized pools
# ---------------------------------------------------------------------------
def _engines(kv, kind):
    """(jax engine, port engine) per (kv_cache_dtype, param kind)."""
    if (kv, kind) not in _ENG:
        cfg = dataclasses.replace(jconfigs.get_reduced("olmoe-1b-7b"), kv_cache_dtype=kv)
        jp = j_init(jax.random.PRNGKey(0), cfg)
        scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
        st = jcore.symog_init(jp, scfg)
        jp = (jcore.quantize_tree if kind == "quantize_tree" else jcore.pack_tree)(jp, st, scfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
        _ENG[(kv, kind)] = (JEngine(cfg, jp, max_len=MAX_LEN, compute_dtype=jnp.float32),
                            ServeEngine(cfg, tp, max_len=MAX_LEN, compute_dtype=torch.float32,
                                        device="cpu"))
    return _ENG[(kv, kind)]


def _requests(seed=1, lens=(3, 6, 4, 5, 7), budgets=(5, 3, 6, 4, 2)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=L).astype(np.int32), b) for L, b in zip(lens, budgets)]


def _leaves(caches, prefix=()):
    if isinstance(caches, dict):
        for k in sorted(caches):
            yield from _leaves(caches[k], prefix + (k,))
    else:
        yield prefix, caches


@pytest.mark.parametrize("kv", ["int8_fp", "int4_fp", "bf16"])
@pytest.mark.parametrize("kind", ["quantize_tree", "pack_tree"])
def test_serve_quantized_pool_matches_jax(kv, kind):
    jeng, teng = _engines(kv, kind)
    assert teng.kv_quant_bits == {"int8_fp": 8, "int4_fp": 4, "bf16": 0}[kv]
    reqs = _requests()
    sc = dict(n_slots=2, block_size=4)
    jcomps, jsched = jeng.serve([JRequest(tokens=p, max_new_tokens=b) for p, b in reqs],
                                JServeConfig(**sc), return_scheduler=True)
    tcomps, tsched = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                                ServeConfig(**sc), return_scheduler=True)
    for (p, b), jc, tc in zip(reqs, jcomps, tcomps):
        assert tc.tokens == list(jc.tokens)
        assert tc.finish_reason == jc.finish_reason
    for key in ("decode_steps", "prefills", "preemptions"):
        assert tsched.stats[key] == jsched.stats[key], key
    assert tsched.pool.n_live == 0
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jsched.caches)))
    tl = dict(_leaves(tsched.caches))
    assert sorted(jl) == sorted(tl)
    if kv != "bf16":
        names = {path[-1] for path in tl}
        assert names == {"k", "v", "k_scale", "v_scale"}
        for path, leaf in tl.items():
            assert leaf.dtype == (torch.int32 if path[-1].endswith("_scale") else torch.int8)
            np.testing.assert_array_equal(leaf.numpy(), jl[path], err_msg=str(path))
        # serving twice gives identical tokens (the pool is its own oracle)
        again = teng.serve([Request(tokens=p, max_new_tokens=b) for p, b in reqs],
                           ServeConfig(**sc))
        assert [c.tokens for c in again] == [c.tokens for c in tcomps]
    else:
        for (p, b), tc in zip(reqs, tcomps):
            static = teng.generate_static({"tokens": p[None]}, b)[0].numpy()
            np.testing.assert_array_equal(np.asarray(tc.tokens), static)


def test_quantized_pool_bytes():
    """int4 pools hold hd/2 words per (token, head) plus one int32 exponent
    per (block, head): about a quarter of the fp32 pool at this size."""
    b = {}
    for kv in ("int4_fp", "int8_fp", "bf16"):
        _, teng = _engines(kv, "pack_tree")
        from repro_torch.serve.scheduler import Scheduler

        b[kv] = Scheduler(teng, ServeConfig(n_slots=2, block_size=4)).cache_bytes()
    cfg = jconfigs.get_reduced("olmoe-1b-7b")
    n_phys, L, K, hd, blk = 2 * (MAX_LEN // 4) + 1, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 4
    assert b["int8_fp"] == 2 * L * n_phys * K * (blk * hd + 4)
    assert b["int4_fp"] == 2 * L * n_phys * K * (blk * hd // 2 + 4)
    assert b["bf16"] == 2 * L * n_phys * K * blk * hd * 4  # fp32 compute: fp32 pool


def test_all_attention_decoder_still_refuses_quantized_pools():
    """What stays refused: an unknown kv_cache_dtype, and the tail prefill
    (the admission of all-attention decoders to a quantized pool) on MoE and
    MLA configs, as in the JAX package."""
    from repro_torch.models import prefill_prefix_lm

    cfg = dataclasses.replace(jconfigs.get_reduced("olmoe-1b-7b"), kv_cache_dtype="fp8")
    with pytest.raises(ValueError):
        ServeEngine(cfg, {}, max_len=8, device="cpu")
    for arch in ("olmoe-1b-7b", "deepseek-v3-671b"):
        cfg = dataclasses.replace(jconfigs.get_reduced(arch), kv_cache_dtype="int4_fp")
        with pytest.raises(NotImplementedError, match="all-attention"):
            prefill_prefix_lm({}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, {},
                              torch.zeros(2, dtype=torch.int32), 0, cfg, seq_len=3)
