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

from repro_torch.kernels.fixedpoint_matmul import fixedpoint_matmul, ops as fops  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul import fixedpoint_matmul_experts  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul import pack_weight  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul.ref import (  # noqa: E402
    fixedpoint_matmul_experts_ref,
    fixedpoint_matmul_ref,
)
from repro_torch.kernels.paged_attention import ops as aops, paged_attention  # noqa: E402
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
    before = fops.launches
    got = fixedpoint_matmul(x, pw, f, b, n_bits=n_bits, n_out=N)
    torch.cuda.synchronize()
    assert fops.launches == before + 1 and got.dtype == dt
    want = fixedpoint_matmul_ref(x, pw, f, b, n_bits=n_bits, n_out=N).to(dt)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


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
                                     (64, 80, 2048, 1024), (5, 80, 512, 96), (3, 1, 96, 40)])
def test_fixedpoint_matmul_experts_matches_plain(dev, n_bits, dtype, E, C, K, N):
    dt = getattr(torch, dtype)
    x, words, f = _experts_case(dev, E, C, K, N, n_bits, dt, seed=E * 13 + C + n_bits)
    before = fops.experts_launches
    got = fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N)
    torch.cuda.synchronize()
    assert fops.experts_launches == before + 1 and got.dtype == dt
    want = fixedpoint_matmul_experts_ref(x, words, f, n_bits=n_bits, n_out=N).to(dt)
    tol = dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # deterministic: no atomics in any sum
    again = fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N)
    assert torch.equal(got, again)


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
