"""Port parity, MoE (repro_torch vs the JAX package) on the CPU, with
JAX-initialized params bridged through numpy:

  - ``moe_apply`` against JAX ``moe_apply`` for both routers, with and
    without shared experts, at ample capacity, at a capacity that drops
    tokens, and with a bucketed ``seq_len`` shorter than the padded length
    (mirrors tests/test_blocks.py), plus the aux losses; and against
    ``moe_apply_dense_ref`` where nothing drops — fp32 rtol 1e-5, atol 1e-6;
  - ``fixedpoint_matmul_experts`` (the plain version the wrapper runs on
    CPU tensors) against the Pallas kernel in interpret mode and JAX's
    ref.py at 2 and 4 bits with one f per expert (rtol = atol = 1e-5), and
    ``packed_expert_einsum`` on both packed backends against the 'unpack'
    path (mirrors tests/test_packed_serving.py);
  - the bridge keeps a stacked expert leaf's per-expert ``Packed.f`` (L, E),
    and ``unstack_layers`` cuts it to (E,) per layer;
  - reduced olmoe-1b-7b: forward logits, prefill and dense / paged decode
    match JAX at the ``TOL`` of tests/test_torch_lm.py for float,
    ``quantize_tree`` and ``pack_tree`` params; the packed artifact carries
    one f per (layer, expert); the static loop's tokens equal JAX's;
  - MoE training stays refused.

Serving the reduced olmoe through the scheduler (bf16 and quantized pools)
is held in tests/test_torch_kv_quant.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.kernels.dispatch import set_packed_backend as j_set_backend  # noqa: E402
from repro.kernels.fixedpoint_matmul.ops import fixedpoint_matmul_experts as j_fpmm_e  # noqa: E402
from repro.kernels.fixedpoint_matmul.ref import (  # noqa: E402
    fixedpoint_matmul_experts_ref as j_ref_e,
)
from repro.models import decode_lm as j_decode  # noqa: E402
from repro.models import forward_lm as j_forward  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import prefill_lm as j_prefill  # noqa: E402
from repro.models.quantized import packed_expert_einsum as j_pee  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import Packed, pack  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul import fixedpoint_matmul_experts, ops  # noqa: E402
from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_experts_ref  # noqa: E402
from repro_torch.models import decode_lm, forward_lm, init_lm, lm_train_loss, prefill_lm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.quantized import packed_expert_einsum, unstack_layers  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

MOE_TOL = dict(rtol=1e-5, atol=1e-6)
FPMM_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_lm.py
_TREES = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
def _moe(seed, **kw):
    """(jax cfg, port cfg, jax params, port params)."""
    cfg_kw = dict(d_model=16, n_experts=8, top_k=2, d_ff_expert=8, capacity_factor=8.0)
    cfg_kw.update(kw)
    jcfg, tcfg = jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _bridge(jp)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("case", ["ample", "drops", "seq_len", "seq_len_drops"])
def test_moe_apply_matches_jax(router, shared, case):
    jcfg, tcfg, jp, tp = _moe(3, router=router, n_shared_experts=shared,
                              capacity_factor=1.0 if "drops" in case else 8.0)
    x = (np.random.default_rng(4).standard_normal((2, 12, 16)) * 0.5).astype(np.float32)
    kw = {}
    if case.startswith("seq_len"):
        kw["seq_len"] = 9  # rows padded from 9 real tokens to 12
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg=jcfg, compute_dtype=jnp.float32,
                              seq_len=jnp.asarray(kw["seq_len"], jnp.int32) if kw else None)
    ty, taux = tmoe.moe_apply(tp, _t(x), cfg=tcfg, compute_dtype=torch.float32, **kw)
    n = kw.get("seq_len", 12)
    np.testing.assert_allclose(ty.numpy()[:, :n], np.asarray(jy)[:, :n], **MOE_TOL)
    for name in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(taux[name].numpy(), np.asarray(jaux[name]), **MOE_TOL)
    if case == "ample":  # nothing drops: the dense per-token oracle
        ref = tmoe.moe_apply_dense_ref(tp, _t(x), cfg=tcfg)
        np.testing.assert_allclose(ty.numpy(), ref.numpy(), **MOE_TOL)
        np.testing.assert_allclose(
            ref.numpy(), np.asarray(jmoe.moe_apply_dense_ref(jp, jnp.asarray(x), cfg=jcfg)),
            **MOE_TOL)
    if "drops" in case:  # some real token's assignment really dropped
        ref = tmoe.moe_apply_dense_ref(tp, _t(x), cfg=tcfg)
        assert not np.allclose(ty.numpy()[:, :n], ref.numpy()[:, :n], **MOE_TOL)


@pytest.mark.parametrize("capacity", [1, 3])
def test_moe_fixed_capacity_and_dropped_slot_owner(capacity):
    """Decode-style fixed capacity.  At capacity 1 every expert's only slot
    is taken by its first assignment; later ones drop onto it with weight 0
    and must not overwrite it (JAX adds zero there)."""
    jcfg, tcfg, jp, tp = _moe(5, n_experts=4, capacity_factor=1.25)
    x = np.random.default_rng(6).standard_normal((3, 4, 16)).astype(np.float32)
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x), cfg=jcfg, compute_dtype=jnp.float32,
                           capacity=capacity)
    ty, aux = tmoe.moe_apply(tp, _t(x), cfg=tcfg, compute_dtype=torch.float32,
                             capacity=capacity, with_aux=False)
    assert aux == {}
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    assert np.all(np.isfinite(ty.numpy()))


def test_moe_bf16_combine_is_deterministic_and_close_to_jax():
    jcfg, tcfg, jp, tp = _moe(7)
    x = np.random.default_rng(8).standard_normal((2, 6, 16)).astype(np.float32)
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x), cfg=jcfg, compute_dtype=jnp.bfloat16)
    a, _ = tmoe.moe_apply(tp, _t(x), cfg=tcfg, compute_dtype=torch.bfloat16)
    b, _ = tmoe.moe_apply(tp, _t(x), cfg=tcfg, compute_dtype=torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    np.testing.assert_allclose(a.float().numpy(), np.asarray(jy, np.float32), rtol=5e-2,
                               atol=5e-2)


# ---------------------------------------------------------------------------
# the experts form of the fixed-point matmul
# ---------------------------------------------------------------------------
def _experts_case(seed, E, C, K, N, n_bits):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((E, K, N)) * 0.3).astype(np.float32)
    f = rng.integers(-1, 5, size=E).astype(np.int32)  # one exponent per expert
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    pk = pack(_t(w), _t(f), n_bits)
    return x, pk


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("ECKN", [(3, 8, 16, 24), (4, 5, 32, 64), (2, 1, 128, 16),
                                  (4, 20, 32, 48)])  # C = 20: a prefill bucket's capacity
def test_fixedpoint_matmul_experts_matches_pallas(n_bits, ECKN):
    E, C, K, N = ECKN
    x, pk = _experts_case(E + C + n_bits, E, C, K, N, n_bits)
    words, f = pk.data.numpy(), pk.f.numpy()
    want = np.asarray(j_fpmm_e(jnp.asarray(x), jnp.asarray(words), jnp.asarray(f),
                               n_bits=n_bits, n_out=N, interpret=True))
    before = (ops.experts_launches, ops.tc_experts_launches)
    got = fixedpoint_matmul_experts(_t(x), pk.data, pk.f, n_bits=n_bits, n_out=N)
    # CPU calls never count as kernel launches, on either route
    assert (ops.experts_launches, ops.tc_experts_launches) == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (E, C, N)
    np.testing.assert_allclose(got.numpy(), want, **FPMM_TOL)
    ref = fixedpoint_matmul_experts_ref(_t(x), pk.data, pk.f, n_bits=n_bits, n_out=N)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(j_ref_e(jnp.asarray(x), jnp.asarray(words), jnp.asarray(f),
                                        n_bits=n_bits, n_out=N)), **FPMM_TOL)
    got16 = fixedpoint_matmul_experts(_t(x).bfloat16(), pk.data, pk.f, n_bits=n_bits, n_out=N)
    assert got16.dtype == torch.bfloat16


def _rows_for(rng, E, C, fill):
    """rows (E,) of kept assignments: random in 0..C (about half the experts
    empty), all 0, or all C."""
    if fill == "random":
        return rng.integers(1, C + 1, size=E) * (rng.random(E) < 0.5)
    return np.full(E, 0 if fill == "empty" else C)


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("fill", ["random", "empty", "full"])
@pytest.mark.parametrize("E,C", [(1, 1), (1, 4), (8, 1), (8, 4), (64, 1), (64, 4)])
def test_fixedpoint_matmul_experts_rows_matches_pallas(E, C, fill, n_bits):
    """The plain version with occupied-expert ``rows`` (the rows of x past
    rows[e] zero, as the MoE dispatch leaves them): ``array_equal`` to the
    all-experts call, +0 for every empty expert even under a scale 2^-f =
    inf, and equal to JAX's Pallas kernel (interpret) on the occupied
    experts; the wrapper's CPU path takes the same rows."""
    K, N = 32, 48
    rng = np.random.default_rng(E * 11 + C + n_bits)
    x, pk = _experts_case(E * 3 + C + n_bits, E, C, K, N, n_bits)
    rows = _rows_for(rng, E, C, fill)
    x[np.arange(C)[None, :] >= rows[:, None]] = 0.0
    rt = _t(rows.astype(np.int32))
    every = fixedpoint_matmul_experts_ref(_t(x), pk.data, pk.f, n_bits=n_bits, n_out=N)
    got = fixedpoint_matmul_experts_ref(_t(x), pk.data, pk.f, n_bits=n_bits, n_out=N, rows=rt)
    assert torch.equal(got, every)
    empty = rows == 0
    assert not got[_t(empty)].signbit().any()
    f_inf = torch.where(rt > 0, pk.f, torch.full_like(pk.f, -200))
    skipped = fixedpoint_matmul_experts_ref(_t(x), pk.data, f_inf, n_bits=n_bits, n_out=N,
                                            rows=rt)
    assert torch.equal(skipped, got) and not skipped[_t(empty)].signbit().any()
    wrapped = fixedpoint_matmul_experts(_t(x), pk.data, pk.f, n_bits=n_bits, n_out=N, rows=rt,
                                        max_active=1)
    assert torch.equal(wrapped, got)
    occ = np.flatnonzero(~empty)
    if occ.size:
        want = np.asarray(j_fpmm_e(jnp.asarray(x[occ]), jnp.asarray(pk.data.numpy()[occ]),
                                   jnp.asarray(pk.f.numpy()[occ]), n_bits=n_bits, n_out=N,
                                   interpret=True))
        np.testing.assert_allclose(got.numpy()[occ], want, **FPMM_TOL)


def _packed_moe(seed, **kw):
    """``_moe`` with the expert stacks packed (2-bit, one f per expert) in
    both packages, from the same words."""
    jcfg, tcfg, jp, tp = _moe(seed, **kw)
    rng = np.random.default_rng(seed)
    for name in ("gate_proj", "up_proj", "down_proj"):
        w = tp["experts"][name]["kernel"]
        f = _t(rng.integers(1, 4, size=w.shape[0]).astype(np.int32))
        pk = pack(w, f, 2)
        tp["experts"][name]["kernel"] = pk
        jp["experts"][name]["kernel"] = jcore.Packed(data=jnp.asarray(pk.data.numpy()), n_bits=2,
                                                     f=jnp.asarray(f.numpy()))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("case", ["ample", "drops", "seq_len", "decode"])
def test_moe_apply_expert_rows_bit_identical(router, case):
    """``moe_apply`` over packed expert stacks, which hands the experts
    matmul each expert's row count, is bit-identical to the same call with
    the counts withheld, and keeps its parity with JAX: both
    routers, with drops, with a bucketed ``seq_len``, and at a decode
    step's fixed capacity (4 tokens, top-2 of 8 experts)."""
    jcfg, tcfg, jp, tp = _packed_moe(21, router=router,
                                     capacity_factor=1.0 if case == "drops" else 8.0)
    shape = (4, 1, 16) if case == "decode" else (2, 12, 16)
    x = (np.random.default_rng(22).standard_normal(shape) * 0.5).astype(np.float32)
    kw, jkw = {}, {}
    if case == "seq_len":
        kw["seq_len"] = 9
        jkw["seq_len"] = jnp.asarray(9, jnp.int32)
    if case == "decode":
        kw["capacity"] = jkw["capacity"] = 4
    a, _ = tmoe.moe_apply(tp, _t(x), cfg=tcfg, compute_dtype=torch.float32, **kw)
    with pytest.MonkeyPatch.context() as mp:  # the experts matmul without the rows
        mp.setattr(tmoe, "packed_expert_einsum",
                   lambda z, pk, compute_dtype=None, rows=None, max_active=None:
                   packed_expert_einsum(z, pk, compute_dtype=compute_dtype))
        b, _ = tmoe.moe_apply(tp, _t(x), cfg=tcfg, compute_dtype=torch.float32, **kw)
    assert torch.equal(a, b)
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x), cfg=jcfg, compute_dtype=jnp.float32, **jkw)
    n = kw.get("seq_len", shape[1])
    np.testing.assert_allclose(a.numpy()[:, :n], np.asarray(jy)[:, :n], **MOE_TOL)
    if case == "decode":  # 8 assignments over 8 experts: some expert holds none
        e_ids = tmoe._route(tp, _t(x).reshape(4, 16), tcfg, False)[1]
        assert len(set(e_ids.reshape(-1).tolist())) < tcfg.n_experts


@pytest.mark.parametrize("n_bits", [2, 4])
@pytest.mark.parametrize("backend", ["kernel", "unpack"])
def test_packed_expert_einsum_matches_unpack_path(n_bits, backend):
    x, pk = _experts_case(9 + n_bits, 3, 8, 16, 24, n_bits)
    jpk = jcore.Packed(data=jnp.asarray(pk.data.numpy()), n_bits=n_bits,
                       f=jnp.asarray(pk.f.numpy()))
    try:
        j_set_backend("unpack")
        want = np.asarray(j_pee(jnp.asarray(x), jpk, compute_dtype=jnp.float32))
    finally:
        j_set_backend("auto")
    try:
        dispatch.set_packed_backend(backend)
        got = packed_expert_einsum(_t(x), pk, compute_dtype=torch.float32)
    finally:
        dispatch.set_packed_backend("auto")
    np.testing.assert_allclose(got.numpy(), want, **FPMM_TOL)


# ---------------------------------------------------------------------------
# reduced olmoe-1b-7b
# ---------------------------------------------------------------------------
def _trees(kind):
    """(cfg, jax tree, port tree) per param kind, built once per module."""
    if kind not in _TREES:
        cfg = jconfigs.get_reduced("olmoe-1b-7b")
        jp = j_init(jax.random.PRNGKey(0), cfg)
        if kind != "float":
            scfg = jcore.SymogConfig(n_bits=2, total_steps=1)
            st = jcore.symog_init(jp, scfg)
            jp = (jcore.quantize_tree if kind == "quantize_tree" else jcore.pack_tree)(jp, st, scfg)
        _TREES[kind] = (cfg, jp, _bridge(jp))
    return _TREES[kind]


def test_packed_artifact_has_per_expert_f_and_bridges():
    cfg, jp, tp = _trees("pack_tree")
    stack = tp["layers0"]["sub0"]["moe"]["experts"]
    for name in ("gate_proj", "up_proj", "down_proj"):
        pk = stack[name]["kernel"]
        assert isinstance(pk, Packed)
        assert tuple(pk.f.shape) == (cfg.n_layers, cfg.n_experts) and pk.f.dtype == torch.int32
        jf = np.asarray(jp["layers0"]["sub0"]["moe"]["experts"][name]["kernel"].f)
        np.testing.assert_array_equal(pk.f.numpy(), jf)
        layers = unstack_layers({"k": pk}, cfg.n_layers)
        assert [tuple(lay["k"].f.shape) for lay in layers] == [(cfg.n_experts,)] * cfg.n_layers
        assert tuple(layers[1]["k"].data.shape) == tuple(pk.data.shape[1:])
        np.testing.assert_array_equal(layers[2]["k"].f.numpy(), jf[2])
    # the router stays float, attention projections keep one f per stack
    assert not isinstance(tp["layers0"]["sub0"]["moe"]["router"]["kernel"], Packed)
    assert tp["layers0"]["sub0"]["attn"]["q_proj"]["kernel"].f.ndim == 0
    assert isinstance(tp["lm_head"]["kernel"], Packed)  # olmoe's untied packed head


KINDS = ["float", "quantize_tree", "pack_tree"]


def _tokens(B=2, T=7, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(B, T)).astype(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_lm_matches_jax(kind):
    cfg, jp, tp = _trees(kind)
    tok = _tokens()
    want = j_forward(jp, {"tokens": jnp.asarray(tok)}, cfg, compute_dtype=jnp.float32).logits
    got = forward_lm(tp, {"tokens": _t(tok)}, cfg, compute_dtype=torch.float32)
    assert tuple(got.logits.shape) == (2, 7, cfg.vocab_size)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_and_dense_decode_match_jax(kind):
    """Static-loop decode (bounded capacity max(top_k, ceil(2·B·k/E)))."""
    cfg, jp, tp = _trees(kind)
    tok, max_len = _tokens(), 12
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(tok)}, cfg, max_len=max_len,
                       compute_dtype=jnp.float32)
    tl, tc = prefill_lm(tp, {"tokens": _t(tok)}, cfg, max_len=max_len,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for step in range(3):
        jl, jc = j_decode(jp, jc, jnp.asarray(nxt), 7 + step, cfg, compute_dtype=jnp.float32)
        tl, tc = decode_lm(tp, tc, _t(nxt), 7 + step, cfg, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("kind", ["float", "pack_tree"])
def test_paged_decode_dropless_matches_jax(kind):
    """Scheduler-style decode: per-row positions, paged pools, ``active``
    given, so MoE runs dropless (capacity = rows), as in JAX."""
    cfg, jp, tp = _trees(kind)
    block, nb, B, L = 4, 4, 2, cfg.n_layers
    lens = [5, 9]
    n_phys = B * nb + 1
    shape = (L, n_phys, block, cfg.n_kv_heads, cfg.head_dim)
    jpool = {n: jnp.zeros(shape, jnp.float32) for n in ("k", "v")}
    tpool = {n: torch.zeros(shape) for n in ("k", "v")}
    bt = (np.arange(B * nb) + 1).reshape(B, nb).astype(np.int32)
    rng = np.random.default_rng(3)
    for b, n in enumerate(lens):  # fill the prompts' KV through prefill
        tok = rng.integers(0, 256, size=(1, n)).astype(np.int32)
        _, jc = j_prefill(jp, {"tokens": jnp.asarray(tok)}, cfg, max_len=nb * block,
                          compute_dtype=jnp.float32)
        for name in ("k", "v"):
            src = np.asarray(jc["layers0"]["sub0"][name])[:, 0].reshape(L, nb, block,
                                                                          cfg.n_kv_heads,
                                                                          cfg.head_dim)
            jpool[name] = jpool[name].at[:, bt[b]].set(src)
            tpool[name][:, torch.from_numpy(bt[b]).long()] = _t(src)
    pos = np.asarray(lens, np.int32)
    active = np.asarray([True, True])
    jcaches = {"layers0": {"sub0": jpool}}
    tcaches = {"layers0": {"sub0": tpool}}
    tok = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
    for step in range(3):
        jl, jcaches = j_decode(jp, jcaches, jnp.asarray(tok), jnp.asarray(pos), cfg,
                               compute_dtype=jnp.float32, active=jnp.asarray(active),
                               block_tables=jnp.asarray(bt))
        tl, tcaches = decode_lm(tp, tcaches, _t(tok), _t(pos), cfg, compute_dtype=torch.float32,
                                active=_t(active), block_tables=_t(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1


def test_generate_static_tokens_match_jax():
    cfg, jp, tp = _trees("pack_tree")
    tok = _tokens(B=3, T=6, seed=5)
    jeng = JEngine(cfg, jp, max_len=16, compute_dtype=jnp.float32)
    teng = ServeEngine(cfg, tp, max_len=16, compute_dtype=torch.float32, device="cpu")
    want = np.asarray(jeng.generate_static({"tokens": jnp.asarray(tok)}, 6))
    np.testing.assert_array_equal(teng.generate_static({"tokens": tok}, 6).numpy(), want)


def test_moe_training_stays_refused_and_init_serves():
    cfg = jconfigs.get_reduced("olmoe-1b-7b")
    params = init_lm(0, cfg, device="cpu")
    assert tuple(params["layers0"]["sub0"]["moe"]["experts"]["gate_proj"]["kernel"].shape) == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    assert params["layers0"]["sub0"]["moe"]["router"]["kernel"].dtype == torch.float32
    tok = _t(_tokens())
    with pytest.raises(NotImplementedError, match="MoE"):
        lm_train_loss(params, {"tokens": tok}, cfg)
    out = forward_lm(params, {"tokens": tok}, cfg, compute_dtype=torch.float32)
    assert bool(torch.isfinite(out.logits).all())
