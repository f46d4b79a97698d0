"""Port parity, fused SYMOG update (repro_torch.kernels.symog_update vs
repro.kernels.symog_update): the plain torch version (the wrapper's CPU
path) against JAX's ``symog_update_ref`` and its Pallas kernel in interpret
mode, at tests/test_kernels.py's bar (rtol 1e-6, atol 1e-7); half-step ties
round to even in both; and the update equals the paper's Alg. 1 l.15–17
composed from the port's core pieces (tests/test_kernels.py:43)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.kernels import symog_update as j_symog_update  # noqa: E402
from repro.kernels.symog_update.ref import symog_update_ref as j_ref  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels.symog_update import ops as sops  # noqa: E402
from repro_torch.kernels.symog_update import symog_update  # noqa: E402
from repro_torch.kernels.symog_update.ref import symog_update_ref  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)  # tests/test_kernels.py:22-23
KW = dict(delta=0.25, lam_eff=0.7, lr=0.01, mu=0.9)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    return w, g, v


def _port(w, g, v, **kw):
    """The wrapper on CPU tensors: in place on copies of w and v."""
    tw, tg, tv = (torch.from_numpy(a.copy()) for a in (w, g, v))
    before = sops.launches
    out = symog_update(tw, tg, tv, **kw)
    assert out[0] is tw and out[1] is tv  # updated in place
    assert sops.launches == before  # the plain version is no kernel launch
    return tw.numpy(), tv.numpy()


@pytest.mark.parametrize("shape", [(64,), (100,), (57, 33), (4, 5, 6), (300, 128)])
@pytest.mark.parametrize("n_bits", [2, 4])
def test_symog_update_matches_jax_ref_and_pallas(shape, n_bits):
    w, g, v = _inputs(shape, seed=len(shape) * 10 + n_bits)
    kw = dict(KW, n_bits=n_bits)
    tw, tv = _port(w, g, v, **kw)
    rw, rv = symog_update_ref(torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(v), **kw)
    np.testing.assert_array_equal(tw, rw.numpy())
    np.testing.assert_array_equal(tv, rv.numpy())
    jw, jv = j_ref(jnp.asarray(w), jnp.asarray(g), jnp.asarray(v), **kw)
    np.testing.assert_allclose(tw, np.asarray(jw), **TOL)
    np.testing.assert_allclose(tv, np.asarray(jv), **TOL)
    kw_, kv_ = j_symog_update(jnp.asarray(w), jnp.asarray(g), jnp.asarray(v), **kw)
    np.testing.assert_allclose(tw, np.asarray(kw_), **TOL)
    np.testing.assert_allclose(tv, np.asarray(kv_), **TOL)


@pytest.mark.parametrize("n_bits", [2, 4])
def test_symog_update_ties_round_half_to_even(n_bits):
    """w exactly on half steps (k+½)Δ: with g = v = 0 and λ_eff = 1, v' is
    the exact quantization error w − mΔ, so the mode m each framework chose
    is recovered exactly — and must be the half-to-even one."""
    delta, q = 0.25, 2 ** (n_bits - 1) - 1
    k = np.arange(-q - 1, q + 1, dtype=np.float32)
    w = np.tile((k + 0.5) * delta, 8).astype(np.float32)
    z = np.zeros_like(w)
    kw = dict(delta=delta, lam_eff=1.0, lr=0.0, mu=0.9, n_bits=n_bits)
    _, tv = _port(w, z, z, **kw)
    _, jv = j_symog_update(jnp.asarray(w), jnp.asarray(z), jnp.asarray(z), **kw)
    _, rv = j_ref(jnp.asarray(w), jnp.asarray(z), jnp.asarray(z), **kw)
    want = np.clip(np.round(w / delta), -q, q)  # numpy rounds half to even
    for v in (tv, np.asarray(jv), np.asarray(rv)):
        np.testing.assert_array_equal(np.rint((w - v) / delta), want)
    np.testing.assert_array_equal(tv, np.asarray(rv))


def test_symog_update_equals_paper_semantics():
    """Fused update == Alg. 1 l.15-17 composed from repro_torch.core pieces,
    and == the same composition from repro.core."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 32)) * 0.4).astype(np.float32)
    g = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    v = np.zeros_like(w)
    tw0, tg, tvz = torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(v)
    f, delta = tcore.optimal_f(tw0, 2)
    lam, lr, mu = 3.0, 0.02, 0.9
    lam_eff = lam * 2.0 / w.size
    tw, tv = _port(w, g, v, delta=float(delta), lam_eff=lam_eff, lr=lr, mu=mu, n_bits=2)
    g_tot = tg + lam * tcore.layer_reg_grad(tw0, delta, 2)
    v_ref = mu * tvz + g_tot
    w_ref = tcore.clip_to_range(tw0 - lr * (g_tot + mu * v_ref), delta, 2)
    np.testing.assert_allclose(tw, w_ref.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tv, v_ref.numpy(), rtol=1e-5, atol=1e-7)
    jd = jcore.delta_from_f(int(f))
    jg_tot = jnp.asarray(g) + lam * jcore.layer_reg_grad(jnp.asarray(w), jd, 2)
    jv_ref = jg_tot
    jw_ref = jcore.clip_to_range(jnp.asarray(w) - lr * (jg_tot + mu * jv_ref), jd, 2)
    np.testing.assert_allclose(tw, np.asarray(jw_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tv, np.asarray(jv_ref), rtol=1e-5, atol=1e-7)


def test_symog_update_delta_tensor_and_clip():
    """Δ as a one-element fp32 tensor (the trainer's form) gives the float's
    result; weights far outside ±Δ·qmax land exactly on the clip limit."""
    w, g, v = _inputs((333,), seed=5)
    w[:50] = 4.0
    w[50:100] = -4.0
    kw = dict(lam_eff=0.5, lr=0.01, mu=0.9, n_bits=2)
    a = _port(w, g, v, delta=0.125, **kw)
    b = _port(w, g, v, delta=torch.tensor(0.125), **kw)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0][:50], np.full(50, 0.125, np.float32))
    np.testing.assert_array_equal(a[0][50:100], np.full(50, -0.125, np.float32))
    assert np.abs(a[0]).max() <= 0.125


def test_symog_update_rejects_bad_operands():
    w = torch.zeros(16)
    with pytest.raises(TypeError):
        symog_update(w.double(), w.double(), w.double(), **KW)
    with pytest.raises(TypeError):
        symog_update(w, w.to(torch.bfloat16), w.clone(), **KW)
    with pytest.raises(ValueError):
        m = torch.zeros(4, 8)
        symog_update(m.t(), torch.zeros(8, 4), torch.zeros(8, 4), **KW)
    with pytest.raises(ValueError):
        symog_update(w, torch.zeros(8), w.clone(), **KW)
    with pytest.raises(ValueError):
        symog_update(w, w.clone(), w.clone(), **dict(KW, delta=torch.tensor(0.25).double()))
