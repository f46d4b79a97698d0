"""Port parity, SYMOG training of the MoE decoders (repro_torch vs the JAX
package) on the CPU, on REDUCED olmoe-1b-7b and deepseek-v3 (MLA, a leading
dense layer, a shared expert, the MTP module).  The float trees are the
port's seeded ``init_lm`` carried into JAX arrays; every other input is
numpy from a seed.

  - ``symog_update`` with a Δ per leading group (its plain version, the
    wrapper's CPU path) against JAX's composed update of one expert leaf
    (``reg_grad`` with the per-expert ``_delta_for`` broadcast, Nesterov
    SGD, ``clip_tree``) at rtol 1e-5 / atol 1e-7 (λ_eff = λ·2/M_l is one
    fp32 product, an ulp from the composed route), and bit for bit against
    the single-Δ plain version run group by group; the wrapper refuses a Δ
    whose count does not divide the leaf;
  - ``moe_apply`` with drops: value, aux and grads against ``jax.grad`` of
    JAX's at fp32 rtol 1e-5; dropped assignments receive no gradient; two
    backward passes are bit-identical;
  - ``lm_train_loss`` (every metric key: ce, moe_aux_loss, moe_z_loss,
    mtp_ce, loss) and the grads of every leaf against JAX's at fp32 rtol
    1e-5 (grads 1e-4, as tests/test_torch_train.py);
  - three ``make_train_step`` steps on the 'composed' and 'fused' routes
    against JAX's jitted step: losses and metrics at rtol 1e-5, params at
    tests/test_torch_train.py's STEP_TOL, momentum at STEP_TOL scaled by the
    leaf's largest value (the embedding's grads cancel across positions);
  - remat on and off: the same loss and grads, bit for bit."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.lm import lm_train_loss as j_loss  # noqa: E402
from repro.nn.tree import flatten_with_paths as j_flatten  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.symog_update import ops as sops  # noqa: E402
from repro_torch.kernels.symog_update import symog_update  # noqa: E402
from repro_torch.kernels.symog_update.ref import symog_update_ref  # noqa: E402
from repro_torch.models import init_lm, lm_train_loss  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths as t_flatten  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_train.py
UPDATE_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_KEYS = {"olmoe-1b-7b": {"ce", "moe_aux_loss", "moe_z_loss", "loss"},
             "deepseek-v3-671b": {"ce", "moe_aux_loss", "moe_z_loss", "mtp_ce", "loss"}}
_TREES = {}



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it and
    these many small ops then wait on each other's thread pools (the LeNet
    recipe took minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(arch):
    """(jax cfg, port cfg, jax tree, port-tree factory, 3 numpy batches), once
    per arch: the port's seeded init carried into JAX arrays."""
    if arch not in _TREES:
        tcfg = tconfigs.get_reduced(arch)
        npp = jax.tree_util.tree_map(lambda t: t.numpy(), init_lm(0, tcfg, device="cpu"))
        rng = np.random.default_rng(3)
        batches = [{"tokens": rng.integers(0, tcfg.vocab_size, (4, 12)).astype(np.int32)}
                   for _ in range(3)]
        _TREES[arch] = (jconfigs.get_reduced(arch), tcfg,
                        jax.tree_util.tree_map(jnp.asarray, npp), npp, batches)
    jcfg, tcfg, jp, npp, batches = _TREES[arch]
    return jcfg, tcfg, jp, (lambda: params_from_numpy(npp)), batches


# ---------------------------------------------------------------------------
# symog_update: a Δ per leading group
# ---------------------------------------------------------------------------
def _leaf(shape, lead, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(1, 5, size=lead).astype(np.int32)
    d = np.exp2(-f.astype(np.float32)).reshape(lead + (1,) * (len(shape) - len(lead)))
    w = (rng.standard_normal(shape) * 1.3 * d).astype(np.float32)  # weights on each grid
    g = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    return w, g, v, f


@pytest.mark.parametrize("shape,lead", [((3, 5, 7, 9), (3, 5)), ((2, 4, 16, 8), (2, 4))])
@pytest.mark.parametrize("n_bits", [2, 4])
def test_grouped_symog_update_matches_jax_composed_update(shape, lead, n_bits):
    """(3, 5, 7, 9): groups of 63, not a multiple of 4 (the kernel's scalar
    path); (2, 4, 16, 8): groups of 128 (its vector path)."""
    w, g, v, f = _leaf(shape, lead, seed=sum(shape) + n_bits)
    lam, lr, mu = 37.0, 0.05, 0.9
    scfg = jcore.SymogConfig(n_bits=n_bits, total_steps=10)
    jst = jcore.SymogState(f={"w": jnp.asarray(f)}, mask={"w": True})
    jw = {"w": jnp.asarray(w)}
    rg = jcore.reg_grad(jw, jst, scfg)
    grads = {"w": jnp.asarray(g) + lam * rg["w"]}
    upd, jv = joptim.sgd(momentum=mu).update(grads, {"w": jnp.asarray(v)}, jw, lr=lr)
    jw = jcore.clip_tree(joptim.apply_updates(jw, upd), jst, scfg)

    tw, tg, tv = (torch.from_numpy(a.copy()) for a in (w, g, v))
    delta = tcore.delta_from_f(torch.from_numpy(f))
    assert tuple(delta.shape) == lead
    before = sops.launches
    symog_update(tw, tg, tv, delta=delta, lam_eff=lam * 2.0 / w.size, lr=lr, mu=mu,
                 n_bits=n_bits)
    assert sops.launches == before  # the plain version is no kernel launch
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw["w"]), **UPDATE_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv["w"]), **UPDATE_TOL)

    # group by group, the single-Δ plain version gives the same bits
    G = int(np.prod(lead))
    kw = dict(lam_eff=lam * 2.0 / w.size, lr=lr, mu=mu, n_bits=n_bits)
    for i, (wi, gi, vi) in enumerate(zip(*(a.reshape(G, -1) for a in (w, g, v)))):
        rw, rv = symog_update_ref(torch.from_numpy(wi), torch.from_numpy(gi),
                                  torch.from_numpy(vi), delta=delta.reshape(-1)[i], **kw)
        np.testing.assert_array_equal(tw.numpy().reshape(G, -1)[i], rw.numpy())
        np.testing.assert_array_equal(tv.numpy().reshape(G, -1)[i], rv.numpy())


def test_grouped_delta_refusals():
    w = torch.zeros(3, 5, 7, 9)
    kw = dict(lam_eff=0.1, lr=0.01, mu=0.9)
    for bad in (torch.ones(4), torch.ones(3, 5, dtype=torch.float64),
                torch.ones(5, 3).t(), torch.ones(0)):
        with pytest.raises(ValueError, match="delta"):
            symog_update(w, w.clone(), w.clone(), delta=bad, **kw)
    symog_update(w, w.clone(), w.clone(), delta=torch.ones(15), **kw)  # 15 divides 945


# ---------------------------------------------------------------------------
# moe_apply: the deterministic backward against jax.grad
# ---------------------------------------------------------------------------
def test_moe_backward_with_drops_matches_jax():
    """Capacity factor 0.5 drops assignments; the port's gathers through the
    slot bijection give JAX's grads, and the same bits twice."""
    D, E, F, k = 16, 8, 12, 2
    jcfg = jmoe.MoEConfig(d_model=D, n_experts=E, top_k=k, d_ff_expert=F, n_shared_experts=1,
                          capacity_factor=0.5)
    tcfg = tmoe.MoEConfig(d_model=D, n_experts=E, top_k=k, d_ff_expert=F, n_shared_experts=1,
                          capacity_factor=0.5)
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    ct = rng.standard_normal((2, 9, D)).astype(np.float32)

    def j_obj(p, x):
        y, aux = jmoe.moe_apply(p, x, cfg=jcfg, compute_dtype=jnp.float32)
        return jnp.sum(y * ct) + aux["moe_aux_loss"] + 0.1 * aux["moe_z_loss"], y

    (jl, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(j_obj, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))

    def port():
        tp = params_from_numpy(npp)
        leaves = [t for _, t in t_flatten(tp)]
        for t in leaves:
            t.requires_grad_(True)
        tx = torch.from_numpy(x).requires_grad_(True)
        y, aux = tmoe.moe_apply(tp, tx, cfg=tcfg, compute_dtype=torch.float32)
        loss = (y * torch.from_numpy(ct)).sum() + aux["moe_aux_loss"] + 0.1 * aux["moe_z_loss"]
        grads = torch.autograd.grad(loss, leaves + [tx])
        return loss, y, dict(zip([p for p, _ in t_flatten(tp)], grads[:-1])), grads[-1]

    tl, ty, tgp, tgx = port()
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(tgx), np.asarray(jgx), rtol=1e-5, atol=1e-6)
    jg = dict(j_flatten(jgp))
    assert set(tgp) == set(jg)
    for path, g in tgp.items():
        np.testing.assert_allclose(_np(g), np.asarray(jg[path]), rtol=1e-5, atol=1e-6,
                                   err_msg=path)
    # the buffer holds fewer slots than assignments: some were dropped
    C = max(1, int(np.ceil(0.5 * 18 * k / E)))
    assert C * E < 18 * k
    _, _, tgp2, tgx2 = port()
    for path in tgp:
        assert torch.equal(tgp[path], tgp2[path]), path
    assert torch.equal(tgx, tgx2)


# ---------------------------------------------------------------------------
# the MoE / MTP training loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jp, tparams, batches = _setup(arch)
    tok = batches[0]["tokens"]
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t: j_loss(p, {"tokens": t}, jcfg, compute_dtype=jnp.float32), has_aux=True))(
        jp, jnp.asarray(tok))
    tp = tparams()
    paths = [p for p, _ in t_flatten(tp)]
    leaves = [t.requires_grad_(True) for _, t in t_flatten(tp)]
    tl, tm = lm_train_loss(tp, {"tokens": torch.from_numpy(tok)}, tcfg,
                           compute_dtype=torch.float32)
    assert set(tm) == set(jm) == LOSS_KEYS[arch]
    for key in jm:
        np.testing.assert_allclose(_np(tm[key]), np.asarray(jm[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    grads = dict(zip(paths, torch.autograd.grad(tl, leaves)))
    jgrads = dict(j_flatten(jg))
    assert set(grads) == set(jgrads)
    for path, g in grads.items():
        np.testing.assert_allclose(_np(g), np.asarray(jgrads[path]), rtol=1e-4, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    _, tcfg, _, tparams, batches = _setup(arch)
    tok = torch.from_numpy(batches[1]["tokens"])
    out = []
    for remat in (False, True):
        tp = tparams()
        leaves = [t.requires_grad_(True) for _, t in t_flatten(tp)]
        loss, m = lm_train_loss(tp, {"tokens": tok}, dataclasses.replace(tcfg, remat=remat),
                                compute_dtype=torch.float32)
        out.append((loss, m, torch.autograd.grad(loss, leaves)))
    (l0, m0, g0), (l1, m1, g1) = out
    assert torch.equal(l0, l1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# make_train_step against JAX's jitted step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """Metrics per step, params and momentum after 3 JAX steps."""
    jcfg, _, jp, _, batches = _setup(arch)
    tx = joptim.sgd(momentum=0.9)
    scfg = jcore.SymogConfig(n_bits=2, total_steps=3)
    step = jax.jit(j_make_step(jcfg, tx, jcore.linear_lr(0.01, 0.001, 3), symog_cfg=scfg,
                               compute_dtype=jnp.float32))
    st = j_init_state(jp, tx, scfg)
    metrics = []
    for b in batches:
        st, m = step(st, {"tokens": jnp.asarray(b["tokens"])})
        metrics.append({k: float(v) for k, v in m.items()})
    f = dict(j_flatten(st.symog.f))
    return metrics, dict(j_flatten(st.params)), dict(j_flatten(st.opt_state)), f


@pytest.mark.parametrize("route", ["composed", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, route):
    j_metrics, j_params, j_mom, j_f = _jax_run(arch)
    _, tcfg, _, tparams, batches = _setup(arch)
    tx = toptim.sgd(momentum=0.9)
    scfg = tcore.SymogConfig(n_bits=2, total_steps=3)
    dispatch.set_update_backend(route)
    try:
        step = make_train_step(tcfg, tx, tcore.linear_lr(0.01, 0.001, 3), symog_cfg=scfg,
                               compute_dtype=torch.float32)
    finally:
        dispatch.set_update_backend("auto")
    st = init_train_state(tparams(), tx, scfg)
    f = dict(t_flatten(st.symog.f))
    experts = [p for p in f if "experts/" in p]
    assert experts and all(f[p].ndim >= 1 for p in experts)  # one f per (layer, expert)
    for path, fv in f.items():
        np.testing.assert_array_equal(_np(fv), np.asarray(j_f[path]), err_msg=path)
    for b, jm in zip(batches, j_metrics):
        st, m = step(st, b)
        assert set(m) == set(jm) == LOSS_KEYS[arch] | {"grad_norm", "lr", "symog_lambda"}
        for key in LOSS_KEYS[arch] | {"grad_norm"}:
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-5, err_msg=key)
    for path, leaf in t_flatten(st.params):
        np.testing.assert_allclose(_np(leaf), np.asarray(j_params[path]), **STEP_TOL,
                                   err_msg=path)
    for path, leaf in t_flatten(st.opt_state):
        # momentum is a sum of grads: STEP_TOL at the leaf's own scale (an
        # embedding row's grad sums O(1) terms of its token's positions, which
        # cancel down to O(0.01) in places; their fp32 noise stays O(1e-6))
        want = np.asarray(j_mom[path])
        np.testing.assert_allclose(_np(leaf), want, rtol=STEP_TOL["rtol"],
                                   atol=STEP_TOL["atol"] * max(1.0, np.abs(want).max()),
                                   err_msg=path)
    assert st.step == 3
