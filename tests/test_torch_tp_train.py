"""Port parity, tensor-parallel and FSDP SYMOG training on ``torch.distributed``
(gloo ranks on the CPU, reduced configs, fp32):

  * reduced internlm2 (``dp_tp``) at (1, 2) and (2, 2), fused and composed
    updates, 2 steps of the paper's clipped optimizer: the ranks' params
    and momentum, joined, within 1e-5 of JAX's jitted unsharded step on the
    bridged init and of the port's 1-rank step; replicas bit-identical
    across ranks; loss, ``grad_norm`` and ``clip_scale`` equal on every
    rank; f equal to JAX's ``symog_init`` of the whole leaves; λ large
    enough that λ_eff from a shard's count would miss the bar;
  * the vocab-parallel cross entropy against the gathered form;
  * reduced olmoe at ``moe_impl='ep'`` (1, 2) and reduced gemma2 under
    ``fsdp_tp`` at (2, 1) and (2, 2), remat on, against JAX's jitted
    unsharded step and the 1-rank step;
  * a checkpoint written from (1, 2) byte-equal to a 1-rank save, and
    restored onto (2, 2) as each rank's pieces;
  * the training launcher at ``--mesh 1x2`` giving the 1x1 losses.

Each world's ranks are spawned once (a module fixture); JAX runs here only.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.nn.tree import flatten_with_paths as j_flatten  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.models.lm import cross_entropy  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths  # noqa: E402
from repro_torch.train import fused_update, init_train_state, make_train_step  # noqa: E402
from torch_dist_ranks import run_ranks, tp_train_jobs  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
AXES = ("data", "model")
# large enough that λ_eff = λ·2/M_l from a shard's count (m times too large)
# moves the params past TOL (test_lambda_eff_from_a_shard_would_fail)
LAM = 1000.0
ROUTES = ("fused", "composed")
LAUNCH = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--steps", "3",
          "--batch", "4", "--seq", "16", "--symog", "--log-every", "1"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tx(mod):
    return mod.chain(mod.clip_by_global_norm(1.0), mod.sgd(momentum=0.9, nesterov=True))


def _batches(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)}
            for _ in range(2)]


_SETUP = {}


def _setup():
    """The jobs' configs, bridged whole params (internlm2 from JAX's init,
    olmoe / gemma2 from the port's seeded one) and batches."""
    if not _SETUP:
        jcfg = jconfigs.get_reduced("internlm2-1.8b")
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        olmoe = dataclasses.replace(tconfigs.get_reduced("olmoe-1b-7b"), moe_impl="ep",
                                    remat=True)
        gemma = dataclasses.replace(tconfigs.get_reduced("gemma2-27b"),
                                    sharding_profile="fsdp_tp")

        def port_np(cfg):
            return jax.tree_util.tree_map(lambda t: t.numpy(), init_lm(0, cfg, device="cpu"))

        _SETUP.update(
            internlm2=(tconfigs.get_reduced("internlm2-1.8b"), jax.tree_util.tree_map(
                np.asarray, jp), _batches(jcfg)),
            olmoe=(olmoe, port_np(olmoe), _batches(olmoe, 1)),
            gemma2=(gemma, port_np(gemma), _batches(gemma, 2)),
            gemma2_remat=(dataclasses.replace(gemma, remat=True), port_np(gemma),
                          _batches(gemma, 2)),
            jp=jp, jcfg=jcfg)
    return _SETUP


def _job(name, key, mesh, **kw):
    cfg, params, batches = _setup()[key]
    return dict(name=name, cfg=cfg, params=params, batches=batches, mesh=mesh, lam=LAM,
                routes=ROUTES, **kw)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp2")
    rng = np.random.default_rng(5)
    ce = {"logits": (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32),
          "labels": rng.integers(0, 64, (2, 5)),
          "mask": (rng.random((2, 5)) > 0.3).astype(np.float32)}
    jobs = [_job("internlm2_1x2", "internlm2", (1, 2), ckpt=str(tmp / "ckpt12")),
            _job("olmoe_ep_1x2", "olmoe", (1, 2)),
            _job("gemma2_2x1", "gemma2", (2, 1))]
    olmoe, olmoe_params, olmoe_batches = _setup()["olmoe"]
    remat = {"cfg": olmoe, "params": olmoe_params, "tokens": olmoe_batches[0]["tokens"]}
    ranks = run_ranks(tp_train_jobs, 2, {"jobs": jobs, "ce": ce, "remat": remat,
                                         "launch": LAUNCH + ["--mesh", "1x2"]})
    return ranks, ce, tmp


@pytest.fixture(scope="module")
def world4(world2):
    _, _, tmp = world2
    cfg, params, _ = _setup()["internlm2"]
    jobs = [_job("internlm2_2x2", "internlm2", (2, 2)),
            _job("gemma2_2x2", "gemma2_remat", (2, 2))]
    restore = {"cfg": cfg, "params": params, "mesh": (2, 2), "ckpt": str(tmp / "ckpt12")}
    return run_ranks(tp_train_jobs, 4, {"jobs": jobs, "restore": restore})


_ONE = {}


def _one_rank(key, route):
    """The port's 1-rank step from the same whole state: (metrics, state)."""
    if (key, route) not in _ONE:
        cfg, params, batches = _setup()[key]
        dispatch.set_update_backend(route)
        try:
            scfg = tcore.SymogConfig(n_bits=2, total_steps=10, lambda0=LAM)
            st = init_train_state(params_from_numpy(params), _tx(toptim), scfg)
            step = make_train_step(cfg, _tx(toptim), lambda s: 0.01, symog_cfg=scfg,
                                   compute_dtype=torch.float32)
            ms = []
            for b in batches:
                st, m = step(st, b)
                ms.append({k: float(v) for k, v in m.items()})
        finally:
            dispatch.set_update_backend("auto")
        _ONE[(key, route)] = (ms, st)
    return _ONE[(key, route)]


_JAX = {}
_ARCH = {"internlm2": "internlm2-1.8b", "olmoe": "olmoe-1b-7b", "gemma2": "gemma2-27b"}


def _jax_run(key="internlm2"):
    """JAX's jitted unsharded step on the job's whole params and batches, 2
    steps: metrics, params, momentum, f."""
    if key not in _JAX:
        s = _setup()
        _, params, batches = s[key]
        jcfg = jconfigs.get_reduced(_ARCH[key])
        jp = s["jp"] if key == "internlm2" else jax.tree_util.tree_map(jnp.asarray, params)
        scfg = jcore.SymogConfig(n_bits=2, total_steps=10, lambda0=LAM)
        step = jax.jit(j_make_step(jcfg, _tx(joptim), lambda i: 0.01, symog_cfg=scfg,
                                   compute_dtype=jnp.float32))
        st = j_init_state(jp, _tx(joptim), scfg)
        f0 = dict(j_flatten(st.symog.f))
        ms = []
        for b in batches:
            st, m = step(st, {"tokens": jnp.asarray(b["tokens"])})
            ms.append({k: float(v) for k, v in m.items()})
        _JAX[key] = dict(metrics=ms, params=dict(j_flatten(st.params)),
                         momentum=dict(j_flatten(st.opt_state[1])), f=f0)
    return _JAX[key]


def _check_vs_jax(key, metrics, params, mom):
    jx = _jax_run(key)
    for m, jm in zip(metrics, jx["metrics"]):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, err_msg=k)
    for path, w in params.items():
        _close(w, jx["params"][path], f"{path} vs JAX")
        _close(mom[path], jx["momentum"][path], f"momentum {path} vs JAX")


def _join(ranks, key, what, specs="specs"):
    """{path: whole tensor} of ``what`` from every rank's pieces (placed by
    the rank's spec and mesh coordinates); every copy of a replicated part
    must equal the first bit for bit."""
    res = [r[key] for r in ranks]
    mesh = {a: 1 + max(r["coords"][a] for r in res) for a in AXES}
    out = {}
    for path, leaf0 in flatten_with_paths(res[0][what]):
        spec = res[0][specs].get(path, ())
        n = [1 if e is None else int(np.prod([mesh[a] for a in ((e,) if isinstance(e, str)
                                                                 else e)])) for e in spec]
        shape = [leaf0.shape[d] * (n[d] if d < len(n) else 1) for d in range(leaf0.ndim)]
        whole = torch.zeros(shape, dtype=leaf0.dtype)
        seen = torch.zeros(shape, dtype=torch.bool)
        for r in res:
            leaf = dict(flatten_with_paths(r[what]))[path]
            idx = [slice(None)] * leaf.ndim
            for d, e in enumerate(spec):
                if e is not None:
                    i = 0
                    for a in ((e,) if isinstance(e, str) else e):
                        i = i * mesh[a] + r["coords"][a]
                    idx[d] = slice(i * leaf.shape[d], (i + 1) * leaf.shape[d])
            idx = tuple(idx)
            if bool(seen[idx].any()):
                assert torch.equal(whole[idx], leaf), f"{path}: replicas differ"
            else:
                whole[idx], seen[idx] = leaf, True
        assert bool(seen.all()), path
        out[path] = whole
    return out


def _close(got, want, msg, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol, err_msg=msg)


def _check_equal_metrics(ranks, key):
    ms = [r[key]["metrics"] for r in ranks]
    for m in ms[1:]:
        assert m == ms[0]  # loss, grad_norm, clip_scale: the same bits on every rank
    assert {"loss", "ce", "grad_norm", "clip_scale"} <= set(ms[0][0])
    return ms[0]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("route", ROUTES)
def test_tp_step_matches_jax_and_one_rank(world2, world4, mesh, route):
    ranks = world2[0] if mesh == "1x2" else world4
    key = (f"internlm2_{mesh}", route)
    metrics = _check_equal_metrics(ranks, key)
    ms1, st1 = _one_rank("internlm2", route)
    for m, m1 in zip(metrics, ms1):
        for k in ("loss", "ce", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(m[k], m1[k], rtol=1e-5)
    params, mom = _join(ranks, key, "params"), _join(ranks, key, "momentum")
    _check_vs_jax("internlm2", metrics, params, mom)
    one_p, one_m = dict(flatten_with_paths(st1.params)), dict(flatten_with_paths(st1.opt_state[1]))
    for path, w in params.items():
        _close(w, one_p[path], f"{path} vs 1 rank")
        _close(mom[path], one_m[path], f"momentum {path} vs 1 rank")
    plan = ranks[0][key]["plan"]
    assert plan["attn"] and plan["mlp"] and plan["embed"] and plan["head"]
    split = [p for p, s in ranks[0][key]["specs"].items() if s]
    assert len(split) >= 8  # q/k/v/o, gate/up/down, the tied embedding


def test_symog_f_is_jax_whole_leaf_f(world2, world4):
    want = _jax_run()["f"]
    for ranks, key in ((world2[0], ("internlm2_1x2", "fused")),
                       (world4, ("internlm2_2x2", "composed"))):
        got = _join(ranks, key, "f", specs="f_specs")
        assert set(got) == set(want)
        for path, f in got.items():
            np.testing.assert_array_equal(f.numpy(), np.asarray(want[path]), err_msg=path)


def _fused_steps(key, shards):
    """The 1-rank fused steps with the M_l and norm sums of ``shards``."""
    from repro_torch.models.lm import lm_train_loss
    from repro_torch.train.trainer import _loss_and_grads

    cfg, params, batches = _setup()[key]
    scfg = tcore.SymogConfig(n_bits=2, total_steps=10, lambda0=LAM)
    tx = _tx(toptim)
    st = init_train_state(params_from_numpy(params), tx, scfg)
    for i, b in enumerate(batches):
        _, _, grads = _loss_and_grads(
            lambda p, bb: lm_train_loss(p, bb, cfg, compute_dtype=torch.float32),
            st.params, {"tokens": torch.as_tensor(b["tokens"])})
        fused_update(st.params, grads, st.opt_state, st.symog, scfg, tx, lr=0.01,
                     lam=tcore.lambda_at(scfg, i), shards=shards)
    return dict(flatten_with_paths(st.params))


class _Counts:
    """M_l of each leaf's whole shape divided by ``cut[path]``."""

    def __init__(self, params, cut):
        self.shapes = {p: v.shape for p, v in flatten_with_paths(params)}
        self.cut = cut

    def numel(self, path):
        return int(np.prod(self.shapes[path])) // self.cut.get(path, 1)

    def sum_over_shards(self, parts):
        return sum(parts.values())


def _misses(got, want):
    """How far past TOL the worst element of ``got`` lies from ``want``."""
    return max(float(np.max(np.abs(got[p].numpy() - w.numpy())
                            - TOL["rtol"] * np.abs(w.numpy()))) for p, w in want.items())


def test_lambda_eff_from_a_shard_would_fail(world2):
    """The bar is tight enough: the 1-rank fused steps with the whole
    leaves' M_l land within TOL of the TP ranks' params, and with the count
    of one of a split leaf's two shards (λ_eff twice too large) past it."""
    ranks, _, _ = world2
    key = ("internlm2_1x2", "fused")
    got = _join(ranks, key, "params")
    params = _setup()["internlm2"][1]
    split = {p: 2 for p, s in ranks[0][key]["specs"].items() if s}
    assert _misses(got, _fused_steps("internlm2", _Counts(params, {}))) <= TOL["atol"]
    assert _misses(got, _fused_steps("internlm2", _Counts(params, split))) > TOL["atol"]


@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_cross_entropy_matches_gathered(world2, masked):
    ranks, ce, _ = world2
    z = torch.from_numpy(ce["logits"]).requires_grad_(True)
    labels, mask = torch.from_numpy(ce["labels"]), torch.from_numpy(ce["mask"])
    want = cross_entropy(z, labels, mask if masked else None)
    want.backward()
    v = z.shape[-1] // 2
    for r in ranks:
        got = r["ce"]
        i = got["index"]
        loss, grad = got[("parallel", masked)]
        np.testing.assert_allclose(loss, float(want.detach()), rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(), z.grad[..., i * v:(i + 1) * v].numpy(),
                                   rtol=1e-5, atol=1e-7)
        gl, gg = got[("gathered", masked)]
        assert gl == float(want.detach())  # the same ops on the same whole row
        assert torch.equal(gg, z.grad[..., i * v:(i + 1) * v])  # AllGather's backward


@pytest.mark.parametrize("where", ["this_thread", "other_thread"])
def test_remat_recompute_reenters_plan_and_mesh(world2, where):
    """olmoe under EP with remat: the backward run outside the forward's plan
    and mesh (on the card it runs on the autograd engine's device thread)
    gives the grads of the backward run inside them, bit for bit."""
    for r in world2[0]:
        got, want = r["remat"][where], r["remat"]["inside"]
        assert not isinstance(got, str), got
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("route", ROUTES)
def test_expert_parallel_step_matches_one_rank(world2, route):
    ranks, _, _ = world2
    key = ("olmoe_ep_1x2", route)
    metrics = _check_equal_metrics(ranks, key)
    assert ranks[0][key]["plan"]["ep"] and ranks[0][key]["plan"]["attn"]
    ms1, st1 = _one_rank("olmoe", route)
    for m, m1 in zip(metrics, ms1):
        for k in ("loss", "ce", "moe_aux_loss", "moe_z_loss", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(m[k], m1[k], rtol=1e-5, err_msg=k)
    params, mom = _join(ranks, key, "params"), _join(ranks, key, "momentum")
    _check_vs_jax("olmoe", metrics, params, mom)
    f = _join(ranks, key, "f", specs="f_specs")
    for path, w in flatten_with_paths(st1.params):
        _close(params[path], w, path)
        _close(mom[path], dict(flatten_with_paths(st1.opt_state[1]))[path], f"momentum {path}")
    for path, want in flatten_with_paths(st1.symog.f):
        assert torch.equal(f[path], want), path
    experts = [p for p, s in ranks[0][key]["f_specs"].items() if s]
    assert len(experts) == 3  # each expert stack's f split with its experts


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
@pytest.mark.parametrize("route", ROUTES)
def test_fsdp_step_matches_one_rank(world2, world4, mesh, route):
    ranks = world2[0] if mesh == "2x1" else world4
    key = (f"gemma2_{mesh}", route)
    metrics = _check_equal_metrics(ranks, key)
    ms1, st1 = _one_rank("gemma2", route)
    for m, m1 in zip(metrics, ms1):
        for k in ("loss", "ce", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(m[k], m1[k], rtol=1e-5, err_msg=k)
    params, mom = _join(ranks, key, "params"), _join(ranks, key, "momentum")
    _check_vs_jax("gemma2", metrics, params, mom)
    one_m = dict(flatten_with_paths(st1.opt_state[1]))
    for path, w in flatten_with_paths(st1.params):
        _close(params[path], w, path)
        _close(mom[path], one_m[path], f"momentum {path}")
    fsdp = ranks[0][key]["fsdp"]
    assert "embed/embedding" in fsdp and len(fsdp) >= 8  # the embed dims over 'data'
    assert ranks[0][key]["plan"]["attn"] == (mesh == "2x2")


def test_checkpoint_from_tp_ranks_equals_one_rank_save(world2):
    _, _, tmp = world2
    cfg, params, _ = _setup()["internlm2"]
    one = str(tmp / "one")
    state = init_train_state(params_from_numpy(params), _tx(toptim),
                             tcore.SymogConfig(n_bits=2, total_steps=10, lambda0=LAM))
    CheckpointManager(one).save(0, state, blocking=True)
    a, b = os.path.join(str(tmp / "ckpt12_init"), "ckpt_0"), os.path.join(one, "ckpt_0")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_checkpoint_restores_onto_2x2(world2, world4):
    ranks2, _, tmp = world2
    stepped = _join(ranks2, ("internlm2_1x2", "fused"), "params")
    got = _join([{"r": r["restore"]} for r in world4], "r", "params")
    mom = _join([{"r": r["restore"]} for r in world4], "r", "momentum")
    assert {r["restore"]["step"] for r in world4} == {2}
    assert any(len(s) for s in world4[0]["restore"]["specs"].values())
    for path, w in stepped.items():
        assert torch.equal(got[path], w), path
    want_m = _join(ranks2, ("internlm2_1x2", "fused"), "momentum")
    for path, v in want_m.items():
        assert torch.equal(mom[path], v), path


def test_launcher_mesh_1x2_gives_the_1x1_losses(world2, capsys):
    ranks, _, _ = world2
    one = tlaunch.main(list(LAUNCH))
    quant = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("final rel quant error")]
    # the metric summed over the shards, a replicated leaf once
    assert len(quant) == 1 and quant[0] in ranks[0]["launch"]["text"].splitlines()
    for r in ranks:
        np.testing.assert_allclose(r["launch"]["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["launch"]["clip_scales"], one["clip_scales"], rtol=1e-5)
    assert ranks[0]["launch"]["losses"] == ranks[1]["launch"]["losses"]
    assert "ranks' losses equal: True" in ranks[0]["launch"]["text"]
