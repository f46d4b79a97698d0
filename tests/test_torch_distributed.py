"""Port parity, distribution on ``torch.distributed`` (gloo ranks on the CPU):

  * ``moe_apply_ep`` on a (2, 2) mesh, x split over 'data', 1-D EP (experts
    over 'model') and 2-D (over ('data', 'model')): within 2e-4 of JAX's
    ``moe_apply_dense_ref`` on tests/test_moe_ep.py's config and inputs;
    the grads of sum(y²) finite, nonzero and equal to the port's
    ``moe_apply``'s (the all-to-all's backward is the reverse all-to-all);
  * ``compressed_psum_int8`` over a gloo group: JAX's bounds (one round
    < 0.05, accumulated < 0.02), and its arithmetic against JAX's run
    under ``jax.vmap(axis_name="data")``;
  * a 2-rank data-parallel step (fused and composed updates) equal to a
    1-rank step on the whole batch;
  * a checkpoint saved from 2 ranks byte-equal to a 1-rank save, and
    restored onto a (1, 2) mesh as each rank's slices.

Each world's ranks are spawned once (a module fixture); JAX runs here only.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import CompressionState as JState  # noqa: E402
from repro.distributed import compressed_psum_int8 as j_compressed  # noqa: E402
from repro.models.moe import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.moe import moe_apply_dense_ref as j_dense_ref  # noqa: E402
from repro.models.moe import moe_init as j_moe_init  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.models.moe import MoEConfig, moe_apply  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from torch_dist_ranks import dp_jobs, ep_jobs, run_ranks  # noqa: E402

MOE = dict(d_model=16, n_experts=8, top_k=2, d_ff_expert=8, n_shared_experts=1,
           capacity_factor=8.0)
ROUNDS = 20


@pytest.fixture(scope="module")
def ep():
    key = jax.random.PRNGKey(0)
    jcfg = JMoEConfig(**MOE)
    jp = j_moe_init(key, jcfg)
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (4, 6, 16)) * 0.5)
    want = np.asarray(j_dense_ref(jp, jnp.asarray(x), cfg=jcfg))
    params = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    ranks = run_ranks(ep_jobs, 4, {"x": x, "params": params, "cfg": MoEConfig(**MOE)})
    # the port's capacity dispatch on the whole batch: the grads' reference
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    pt = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), params)
    y, _ = moe_apply(pt, xt, cfg=MoEConfig(**MOE), compute_dtype=torch.float32)
    torch.sum(y ** 2).backward()
    grads = {"x": xt.grad, "router": pt["router"]["kernel"].grad}
    for k in ("experts", "shared"):
        for kk, v in pt[k].items():
            grads[f"{k}/{kk}"] = v["kernel"].grad
    return want, grads, ranks


def _by_data_row(ranks, mode, what):
    """Rows of the model-index-0 ranks, in data order (the copies checked equal)."""
    rows = {}
    for r in ranks:
        d, m = r["coords"]["data"], r["coords"]["model"]
        rows.setdefault(d, {})[m] = r[mode][what] if what == "y" else r[mode]["grads"]
    return [rows[d] for d in sorted(rows)]


@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_moe_apply_ep_matches_dense_ref(ep, mode):
    want, _, ranks = ep
    rows = _by_data_row(ranks, mode, "y")
    for copies in rows:
        assert torch.equal(copies[0], copies[1])  # the model axis holds copies
    y = torch.cat([copies[0] for copies in rows]).numpy()
    err = float(np.max(np.abs(y - want)))
    assert err < 2e-4, err
    assert all(np.isfinite(v) for r in ranks for v in r[mode]["aux"].values())


@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_moe_apply_ep_grads_match_moe_apply(ep, mode):
    _, want, ranks = ep
    rows = _by_data_row(ranks, mode, "grads")
    gx = torch.cat([copies[0]["x"] for copies in rows])
    torch.testing.assert_close(gx, want["x"], rtol=1e-5, atol=1e-6)
    for copies in rows:  # copies' summed partials: equal on both
        torch.testing.assert_close(copies[0]["x"], copies[1]["x"], rtol=0, atol=0)
    # each expert lives on one rank of a data row (1-D) or of the mesh (2-D):
    # the grads summed over every rank are the whole batch's
    for name in ("experts/gate_proj", "experts/up_proj", "experts/down_proj"):
        got = sum(r[mode]["grads"][name] for r in ranks)
        torch.testing.assert_close(got, want[name], rtol=1e-5, atol=1e-6)
    # the router and the (whole) shared experts: one copy per data row
    for name in ("router", "shared/gate_proj", "shared/up_proj", "shared/down_proj"):
        got = sum(copies[0][name] for copies in rows)
        torch.testing.assert_close(got, want[name], rtol=1e-5, atol=1e-6)
        assert torch.isfinite(got).all() and got.abs().sum() > 0


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cfg = tconfigs.get_reduced("internlm2-1.8b")
    rng = np.random.default_rng(0)
    grads = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 1, 64)) * 0.1)
    payload = {"cfg": cfg, "batch": {"tokens": rng.integers(0, cfg.vocab_size, (4, 17))},
               "ckpt_init": str(tmp / "init2"), "ckpt_step": str(tmp / "step2"),
               "grads": grads, "rounds": ROUNDS}
    ranks = run_ranks(dp_jobs, 2, payload)
    return payload, ranks, tmp


def _one_rank_step(cfg, batch, route, ckpt=None):
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    scfg = tcore.SymogConfig(n_bits=2, total_steps=10)
    dispatch.set_update_backend(route)
    try:
        state = init_train_state(init_lm(0, cfg, device="cpu"), tx, scfg)
        if ckpt is not None:
            CheckpointManager(ckpt).save(0, state, blocking=True)
        step = make_train_step(cfg, tx, lambda s: 0.01, symog_cfg=scfg,
                               compute_dtype=torch.float32)
        return step(state, batch)
    finally:
        dispatch.set_update_backend("auto")


@pytest.mark.parametrize("route", ["fused", "composed"])
def test_data_parallel_step_equals_full_batch(dp, route):
    payload, ranks, _ = dp
    state, metrics = _one_rank_step(payload["cfg"], payload["batch"], route)
    for r in ranks:
        got = r[route]
        assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-6)
        assert got["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-5)
        for (path, a), (_, b) in zip(flatten_with_paths(got["params"]),
                                     flatten_with_paths(state.params), strict=True):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=path)
    # the ranks' replicas stay bit-identical
    for (_, a), (_, b) in zip(flatten_with_paths(ranks[0][route]["params"]),
                              flatten_with_paths(ranks[1][route]["params"])):
        assert torch.equal(a, b)


def test_checkpoint_from_two_ranks_equals_one_rank_save(dp):
    payload, ranks, tmp = dp
    one = str(tmp / "init1")
    _one_rank_step(payload["cfg"], payload["batch"], "fused", ckpt=one)
    a, b = os.path.join(payload["ckpt_init"], "ckpt_0"), os.path.join(one, "ckpt_0")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    # the stepped state: written once, by rank 0, the full logical arrays
    assert CheckpointManager(payload["ckpt_step"]).steps() == [1]


def test_checkpoint_restores_onto_mesh(dp):
    payload, ranks, _ = dp
    full = dict(flatten_with_paths(ranks[0]["fused"]["params"]))
    split = 0
    for r in ranks:
        got = r["restored"]
        assert got["step"] == 1
        for path, leaf in flatten_with_paths(got["params"]):
            whole = full[path]
            dims = [d for d in range(whole.ndim) if leaf.shape[d] != whole.shape[d]]
            for d in dims:  # this rank's slice of each split dimension
                n = whole.shape[d] // leaf.shape[d]
                assert n == 2
                whole = whole.narrow(d, got["index"] * leaf.shape[d], leaf.shape[d])
            split += bool(dims)
            assert torch.equal(leaf, whole), path
    assert split  # the dp_tp rules split heads / mlp / vocab over 'model'


def test_compressed_psum_int8_bounds(dp):
    payload, ranks, _ = dp
    grads = payload["grads"]
    exact = grads.mean(0)
    acc_c, acc_x = np.zeros_like(exact), np.zeros_like(exact)
    for mean, _ in ranks[0]["compressed"]:
        out = mean.numpy()
        acc_c, acc_x = acc_c + out, acc_x + exact
        one_round = float(np.abs(out - exact).max() / np.abs(exact).max())
        assert one_round < 0.05, one_round  # int8: ~1/127 relative per round
    accum_rel = float(np.abs(acc_c - acc_x).max() / np.abs(acc_x).max())
    assert accum_rel < 0.02, accum_rel  # error feedback bounds the accumulated bias
    for (m0, _), (m1, _) in zip(ranks[0]["compressed"], ranks[1]["compressed"]):
        assert torch.equal(m0, m1)


def test_compressed_psum_int8_matches_jax_vmap(dp):
    payload, ranks, _ = dp
    g = jnp.asarray(payload["grads"])

    def once(gr, err):
        mean, st = j_compressed({"w": gr}, JState(err={"w": err}), "data")
        return mean["w"], st.err["w"]

    # op by op: under jit XLA fuses x' - q·s into one FMA, which rounds
    # once where the module's (and torch's) two operations round twice
    run = jax.vmap(once, axis_name="data")
    err = jnp.zeros_like(g)
    for i in range(ROUNDS):
        mean, err = run(g, err)
        for r, rank in enumerate(ranks):
            m, e = rank["compressed"][i]
            np.testing.assert_array_equal(m.numpy(), np.asarray(mean[r]))
            np.testing.assert_array_equal(e.numpy(), np.asarray(err[r]))
