"""Port parity, the tensor-parallel forms of mamba2, recurrentgemma, whisper
and paligemma on ``torch.distributed`` (gloo ranks on the CPU, reduced
configs, fp32, a (1, 2) mesh):

  * the plan's pieces: mamba2's SSD heads (B / C, the conv kernel and the
    gated norm's scale whole), recurrentgemma's RG-LRU heads and MLP (its
    single-KV-head attention whole), whisper's encoder, self- and
    cross-attention and MLP (column-parallel biases split, row-parallel ones
    whole), paligemma's MLP (MQA attention whole), every embedding and tied
    head vocab-parallel; at full width and reduced;
  * greedy ``serve()`` with per-request frames / patches TOKEN-IDENTICAL to
    JAX's serve and to the port's 1-rank serve; the static loop's final
    logits within 1e-5 of one rank's;
  * each rank's resident state, cross-kv and paged pool hold 1/m of the
    split parts (SSD / RG-LRU states and conv windows, whisper's cross-kv
    and self-attention pool);
  * 2 steps of the launcher's clipped chain, fused and composed: the joined
    params and momentum within 1e-5 of JAX's jitted unsharded step on the
    bridged init and of the port's 1-rank step, loss / ``grad_norm`` /
    ``clip_scale`` equal on both ranks;
  * the bar is tight enough: undoing either trap's repair (mamba2's gated
    norm without the sum of squares over the ranks, or with an identity
    backward; whisper's row-parallel biases added to every partial) misses
    it;
  * a checkpoint of mamba2's (1, 2) state byte-equal to a 1-rank save; the
    serve launcher at ``--mesh 1x2`` giving the 1x1 streams (whisper,
    recurrentgemma), the training launcher the 1x1 losses (mamba2,
    paligemma).

The ranks are spawned once (a module fixture); JAX runs here only.
"""
import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.nn.tree import flatten_with_paths as j_flatten  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.nn.sharding import AbstractMesh, make_rules  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths, tree_map_with_path  # noqa: E402
from repro_torch.serve.sharding import local_config, make_tp_plan, serve_spec_fn  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.train.sharding import param_shapes  # noqa: E402
from test_torch_tp_train import _close, _join  # noqa: E402
from torch_dist_ranks import _free_port, family_serve, family_tp_jobs, run_ranks  # noqa: E402

ARCHS = ("mamba2-2.7b", "recurrentgemma-2b", "whisper-large-v3", "paligemma-3b")
ROUTES = ("fused", "composed")
MAX_LEN = 32
LAM = 1000.0  # as tests/test_torch_tp_train.py: a shard's M_l would miss the bar
FAULTS = {"norm_identity_backward": "mamba2-2.7b", "norm_no_reduce": "mamba2-2.7b",
          "bias_before_reduce": "whisper-large-v3"}
REMAT = ("mamba2-2.7b", "whisper-large-v3")  # the SSD norm's collective; the encoder
LAUNCH_SERVE = {"whisper-large-v3": 0, "recurrentgemma-2b": 1}
LAUNCH_TRAIN = {"mamba2-2.7b": 2, "paligemma-3b": 3}


def _serve_argv(arch):
    return ["--arch", arch, "--reduced", "--device", "cpu", "--continuous", "--requests", "4",
            "--slots", "2", "--steps", "5", "--prompt-len", "6"]


def _train_argv(arch):
    return ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "16", "--symog", "--log-every", "1"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tx(mod):
    return mod.chain(mod.clip_by_global_norm(1.0), mod.sgd(momentum=0.9, nesterov=True))


def _extras(cfg, rng, rows):
    stub = {"encdec": ("frames", cfg.encoder_len), "vlm": ("patches", cfg.prefix_len)}
    if cfg.family not in stub:
        return {}
    name, n = stub[cfg.family]
    return {name: (rng.standard_normal((rows, n, cfg.d_model)) * 0.1).astype(np.float32)}


_SETUP = {}


def _setup(arch):
    """(cfg, the port's seeded float init as numpy, serve requests, a static
    batch, 2 training batches), once per arch."""
    if arch not in _SETUP:
        cfg = tconfigs.get_reduced(arch)
        rng = np.random.default_rng(3)
        # every bias drawn at scale 0.1 (the init zeroes them): a row-parallel
        # bias added to each rank's partial then moves the outputs
        npp = tree_map_with_path(
            lambda p, t: (rng.standard_normal(t.shape) * 0.1).astype(np.float32)
            if p.endswith("/bias") else t.numpy(), init_lm(0, cfg, device="cpu"))
        reqs = [(rng.integers(0, cfg.vocab_size, size=L).astype(np.int32), b,
                 _extras(cfg, rng, 1) or None) for L, b in zip((3, 6, 4, 7), (6, 3, 5, 2))]
        static = {"tokens": rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32),
                  **_extras(cfg, rng, 2)}
        batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32),
                    **_extras(cfg, rng, 4)} for _ in range(2)]
        _SETUP[arch] = (cfg, npp, reqs, static, batches)
    return _SETUP[arch]


def _max_len(cfg):
    return MAX_LEN + (cfg.prefix_len if cfg.family == "vlm" else 0)


def _serve_job(arch):
    cfg, npp, reqs, static, _ = _setup(arch)
    return dict(name=arch, cfg=cfg, params=params_from_numpy(npp), max_len=_max_len(cfg),
                requests=reqs, batch=static, steps=4)


def _packed_serve_job(bits=4):
    """mamba2's ``pack_tree`` artifact: its whole leaves (B / C, the conv
    kernel) ``Packed``; at 4 bits its ``in_proj_dt`` words split 2 heads a
    rank, at 2 bits its one word of 4 heads stays whole."""
    job = _serve_job("mamba2-2.7b")
    scfg = tcore.SymogConfig(n_bits=bits, total_steps=1)
    p = job["params"]
    return dict(job, name=f"mamba2-2.7b/packed{bits}",
                params=tcore.pack_tree(p, tcore.symog_init(p, scfg), scfg))


def _train_job(arch, **kw):
    cfg, npp, _, _, batches = _setup(arch)
    return dict(name=arch, cfg=cfg, params=npp, batches=batches, mesh=(1, 2), lam=LAM,
                routes=ROUTES, **kw)


def _remat_job(arch):
    """The loss's grads under remat on (1, 2), the backward inside and outside
    the forward's plan and mesh (``torch_dist_ranks._remat_backward_elsewhere``)."""
    cfg, npp, _, _, batches = _setup(arch)
    return {"cfg": dataclasses.replace(cfg, remat=True), "params": npp, "batch": batches[0]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("family_tp")
    faults = {name: (dict(_train_job(arch), routes=("fused",)), name)
              for name, arch in FAULTS.items()}
    launch = [("serve", _serve_argv(a) + ["--mesh", "1x2"]) for a in LAUNCH_SERVE]
    launch += [("train", _train_argv(a) + ["--mesh", "1x2"]) for a in LAUNCH_TRAIN]
    payload = {"serve": [_serve_job(a) for a in ARCHS] + [_packed_serve_job(),
                                                          _packed_serve_job(2)],
               "train": [_train_job(a, **({"ckpt": str(tmp / "mamba2")}
                                          if a == "mamba2-2.7b" else {})) for a in ARCHS],
               "faults": faults, "launch": launch, "remat": {a: _remat_job(a) for a in REMAT},
               "ports": [_free_port() for _ in launch]}
    return run_ranks(family_tp_jobs, 2, payload), tmp


_ONE = {}


def _one_rank_serve(arch):
    if arch not in _ONE:
        _ONE[arch] = family_serve(_serve_job(arch))
    return _ONE[arch]


_JAX = {}


def _jax_serve(arch):
    """JAX's serve of the same float tree and requests (each with its own
    frames / patches)."""
    if ("serve", arch) not in _JAX:
        cfg, npp, reqs, _, _ = _setup(arch)
        eng = JEngine(jconfigs.get_reduced(arch), jax.tree_util.tree_map(jnp.asarray, npp),
                      max_len=_max_len(cfg), compute_dtype=jnp.float32)
        comps = eng.serve([JRequest(tokens=t, max_new_tokens=b, extras=e) for t, b, e in reqs],
                          JServeConfig(n_slots=2, temperature=0.0))
        _JAX[("serve", arch)] = [list(map(int, c.tokens)) for c in comps]
    return _JAX[("serve", arch)]


def _jax_train(arch):
    """JAX's jitted unsharded step, 2 steps: metrics, params, momentum."""
    if ("train", arch) not in _JAX:
        _, npp, _, _, batches = _setup(arch)
        scfg = jcore.SymogConfig(n_bits=2, total_steps=10, lambda0=LAM)
        step = jax.jit(j_make_step(jconfigs.get_reduced(arch), _tx(joptim), lambda i: 0.01,
                                   symog_cfg=scfg, compute_dtype=jnp.float32))
        st = j_init_state(jax.tree_util.tree_map(jnp.asarray, npp), _tx(joptim), scfg)
        ms = []
        for b in batches:
            st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
            ms.append({k: float(v) for k, v in m.items()})
        _JAX[("train", arch)] = dict(metrics=ms, params=dict(j_flatten(st.params)),
                                     momentum=dict(j_flatten(st.opt_state[1])))
    return _JAX[("train", arch)]


def _one_rank_train(arch, route):
    key = ("train1", arch, route)
    if key not in _ONE:
        cfg, npp, _, _, batches = _setup(arch)
        dispatch.set_update_backend(route)
        try:
            scfg = tcore.SymogConfig(n_bits=2, total_steps=10, lambda0=LAM)
            st = init_train_state(params_from_numpy(npp), _tx(toptim), scfg)
            step = make_train_step(cfg, _tx(toptim), lambda s: 0.01, symog_cfg=scfg,
                                   compute_dtype=torch.float32)
            ms = []
            for b in batches:
                st, m = step(st, b)
                ms.append({k: float(v) for k, v in m.items()})
        finally:
            dispatch.set_update_backend("auto")
        _ONE[key] = (ms, dict(flatten_with_paths(st.params)),
                     dict(flatten_with_paths(st.opt_state[1])))
    return _ONE[key]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
class _Mesh(AbstractMesh):
    """A (1, 2) mesh's shape, seen from model rank 0, with no processes."""

    def group(self, axes):
        return None

    def axis_index(self, axes):
        return 0


PIECES = {"mamba2-2.7b": {"ssd", "embed", "head"},
          "recurrentgemma-2b": {"rglru", "mlp", "embed", "head"},
          "whisper-large-v3": {"attn", "mlp", "embed", "head"},
          "paligemma-3b": {"mlp", "embed", "head"}}


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_pieces(arch, reduced):
    cfg = tconfigs.get_reduced(arch) if reduced else tconfigs.get_config(arch)
    mesh = _Mesh((1, 2), ("data", "model"))
    rules = make_rules(mesh, cfg.sharding_profile)
    shapes = param_shapes(cfg)
    plan = make_tp_plan(cfg, {p: torch.empty(s, device="meta") for p, s in shapes.items()},
                        mesh, rules)
    on = {k for k in ("attn", "mlp", "embed", "head", "ssd", "rglru") if getattr(plan, k)}
    assert on == PIECES[arch]
    local = local_config(cfg, plan)
    spec = serve_spec_fn(cfg, plan, rules)
    specs = {p: spec(p, s, rules.pspec_for(p, s)) for p, s in shapes.items()}
    if arch == "mamba2-2.7b":
        assert plan.whole == {"ssd": frozenset({"in_proj_B/kernel", "in_proj_C/kernel",
                                                "conv1d/kernel", "norm/scale"})}
        assert (local.d_inner, local.ssm_heads) == (cfg.d_inner // 2, cfg.ssm_heads // 2)
        for name in ("in_proj_B/kernel", "conv1d/kernel", "norm/scale"):
            assert specs[f"layers0/sub0/ssd/{name}"] == ()
        for name, dim in (("in_proj_dt/kernel", 2), ("A_log", 1), ("out_proj/kernel", 1)):
            assert specs[f"layers0/sub0/ssd/{name}"][dim] == "model", name
    elif arch == "recurrentgemma-2b":
        assert (local.d_rnn, local.rnn_heads) == (cfg.d_rnn // 2, cfg.rnn_heads // 2)
        assert local.n_kv_heads == cfg.n_kv_heads == 1  # MQA: attention whole
        assert specs["units/sub0/rglru/conv1d/kernel"][-1] == "model"
        assert specs["units/sub0/rglru/rg_lru/input_gate/bias"][-2] == "model"
        assert specs["units/sub2/attn/q_proj/kernel"] == ()
    elif arch == "whisper-large-v3":
        assert (local.n_heads, local.n_kv_heads) == (cfg.n_heads // 2, cfg.n_kv_heads // 2)
        for sub in ("encoder/layers0/sub0/attn", "layers0/sub0/attn", "layers0/sub0/cross_attn"):
            assert specs[f"{sub}/q_proj/bias"] == (None, "model", None), sub  # with its heads
            assert specs[f"{sub}/o_proj/bias"] == (), sub  # added after the reduce
        assert specs["layers0/sub0/mlp/fc1/bias"] == (None, "model")
        assert specs["layers0/sub0/mlp/fc2/bias"] == ()
        assert specs["encoder/layers0/sub0/mlp/fc1/kernel"] == (None, None, "model")
        assert specs["embed/embedding"] == ("model", None)
    else:
        assert local.n_heads == cfg.n_heads and plan.whole == {}
        assert specs["layers0/sub0/mlp/gate_proj/kernel"][-1] == "model"


def test_packed_words_that_do_not_divide_keep_the_piece_whole():
    """Reduced mamba2's 2-bit ``in_proj_dt`` (4 heads: one 4-column word)
    cannot split over 2 ranks: that one leaf stays whole on every rank (as
    JAX's rules replicate it) and the rest of the SSD block still splits,
    each rank taking its heads' columns of dt; at 4 bits (2 columns a word)
    the leaf splits with its block."""
    cfg = tconfigs.get_reduced("mamba2-2.7b")
    p = init_lm(0, cfg, device="cpu")
    mesh = _Mesh((1, 2), ("data", "model"))
    rules = make_rules(mesh, cfg.sharding_profile)
    for bits, dt_whole in ((2, True), (4, False)):
        scfg = tcore.SymogConfig(n_bits=bits, total_steps=1)
        tree = tcore.pack_tree(p, tcore.symog_init(p, scfg), scfg)
        plan = make_tp_plan(cfg, tree, mesh, rules)
        assert plan.ssd and plan.embed, bits
        assert ("in_proj_dt/kernel" in plan.whole["ssd"]) == dt_whole, bits
        # the split SSD block runs on the rank's config: its state keeps half the heads
        assert local_config(cfg, plan).ssm_heads == cfg.ssm_heads // 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_matches_jax_and_one_rank(ranks, arch):
    one = _one_rank_serve(arch)
    assert one["tokens"] == _jax_serve(arch)
    for r in ranks[0]:
        got = r[("serve", arch)]
        assert got["tokens"] == one["tokens"]
        assert torch.equal(got["static"], one["static"])
        _close(got["logits"], one["logits"], f"{arch} final logits")
        assert {k for k, v in got["plan"].items() if v} == PIECES[arch]


def test_packed_whole_leaves_serve_split(ranks):
    """A packed artifact whose SSD piece splits (4 bits: 2 heads a word)
    serves with its whole ``Packed`` leaves on both ranks, token-identical
    to one rank's serve of it."""
    one = family_serve(_packed_serve_job())
    for r in ranks[0]:
        got = r[("serve", "mamba2-2.7b/packed4")]
        assert got["plan"]["ssd"] and got["tokens"] == one["tokens"]
        assert torch.equal(got["static"], one["static"])


def test_packed_in_proj_dt_whole_serves_split_and_steps(ranks):
    """The 2-bit artifact, whose ``in_proj_dt`` word (4 heads) does not split
    over 2 ranks, serves with that leaf whole and the rest of the SSD block
    split: token-identical to one rank's serve, the static loop's logits
    within 1e-5, each rank holding half the SSD state.  The 2-bit SYMOG
    training of the same model (laid out from its float shapes, where
    ``in_proj_dt`` splits) stays within 1e-5 of one rank at every leaf."""
    one = family_serve(_packed_serve_job(2))
    cfg = tconfigs.get_reduced("mamba2-2.7b")
    for r in ranks[0]:
        got = r[("serve", "mamba2-2.7b/packed2")]
        assert got["plan"]["ssd"] and "in_proj_dt/kernel" in got["whole"]["ssd"]
        assert got["local"]["ssm_heads"] == cfg.ssm_heads // 2
        assert got["tokens"] == one["tokens"]
        assert torch.equal(got["static"], one["static"])
        _close(got["logits"], one["logits"], "2-bit mamba2 final logits")
        res = r[("mamba2-2.7b", "fused")]
        assert "in_proj_dt/kernel" not in res["whole"]["ssd"]
    _, params, _ = _one_rank_train("mamba2-2.7b", "fused")
    joined = _join(ranks[0], ("mamba2-2.7b", "fused"), "params")
    for path, want in params.items():
        _close(joined[path], want, path)


def _split_dim(arch, name, shape):
    """The dim of a pool leaf the ranks split (None: whole on every rank)."""
    if arch == "mamba2-2.7b":
        return {"h": len(shape) - 3, "conv": len(shape) - 1}[name]
    if arch == "recurrentgemma-2b":
        return len(shape) - 1 if name in ("h", "conv") else None
    if arch == "whisper-large-v3":
        return len(shape) - 2  # cross k / v and the paged self-attention pool: K heads
    return None


@pytest.mark.parametrize("arch", ARCHS)
def test_resident_state_and_pools_per_rank(ranks, arch):
    cfg = tconfigs.get_reduced(arch)
    one = _one_rank_serve(arch)
    for r in ranks[0]:
        got = r[("serve", arch)]
        assert set(got["leaves"]) == set(one["leaves"])
        whole_bytes = split_bytes = 0
        for key, shape in one["leaves"].items():
            name = key.rsplit("/", 1)[1]
            d = _split_dim(arch, name, shape)
            want = list(shape)
            if d is not None:
                # mamba2's conv window: the rank's x channels, B and C whole
                shared = 2 * cfg.ssm_state if (arch, name) == ("mamba2-2.7b", "conv") else 0
                want[d] = (shape[d] - shared) // 2 + shared
                split_bytes += 1
            assert list(got["leaves"][key]) == want, key
            whole_bytes += 1
        assert split_bytes > 0 or arch == "paligemma-3b"
        if arch == "whisper-large-v3":
            assert got["paged_pool_bytes"] * 2 == one["paged_pool_bytes"]
            assert got["cache_bytes"] * 2 == one["cache_bytes"]
        elif arch == "paligemma-3b":
            assert got["cache_bytes"] == one["cache_bytes"]
        else:
            assert got["paged_pool_bytes"] == one["paged_pool_bytes"]
            assert got["cache_bytes"] < one["cache_bytes"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_jax_and_one_rank(ranks, arch, route):
    rs, _ = ranks
    key = (arch, route)
    ms = [r[key]["metrics"] for r in rs]
    assert ms[0] == ms[1]  # loss, grad_norm, clip_scale: the same bits on both ranks
    assert {"loss", "ce", "grad_norm", "clip_scale"} <= set(ms[0][0])
    ms1, p1, m1 = _one_rank_train(arch, route)
    jx = _jax_train(arch)
    for m, a, j in zip(ms[0], ms1, jx["metrics"]):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(m[k], a[k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(m[k], j[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(m["clip_scale"], a["clip_scale"], rtol=1e-5)
    params, mom = _join(rs, key, "params"), _join(rs, key, "momentum")
    for path, w in params.items():
        _close(w, p1[path], f"{path} vs 1 rank")
        _close(w, jx["params"][path], f"{path} vs JAX")
        _close(mom[path], m1[path], f"momentum {path} vs 1 rank")
        _close(mom[path], jx["momentum"][path], f"momentum {path} vs JAX")
    split = [p for p, s in rs[0][key]["specs"].items() if s]
    assert len(split) >= 4
    if arch == "mamba2-2.7b":
        assert rs[0][key]["whole"]["ssd"] == ["conv1d/kernel", "in_proj_B/kernel",
                                              "in_proj_C/kernel", "norm/scale"]


@pytest.mark.parametrize("where", ["this_thread", "other_thread"])
@pytest.mark.parametrize("arch", REMAT)
def test_remat_recompute_reenters_plan_and_mesh(ranks, arch, where):
    """Remat on at (1, 2): the backward run outside the forward's plan and
    mesh (on the card the autograd engine runs it on its device thread)
    gives the grads of the backward run inside them, bit for bit: mamba2's
    norm reduce and whisper's encoder layers recompute under the plan."""
    for r in ranks[0]:
        got, want = r[("remat", arch)][where], r[("remat", arch)]["inside"]
        assert not isinstance(got, str), got
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def _misses(got, want, tol=1e-5):
    return max(float(np.max(np.abs(got[p].numpy() - w.numpy()) - tol * np.abs(w.numpy())))
               for p, w in want.items())


@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_trap_repair_is_needed(ranks, fault):
    """With a trap's repair undone, one fused step lands past the bar that
    the repaired step meets (both against the 1-rank fused step)."""
    rs, _ = ranks
    arch = FAULTS[fault]
    _, p1, _ = _one_rank_train(arch, "fused")
    wrong = _join([{"r": r[("fault", fault)]} for r in rs], "r", "params")
    # the repaired run's first step is the fused job's; both ran 2 steps
    right = _join(rs, (arch, "fused"), "params")
    assert _misses(right, p1) <= 1e-5
    assert _misses(wrong, p1) > 1e-5, fault


def test_checkpoint_from_sharded_mamba2_equals_one_rank_save(ranks):
    _, tmp = ranks
    _, npp, _, _, _ = _setup("mamba2-2.7b")
    one = str(tmp / "one")
    state = init_train_state(params_from_numpy(npp), _tx(toptim),
                             tcore.SymogConfig(n_bits=2, total_steps=10, lambda0=LAM))
    CheckpointManager(one).save(0, state, blocking=True)
    a, b = os.path.join(str(tmp / "mamba2_init"), "ckpt_0"), os.path.join(one, "ckpt_0")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(LAUNCH_SERVE))
def test_serve_launcher_mesh_1x2_gives_the_1x1_streams(ranks, arch):
    got = []
    inner = serve_launch.run_continuous

    def run(*a, **kw):
        comps = inner(*a, **kw)
        got.append([list(map(int, c.tokens)) for c in comps])
        return comps

    serve_launch.run_continuous = run
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            serve_launch.main(_serve_argv(arch))
    finally:
        serve_launch.run_continuous = inner
    for r in ranks[0]:
        res = r[("launch", LAUNCH_SERVE[arch])]
        assert res["streams"] == got and got
    assert "ranks' token streams equal: True" in ranks[0][0][("launch", LAUNCH_SERVE[arch])]["text"]


@pytest.mark.parametrize("arch", list(LAUNCH_TRAIN))
def test_train_launcher_mesh_1x2_gives_the_1x1_losses(ranks, arch):
    with contextlib.redirect_stdout(io.StringIO()):
        one = train_launch.main(_train_argv(arch))
    rs = [r[("launch", LAUNCH_TRAIN[arch])] for r in ranks[0]]
    for r in rs:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["clip_scales"], one["clip_scales"], rtol=1e-5)
    assert rs[0]["losses"] == rs[1]["losses"]
    assert "ranks' losses equal: True" in rs[0]["text"]
