"""The port's dry run vs the JAX package's (``launch/dryrun.py``,
``op_cost.py``, ``comm_cost.py``, the shape cells, the config counts).

* ``SHAPES``, ``cell_supported`` and every ``input_specs`` leaf (shape and
  dtype) equal to JAX's for every arch x shape; ``param_count`` /
  ``active_param_count`` equal to JAX's for every arch.
* ``op_cost`` mirrors JAX's three ``jaxpr_cost`` unit tests, and equals
  ``jaxpr_cost`` (flops and dot_bytes) at reduced width: ``forward_lm`` of
  all ten archs, ``lm_train_loss`` and its backward with remat off and on
  for internlm2, olmoe and recurrentgemma.  Two differences are named and
  counted exactly: mamba2's SSD scan, and recurrentgemma's remat recompute.
* ``collective_bytes`` on JAX's loop-weighted numbers; a reduced FSDP+TP
  step on a fake 2x2 mesh records every collective ``collectives.stats``
  counts, an all-gather at g x the shard.
* ``run_cell`` on reduced internlm2 and olmoe over a fake 2x2 mesh, every
  kind and the quantized decode; the live-bytes peak of a real CPU step
  equals its fake trace's.
* ``symog_init``: f equal to JAX's and to the argmin-indexed search bit for
  bit, and the search traces under ``FakeTensorMode``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.launch.jaxpr_cost import jaxpr_cost  # noqa: E402
from repro.models.lm import forward_lm as j_forward  # noqa: E402
from repro.models.lm import init_lm as j_init_lm  # noqa: E402
from repro.models.lm import lm_train_loss as j_loss  # noqa: E402
from repro.nn.tree import flatten_with_paths as j_flatten  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core.stepsize import sse_for_f  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.collectives import Record  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.comm_cost import collective_bytes  # noqa: E402
from repro_torch.launch.op_cost import op_cost  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.lm import forward_lm, init_lm, lm_train_loss  # noqa: E402
from repro_torch.nn.tree import flatten_with_paths, tree_leaves, tree_map  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

ARCHS = tconfigs.ARCHS
B, S = 2, 64  # the op-count cells


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shape cells and config counts
# ---------------------------------------------------------------------------
def _dtype_name(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) else np.dtype(d).name


def test_shapes_and_cell_supported_equal_jax():
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name, cell in tconfigs.SHAPES.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(jconfigs.SHAPES[name])
    for arch in ARCHS:
        for getter in ("get_config", "get_reduced"):
            tcfg, jcfg = getattr(tconfigs, getter)(arch), getattr(jconfigs, getter)(arch)
            assert tcfg.supports_long == jcfg.supports_long, arch
            assert tcfg.frontend_dim == jcfg.frontend_dim, arch
            for shape in tconfigs.SHAPES:
                assert tconfigs.cell_supported(tcfg, shape) == jconfigs.cell_supported(
                    jcfg, shape), (arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for shape in tconfigs.SHAPES:
        if not tconfigs.cell_supported(tcfg, shape)[0]:
            continue
        t = dict(flatten_with_paths(tconfigs.input_specs(tcfg, shape)))
        j = dict(j_flatten(jconfigs.input_specs(jcfg, shape)))
        assert t.keys() == j.keys(), (arch, shape)
        for path, leaf in t.items():
            assert leaf.device.type == "meta", path
            assert tuple(leaf.shape) == tuple(j[path].shape), (arch, shape, path)
            assert _dtype_name(leaf.dtype) == _dtype_name(j[path].dtype), (arch, shape, path)


def test_param_counts_equal_jax():
    for arch in ARCHS:
        for getter in ("get_config", "get_reduced"):
            tcfg, jcfg = getattr(tconfigs, getter)(arch), getattr(jconfigs, getter)(arch)
            assert tcfg.param_count() == jcfg.param_count(), arch
            assert tcfg.active_param_count() == jcfg.active_param_count(), arch


# ---------------------------------------------------------------------------
# op_cost: JAX's jaxpr_cost unit tests, mirrored
# ---------------------------------------------------------------------------
def test_op_cost_counts_loop_trips():
    def f(x, w):
        for _ in range(8):  # JAX: lax.scan of length 8
            x = x @ w
        return x

    with FakeTensorMode():
        x, w = torch.empty(64, 32), torch.empty(32, 32)
        cost = op_cost(f, x, w)
    assert cost["flops"] == 8 * 2 * 64 * 32 * 32


def test_op_cost_counts_grad_and_remat():
    def loss(w, x):
        h = x
        for _ in range(4):
            h = torch.utils.checkpoint.checkpoint(lambda h: torch.tanh(h @ w), h,
                                                  use_reentrant=False)
        return torch.sum(h)

    w = torch.randn(16, 16, requires_grad=True)
    x = torch.randn(8, 16)
    fwd = op_cost(lambda: loss(w.detach(), x))["flops"]
    g = op_cost(lambda: torch.autograd.grad(loss(w, x), w))["flops"]
    # backward-with-remat ≥ 3× forward matmul cost (fwd + recompute + 2 bwd dots ~4x)
    assert g >= 3 * fwd


def test_op_cost_conv():
    def f(x, k):
        return torch.nn.functional.conv2d(x, k, padding="same")

    with FakeTensorMode():  # NCHW / OIHW: JAX's NHWC (1, 8, 8, 3), HWIO (3, 3, 3, 16)
        x, k = torch.empty(1, 3, 8, 8), torch.empty(16, 3, 3, 3)
        cost = op_cost(f, x, k)
    assert cost["flops"] == 2 * (8 * 8 * 16) * (3 * 3 * 3)


# ---------------------------------------------------------------------------
# op_cost vs jaxpr_cost on the models (shapes only: JAX's eval_shape and
# ShapeDtypeStructs, the port's tensors on the meta device)
# ---------------------------------------------------------------------------
def _batches(cfg, seq=S):
    j = {"tokens": jax.ShapeDtypeStruct((B, seq), jnp.int32)}
    t = {"tokens": torch.empty((B, seq), dtype=torch.int32, device="meta")}
    for fam, key, n in (("encdec", "frames", cfg.encoder_len), ("vlm", "patches", cfg.prefix_len)):
        if cfg.family == fam:
            j[key] = jax.ShapeDtypeStruct((B, n, cfg.d_model), jnp.float32)
            t[key] = torch.empty((B, n, cfg.d_model), device="meta")
    return j, t


def _meta_params(cfg):
    """``init_lm``'s tree on the meta device (built under FakeTensorMode)."""
    with FakeTensorMode():
        tree = init_lm(0, cfg, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def _costs(arch, train: bool, seq=S, **over):
    """(jaxpr_cost, op_cost) of the reduced forward, or of the loss and its
    grads, at B x seq."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch), **over)
    jb, tb = _batches(jcfg, seq)
    jp = jax.eval_shape(lambda: j_init_lm(jax.random.PRNGKey(0), jcfg))
    if train:
        j = jaxpr_cost(jax.grad(lambda p, b: j_loss(p, b, jcfg)[0]), jp, jb)
    else:
        j = jaxpr_cost(lambda p, b: j_forward(p, b, jcfg).logits, jp, jb)
    tp = _meta_params(tcfg)

    def step():
        if not train:
            with torch.no_grad():
                return forward_lm(tp, tb, tcfg)
        live = tree_map(lambda t: t.detach().requires_grad_(True), tp)
        loss, _ = lm_train_loss(live, tb, tcfg)
        return torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)

    return jcfg, j, op_cost(step)


# mamba2's SSD scan (src/repro/models/ssd.py:113, 117, 131 vs
# src/repro_torch/models/ssd.py::ssd_scan_ref): JAX's three-operand einsums
# contract one pair with no summed index as a dot_general (scores x decay,
# decay_out x B, exp(cum) x C; B·nc·Q·Q·H, B·nc·Q·N·H and B·nc·Q·H·N
# products), which the port multiplies elementwise; and JAX's chunk-state dot
# reads that (B, nc, Q, N, H) product where the port's reads Bᵀ (B, nc, N, Q).
# At B 2, S 64 the port counts 0.9914x JAX's flops and 0.8178x its dot_bytes.
def _ssd_einsum_excess(cfg):
    Q, H, N = min(cfg.ssd_chunk, S), cfg.ssm_heads, cfg.ssm_state
    nc = S // Q
    f32 = 4
    flops = 2 * B * nc * Q * (Q * H + N * H + H * N)
    dot_bytes = f32 * B * nc * Q * (
        (Q + Q * H + Q * H)          # scores, decay -> their product
        + (H + N + N * H)            # decay_out, B -> their product
        + (H + N + H * N)            # exp(cum), C -> their product
        + N * H - N)                 # the chunk-state dot's lhs, less the port's Bᵀ
    return cfg.n_layers * flops, cfg.n_layers * dot_bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_op_cost_forward_equals_jaxpr_cost(arch):
    jcfg, j, t = _costs(arch, train=False)
    if arch == "mamba2-2.7b":
        d_flops, d_bytes = _ssd_einsum_excess(jcfg)
        assert (t["flops"], t["dot_bytes"]) == (j["flops"] - d_flops, j["dot_bytes"] - d_bytes)
        assert round(t["flops"] / j["flops"], 4) == 0.9914
        assert round(t["dot_bytes"] / j["dot_bytes"], 4) == 0.8178
        return
    assert (t["flops"], t["dot_bytes"]) == (j["flops"], j["dot_bytes"])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b", "recurrentgemma-2b"])
@pytest.mark.parametrize("remat", [False, True])
def test_op_cost_train_equals_jaxpr_cost(arch, remat):
    # recurrentgemma with remat at 6 layers: two RRL units, so JAX's unit
    # scan (and its jax.checkpoint) has a stacked group to act on; without,
    # one unit; 16 tokens, twice its reduced window
    seq, over = S, {}
    if arch == "recurrentgemma-2b":
        seq, over = 16, {"n_layers": 6 if remat else 3}
    jcfg, j, t = _costs(arch, train=True, seq=seq, remat=remat, **over)
    if remat and arch == "recurrentgemma-2b":
        # JAX checkpoints a whole RRL unit: its backward reruns the unit's
        # forward, the down projections of the unit's first two layers
        # included (the next layer reads their outputs).  The port
        # checkpoints each layer, and torch's non-reentrant checkpoint stops
        # its recompute at the layer's last saved tensor, which the down
        # projection's output is not: 2 dots a unit fewer.
        units = jcfg.n_layers // len(jcfg.layer_pattern)
        n = units * (len(jcfg.layer_pattern) - 1)
        bf16 = 2
        down_flops = 2 * B * seq * jcfg.d_ff * jcfg.d_model
        down_bytes = bf16 * (B * seq * jcfg.d_ff + jcfg.d_ff * jcfg.d_model
                             + B * seq * jcfg.d_model)
        assert (t["flops"], t["dot_bytes"]) == (j["flops"] - n * down_flops,
                                                j["dot_bytes"] - n * down_bytes)
        return
    assert (t["flops"], t["dot_bytes"]) == (j["flops"], j["dot_bytes"])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def test_collective_bytes_weights_loops():
    # JAX's test_collective_parser_weights_loops: 24 all-reduces of f32[128]
    # in a loop body and one of f32[256] outside, groups of 16
    recs = [Record("all_reduce", 128 * 4, 16, False)] * 24 + [
        Record("all_reduce", 256 * 4, 16, False)]
    rec = collective_bytes(recs)
    expect = 128 * 4 * 2 * 15 / 16 * 24 + 256 * 4 * 2 * 15 / 16
    assert abs(rec["all-reduce_bytes"] - int(expect)) <= 2
    assert rec["all-reduce_count"] == 25
    assert rec["total_bytes"] == rec["all-reduce_bytes"]
    assert "total_bytes_tpu" not in rec


def test_fake_mesh_records_equal_stats():
    """A reduced gemma2 step under fsdp_tp on a fake 2x2 mesh: every
    collective is recorded, with the result's bytes: an all-gather's g x
    the shard given, a reduce-scatter's 1/g of it."""
    cfg = dataclasses.replace(tconfigs.get_reduced("gemma2-27b"), sharding_profile="fsdp_tp",
                              n_layers=2)
    cell = tconfigs.ShapeCell("t", "train", 16, 4)
    collectives.reset_stats()
    t = dryrun.trace_cell(cfg, cell, mesh_shape=(2, 2), accum_steps=1)
    calls, given = collectives.stats["calls"], collectives.stats["bytes"]
    assert calls["all_gather"] > 0 and calls["reduce_scatter"] > 0
    for kind in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
        mine = [r for r in t["records"] if r.kind == kind]
        assert len(mine) == calls[kind], kind
        scale = {"all_gather": 2, "reduce_scatter": 0.5}.get(kind, 1)
        assert sum(r.result_bytes for r in mine) == given[kind] * scale, kind
        # the (data, model) sums of sum_over_shards span all 4 ranks of one node
        assert all(r.group in (2, 4) and r.in_node for r in mine), kind
    out = collective_bytes(t["records"])
    assert out["all-gather_count"] == calls["all_gather"]
    assert out["all-gather_bytes"] == int(given["all_gather"] * 2 * 1 / 2)


# ---------------------------------------------------------------------------
# run_cell and the memory tracker
# ---------------------------------------------------------------------------
JAX_KEYS = ("arch", "shape", "mesh", "chips", "profile", "quantized", "trace_s", "logical",
            "memory", "collectives", "roofline", "status")
CELLS = {"train_4k": tconfigs.ShapeCell("train_4k", "train", 32, 4),
         "prefill_32k": tconfigs.ShapeCell("prefill_32k", "prefill", 32, 4),
         "decode_32k": tconfigs.ShapeCell("decode_32k", "decode", 32, 4)}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_run_cell_reduced_on_fake_mesh(arch):
    cfg = dataclasses.replace(tconfigs.get_reduced(arch), n_layers=1)
    for shape, cell in CELLS.items():
        for q in ((False, True) if cell.kind == "decode" else (False,)):
            rec = dryrun.run_cell(arch, shape, False, q, cfg=cfg, cell=cell, mesh_shape=(2, 2),
                                  accum_steps=1)
            assert rec["status"] == "OK", (shape, q)
            assert all(k in rec for k in JAX_KEYS), (shape, q)
            assert rec["rank"] == 0 and rec["mesh"] == "2x2" and rec["chips"] == 4
            assert not {"lower_s", "compile_s", "cost_analysis_raw"} & rec.keys()
            assert rec["logical"]["flops"] > 0 and rec["memory"]["fits"]
            assert rec["memory"]["peak_bytes"] > rec["memory"]["state_bytes"] > 0
            assert rec["collectives"]["total_bytes"] > 0
            assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
            assert ("resident" in rec) == (cell.kind == "decode")
    skip = dryrun.run_cell(arch, "long_500k", False, cfg=cfg)
    assert skip["status"] == "SKIP" and "long_500k requires" in skip["reason"]


def test_cli_records_skip_and_error_site(tmp_path, monkeypatch):
    """The CLI writes a cell's record: a SKIP with JAX's reason, and a step
    that reads a fake tensor's value on the host as ERROR naming the port's
    line that read it."""
    import json

    from repro_torch.nn.tree import tree_map as port_tree_map

    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "whisper-large-v3", "--shape", "long_500k"]) == 0
    rec = json.loads((tmp_path / "pod1" / "whisper-large-v3__long_500k.json").read_text())
    assert rec["status"] == "SKIP" and rec["reason"] == tconfigs.cell_supported(
        tconfigs.get_config("whisper-large-v3"), "long_500k")[1]

    def host_read(*args, **kw):
        with FakeTensorMode():
            port_tree_map(lambda t: t.item(), {"x": torch.empty(())})

    monkeypatch.setattr(dryrun, "run_cell", host_read)
    assert dryrun.main(["--arch", "mamba2-2.7b", "--shape", "decode_32k", "--quantized"]) == 1
    rec = json.loads((tmp_path / "pod1" / "mamba2-2.7b__decode_32k_q2.json").read_text())
    assert rec["status"] == "ERROR" and rec["rank"] == 0 and rec["quantized"]
    assert rec["site"].startswith("src/repro_torch/nn/tree.py:"), rec["site"]
    assert "DataDependentOutput" in rec["error"]


def _train_setup(cfg):
    tx = toptim.sgd(momentum=0.9, nesterov=True)
    scfg = tcore.SymogConfig(n_bits=2, total_steps=100)
    params = init_lm(0, cfg, device="cpu")
    from repro_torch.train import TrainState, make_train_step

    state = TrainState(params, tx.init(params), tcore.symog_init(params, scfg, shapes_only=True),
                       0)
    step = make_train_step(cfg, tx, tcore.constant(0.01), symog_cfg=scfg, cast_params=True)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32)}
    return state, step, batch


def test_live_bytes_real_step_equals_fake_trace():
    """A real CPU step's peak, and its fake trace's (each builds its rope
    table inside the step and keeps it: the real cache starts empty)."""
    cfg = dataclasses.replace(tconfigs.get_reduced("internlm2-1.8b"), remat=True)
    peaks = []
    with dryrun.plain_routes():
        layers._rope_freq.cache_clear()
        state, step, batch = _train_setup(cfg)  # real tensors
        peaks.append(dryrun.measure(lambda: step(state, batch), (state, batch),
                                    torch.device("cpu")))
        with FakeTensorMode():
            state, step, batch = _train_setup(cfg)
            peaks.append(dryrun.measure(lambda: step(state, batch), (state, batch),
                                        torch.device("cpu")))
    real, fake = peaks
    assert real["state_bytes"] == fake["state_bytes"] > 0
    assert real["peak_bytes"] == fake["peak_bytes"] > real["state_bytes"]
    assert real["logical"] == fake["logical"]
    # a fake trace leaves no fake tensor in the model's host-built tables
    with torch.no_grad():
        out = forward_lm(init_lm(0, cfg, device="cpu"),
                         {"tokens": torch.zeros((1, 8), dtype=torch.int32)}, cfg)
    assert torch.isfinite(out.logits).all()


# ---------------------------------------------------------------------------
# symog_init: the repaired search
# ---------------------------------------------------------------------------
def _argmin_indexed_f(w, n_bits):
    """The search as it was: f* read by indexing the candidates with the
    argmin (a host read)."""
    fs = torch.arange(tcore.F_MIN, tcore.F_MAX + 1)
    sses = torch.stack([sse_for_f(w, f, n_bits) for f in fs])
    return fs[torch.argmin(sses)]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
def test_symog_init_equals_argmin_indexed_search(arch):
    params = init_lm(0, tconfigs.get_reduced(arch), device="cpu")
    st = tcore.symog_init(params, tcore.SymogConfig(n_bits=2))
    leaves = dict(flatten_with_paths(params))
    for path, f in flatten_with_paths(st.f):
        assert f.dtype == torch.int32
        if not st.mask[path]:
            continue
        w = leaves[path]
        if f.ndim:  # one f per expert
            ref = torch.stack([_argmin_indexed_f(e, 2) for e in w.reshape(-1, *w.shape[-2:])])
            assert torch.equal(f.reshape(-1), ref.to(torch.int32)), path
        else:
            assert int(f) == int(_argmin_indexed_f(w, 2)), path


def test_symog_init_equals_jax_and_traces_fake():
    cfg = tconfigs.get_reduced("internlm2-1.8b")
    scfg = tcore.SymogConfig(n_bits=2)
    params = init_lm(0, cfg, device="cpu")
    st = tcore.symog_init(params, scfg)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jf = dict(j_flatten(jax.jit(lambda p: jcore.symog_init(p, jcore.SymogConfig(n_bits=2)).f)(jp)))
    for path, f in flatten_with_paths(st.f):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf[path]), err_msg=path)
    with FakeTensorMode():
        fp = init_lm(0, cfg, device="cpu")
        fst = tcore.symog_init(fp, scfg)
        shapes = tcore.symog_init(fp, scfg, shapes_only=True)
    for (path, f), (_, g), (_, h) in zip(flatten_with_paths(st.f), flatten_with_paths(fst.f),
                                         flatten_with_paths(shapes.f)):
        assert tuple(g.shape) == tuple(h.shape) == tuple(f.shape), path
        assert g.dtype == h.dtype == f.dtype, path
