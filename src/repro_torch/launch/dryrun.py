"""Multi-pod dry run of the port: every (arch x shape x mesh) cell traced on
fake tensors and a fake process group (the counterpart of
``repro/launch/dryrun.py``, same CLI and record keys).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --meshes pod1 --jobs 4  # a subprocess a cell

JAX lowers and compiles a cell from ``ShapeDtypeStruct``s on 512 forced
host devices.  The port has no compiler to ask: ``trace_cell`` joins
torch's ``fake`` process group at the mesh's world (256 for 16x16, 512 for
2x16x16) as rank 0, builds JAX's production ``Mesh``, builds the whole
seeded state under ``FakeTensorMode`` (no storage), keeps rank 0's pieces
as the port's own paths place them, and runs rank 0's step on fake
tensors of the card (``cuda`` where this torch has CUDA; on a CPU-only
torch, ``cpu`` fakes, where the one difference is ``models.layers``'
``ROW_TILE`` padding of a float matmul's rows, which only the card's path
adds).  The record's numbers are therefore rank 0's program:

  * ``logical`` — ``op_cost``'s flops and dot_bytes of the step, as it ran
    (loop trips, remat's recompute and the backward included);
  * ``memory``  — the peak of live bytes on the trace device during the
    step (``op_cost.OpCounter``'s live bytes), counted from after the whole state was
    built and cut: a rank keeps only its pieces; ``fits`` against the
    H100's 80 GB;
  * ``collectives`` — the step's collectives through
    ``distributed/collectives.py``, as ``comm_cost.collective_bytes``;
  * ``roofline`` — per-rank terms over the H100's rates: compute_s =
    flops / 989e12 (bf16 dense), memory_s = dot_bytes / 3.35e12,
    collective_s = each collective's wire bytes over its link (NVLink 4 at
    450e9 B/s a direction inside an 8-GPU node, else one 400 Gb/s
    InfiniBand port, 50e9 B/s), useful_flops_ratio = model flops / (rank
    flops x chips).

The state per kind: ``train`` places a ``TrainState`` by
``train.sharding.train_layout`` / ``shard_train_state`` (JAX's
``TRAIN_ACCUM`` microbatches, bf16 momentum for deepseek, ``cast_params``,
``SymogConfig(n_bits=2, total_steps=10_000)``; SYMOG's f by shape only,
``symog_init(shapes_only=True)``) and runs ``make_train_step(mesh=)`` on
the global batch; ``prefill`` / ``decode`` place a bf16 tree as a sharded
``ServeEngine`` does (``make_tp_plan``, ``shard_tree`` with
``serve_spec_fn``, ``local_config``), the batch rows cut over the
(pod, data) axes when they divide, as JAX's ``data_shardings``; decode
runs ``decode_lm`` on dense ``init_caches`` at the local config, and with
``--quantized`` on the ``pack_tree`` 2-bit tree and an ``int8_fp`` cache.
Every kernel route is pinned to its plain version for the trace (a fake
tensor cannot enter a compiled kernel): 'unpack', 'composed', 'composed'.

Nothing lowers or compiles, so there is no ``lower_s``, ``compile_s`` or
``cost_analysis_raw``; ``trace_s`` is the trace's seconds.  A step that
reads a tensor's value on the host (``.item()``, a Python branch on a
tensor) stops the trace: the cell's record is then ``ERROR`` with the
traceback and ``site``, the innermost line of the port that raised.
Records go to ``build/repro_torch_dryrun/pod1|pod2/<arch>__<shape>[_q2].json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeCell, cell_supported, get_config
from repro_torch.distributed import collectives
from repro_torch.launch.comm_cost import IB_BW, NVLINK_BW, collective_bytes, collective_seconds
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models.config import ModelConfig

RESULTS_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "repro_torch_dryrun"
)

# H100 SXM (roofline denominators): bf16 dense FLOP/s, HBM3 bytes/s, HBM bytes
H100 = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "hbm_bytes": 80e9}

TRAIN_ACCUM = 8  # all train_4k cells are 1M tokens/step — grad accumulation

NOTES = ("rank 0's program on fake tensors of the trace device; nothing lowers or compiles "
         "(no lower_s / compile_s / cost_analysis_raw); logical and memory are one rank's; "
         "collectives at the given dtype (no _tpu key)")


def _train_accum(cfg: ModelConfig, multi_pod: bool) -> int:
    # JAX's rule: deepseek-671b single-pod takes x16 microbatches (its
    # 7168-wide activations), multi-pod x8 (16 sequences would be fewer
    # than the 32-way (pod, data) batch split)
    return 16 if (cfg.name.startswith("deepseek") and not multi_pod) else TRAIN_ACCUM


def trace_device() -> torch.device:
    """The card's device where this torch has CUDA, else the CPU."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


@contextlib.contextmanager
def fake_world(world: int):
    """Join torch's ``fake`` process group at ``world`` ranks as rank 0
    (``WORLD_SIZE`` / ``RANK`` set for ``launch.mesh``), and leave it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    env = {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK")}
    os.environ.update(WORLD_SIZE=str(world), RANK="0")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def plain_routes():
    """Pin this thread's kernel routes to their plain versions."""
    from repro_torch.kernels import dispatch

    prev = (dispatch.get_packed_backend(), dispatch.get_attention_backend(),
            dispatch.get_update_backend())
    dispatch.set_packed_backend("unpack")
    dispatch.set_attention_backend("composed")
    dispatch.set_update_backend("composed")
    try:
        yield
    finally:
        dispatch.set_packed_backend(prev[0])
        dispatch.set_attention_backend(prev[1])
        dispatch.set_update_backend(prev[2])


def measure(fn, state: Any, device: torch.device) -> Dict[str, Any]:
    """Run ``fn()`` under the counters: {'logical' (flops, dot_bytes),
    'peak_bytes', 'state_bytes' (``state``'s live bytes on ``device``'s
    type, registered first), 'records' (the collectives), 'seconds'}."""
    ops = OpCounter(device.type)
    ops.add(state)
    state_bytes = ops.live
    t0 = time.perf_counter()
    with collectives.recorded() as records, ops:
        fn()
    return {"logical": dict(ops.totals), "peak_bytes": ops.peak, "state_bytes": state_bytes,
            "records": list(records), "seconds": time.perf_counter() - t0}


def _batch_rows(B: int, mesh) -> int:
    """A serving rank's rows: B over the (pod, data) axes when they divide
    it (JAX's ``data_shardings``), else every row."""
    from repro_torch.launch.shardings import _batch_axes
    from repro_torch.nn.sharding import mesh_axis_size

    n = mesh_axis_size(mesh, *_batch_axes(mesh))
    return B // n if n > 1 and B % n == 0 else B


def _frontend(cfg: ModelConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    out = {}
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((batch, cfg.encoder_len, cfg.d_model), device=device)
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((batch, cfg.prefix_len, cfg.d_model), device=device)
    return out


def train_case(cfg: ModelConfig, cell: ShapeCell, mesh, accum: int, dev):
    """((state, batch), step thunk) of a train cell: this rank's
    ``TrainState`` pieces, built whole on ``dev`` and cut (real or fake
    tensors: whatever mode is active)."""
    from repro_torch import core, optim
    from repro_torch.models.lm import init_lm
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.sharding import shard_train_state, train_layout

    mom_dtype = torch.bfloat16 if cfg.name.startswith("deepseek") else torch.float32
    tx = optim.sgd(momentum=0.9, nesterov=True, momentum_dtype=mom_dtype)
    scfg = core.SymogConfig(n_bits=2, total_steps=10_000)
    step = make_train_step(cfg, tx, core.constant(0.01), symog_cfg=scfg,
                           accum_steps=accum, cast_params=True,
                           mesh=mesh)
    params = init_lm(0, cfg, device=dev)
    state = TrainState(params, tx.init(params), core.symog_init(params, scfg, shapes_only=True),
                       0)
    state = shard_train_state(state, train_layout(cfg, mesh))
    batch = {"tokens": torch.zeros((cell.batch, cell.seq), dtype=torch.int32, device=dev),
             **_frontend(cfg, cell.batch, dev)}
    return (state, batch), lambda: step(state, batch)


def serve_params(cfg: ModelConfig, mesh, quantized: bool, dev, shapes_only: bool = True):
    """(plan, local config, this rank's bf16 or packed 2-bit params on dev):
    the whole bf16 tree built on ``dev``, packed (SYMOG's f searched unless
    ``shapes_only``) and cut as a sharded ``ServeEngine`` cuts it."""
    from repro_torch import core
    from repro_torch.models.lm import init_lm
    from repro_torch.nn.sharding import make_rules, shard_tree
    from repro_torch.serve.sharding import local_config, make_tp_plan, serve_spec_fn

    params = init_lm(0, cfg, dtype=torch.bfloat16, device=dev)
    if quantized:
        scfg = core.SymogConfig(n_bits=2, total_steps=1)
        params = core.pack_tree(params, core.symog_init(params, scfg, shapes_only=shapes_only),
                                scfg)
    rules = make_rules(mesh, cfg.sharding_profile)
    plan = make_tp_plan(cfg, params, mesh, rules)
    params = shard_tree(rules, mesh, params, serve_spec_fn(cfg, plan, rules))
    return plan, local_config(cfg, plan), params


def served(plan, mesh, fn):
    """``fn`` run as a sharded engine runs it: the plan and mesh set, no grad."""
    from repro_torch.models.layers import set_tp

    def run():
        prev = set_tp(plan)
        try:
            with torch.no_grad(), mesh:
                return fn()
        finally:
            set_tp(prev)

    return run


def _prefill_case(cfg: ModelConfig, cell: ShapeCell, mesh, dev):
    from repro_torch.models.lm import prefill_lm

    plan, lcfg, params = serve_params(cfg, mesh, False, dev)
    rows = _batch_rows(cell.batch, mesh)
    batch = {"tokens": torch.zeros((rows, cell.seq), dtype=torch.int32, device=dev),
             **_frontend(cfg, rows, dev)}
    cache_len = cell.seq + (cfg.prefix_len if cfg.family == "vlm" else 0)
    return (params, batch), served(plan, mesh, lambda: prefill_lm(params, batch, lcfg,
                                                                 max_len=cache_len))


def _decode_case(cfg: ModelConfig, cell: ShapeCell, mesh, quantized: bool, dev):
    from repro_torch.models.lm import decode_lm, init_caches

    plan, lcfg, params = serve_params(cfg, mesh, quantized, dev)
    rows = _batch_rows(cell.batch, mesh)
    caches = init_caches(lcfg, rows, cell.seq, device=dev)
    tokens = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    pos = cell.seq - 1  # the cache's last slot: every earlier one is read
    return (params, caches, tokens), served(plan, mesh, lambda: decode_lm(
        params, caches, tokens, pos, lcfg))


def _tree_bytes(tree) -> int:
    from repro_torch.launch.op_cost import tensors_of

    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def _mesh_name_chips(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]]) -> Tuple[str, int]:
    """The mesh's name and rank count: JAX's production mesh, or ``mesh_shape``."""
    if mesh_shape is None:
        return ("2x16x16", 512) if multi_pod else ("16x16", 256)
    return "x".join(str(n) for n in mesh_shape), math.prod(mesh_shape)


def _mesh_for(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]]):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.nn.sharding import Mesh

    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    return Mesh(tuple(mesh_shape), axes)


def trace_cell(cfg: ModelConfig, cell: ShapeCell, *, multi_pod: bool = False,
               quantized: bool = False, mesh_shape: Optional[Tuple[int, ...]] = None,
               accum_steps: Optional[int] = None) -> Dict[str, Any]:
    """Trace one cell (the counterpart of JAX's ``_lower_cell``): joins the
    fake group at the mesh's world as rank 0, places rank 0's state under
    ``FakeTensorMode`` and runs its step (the module docstring).  Returns
    ``measure``'s dict plus 'resident' (decode: params and cache bytes).
    ``accum_steps`` replaces JAX's microbatch count of a train cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    world = _mesh_name_chips(multi_pod, mesh_shape)[1]
    dev = trace_device()
    if quantized:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8_fp")
    with fake_world(world), plain_routes():
        mesh = _mesh_for(multi_pod, mesh_shape)
        with FakeTensorMode():
            if cell.kind == "train":
                accum = accum_steps or _train_accum(cfg, multi_pod)
                state, run = train_case(cfg, cell, mesh, accum, dev)
            elif cell.kind == "prefill":
                state, run = _prefill_case(cfg, cell, mesh, dev)
            else:
                state, run = _decode_case(cfg, cell, mesh, quantized, dev)
            out = measure(run, state, dev)
    if cell.kind == "decode":
        out["resident"] = {"params_bytes": _tree_bytes(state[0]),
                           "cache_bytes": _tree_bytes(state[1])}
    out["trace_device"] = dev.type
    return out


def _model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """6·N·D (train) / 2·N·D per generated token (serve), N = active params."""
    n_active = cfg.active_param_count()
    tokens = cell.batch * (cell.seq if cell.kind in ("train", "prefill") else 1)
    mult = 6 if cell.kind == "train" else 2
    return float(mult) * n_active * tokens


def run_cell(arch: str, shape: str, multi_pod: bool, quantized: bool = False, *,
             cfg: Optional[ModelConfig] = None, cell: Optional[ShapeCell] = None,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             accum_steps: Optional[int] = None) -> Dict[str, Any]:
    """The cell's record (JAX's ``run_cell`` keys where they mean the same).
    ``cfg`` / ``cell`` / ``mesh_shape`` / ``accum_steps`` replace the
    published config, the shape cell, the production mesh and the
    microbatch count (tests run reduced cells)."""
    cfg = cfg or get_config(arch)
    cell = cell or SHAPES[shape]
    ok, reason = cell_supported(cfg, shape)
    mesh_name, chips = _mesh_name_chips(multi_pod, mesh_shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "profile": cfg.sharding_profile, "quantized": quantized, "rank": 0,
    }
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec

    t = trace_cell(cfg, cell, multi_pod=multi_pod, quantized=quantized,
                   mesh_shape=mesh_shape, accum_steps=accum_steps)
    rec["trace_device"] = t["trace_device"]
    rec["trace_s"] = round(t["seconds"], 1)
    if "resident" in t:
        rec["resident"] = t["resident"]
    logical = t["logical"]
    rec["logical"] = logical
    rec["memory"] = {"peak_bytes": t["peak_bytes"], "state_bytes": t["state_bytes"],
                     "capacity_bytes": int(H100["hbm_bytes"]),
                     "fits": t["peak_bytes"] <= H100["hbm_bytes"]}
    rec["collectives"] = collective_bytes(t["records"])
    wire = collective_seconds(t["records"])
    model_flops = _model_flops(cfg, cell)
    rec["roofline"] = {
        "compute_s": logical["flops"] / H100["peak_flops"],
        "memory_s": logical["dot_bytes"] / H100["hbm_bw"],
        "collective_s": wire["collective_s"],
        "collective_nvlink_s": wire["nvlink_s"],
        "collective_ib_s": wire["ib_s"],
        "links": {"nvlink": f"NVLink 4, {NVLINK_BW:.0f} B/s a direction (groups inside "
                            "one 8-GPU node)",
                  "ib": f"InfiniBand 400 Gb/s, {IB_BW:.0f} B/s a GPU (groups across nodes)"},
        "model_flops_total": model_flops,
        "model_flops_per_chip": model_flops / chips,
        "useful_flops_ratio": (model_flops / (logical["flops"] * chips)
                               if logical["flops"] else 0.0),
    }
    if "resident" in rec:
        rec["roofline"]["memory_s_resident"] = (
            (rec["resident"]["params_bytes"] + rec["resident"]["cache_bytes"]) / H100["hbm_bw"])
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: rec["roofline"][k])
    rec["roofline"]["dominant"] = dom
    rec["notes"] = NOTES
    rec["status"] = "OK"
    return rec


def error_site(tb: traceback.StackSummary) -> str:
    """``file:line`` of the innermost frame of the port's model, training or
    serving code (this module and the counters aside), else the innermost."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = os.path.dirname(here)
    skip = {os.path.join(here, "dryrun.py"), os.path.join(here, "op_cost.py")}
    for fr in reversed(tb):
        path = os.path.abspath(fr.filename)
        if path.startswith(port + os.sep) and path not in skip:
            return f"src/repro_torch/{os.path.relpath(path, port)}:{fr.lineno}"
    return f"{tb[-1].filename}:{tb[-1].lineno}" if tb else ""


def _result_path(arch: str, shape: str, multi_pod: bool, quantized: bool = False) -> str:
    d = os.path.join(os.path.abspath(RESULTS_DIR), "pod2" if multi_pod else "pod1")
    os.makedirs(d, exist_ok=True)
    suffix = "_q2" if quantized else ""
    return os.path.join(d, f"{arch}__{shape}{suffix}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="all cells via subprocesses")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quantized", action="store_true",
                    help="decode with SYMOG 2-bit packed weights")
    ap.add_argument("--meshes", default="both", choices=("pod1", "pod2", "both"))
    ap.add_argument("--jobs", type=int, default=1, help="--all: cells traced at once")
    args = ap.parse_args(argv)

    if args.all:
        failures = []
        todo = []
        meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.meshes]
        for mp in meshes:
            for arch in ARCHS:
                for shape in SHAPES:
                    variants = [False]
                    if SHAPES[shape].kind == "decode":
                        variants.append(True)  # SYMOG-packed serving variant
                    for q in variants:
                        path = _result_path(arch, shape, mp, q)
                        if os.path.exists(path) and not args.force:
                            continue
                        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                               "--arch", arch, "--shape", shape]
                        if mp:
                            cmd.append("--multi-pod")
                        if q:
                            cmd.append("--quantized")
                        todo.append(((arch, shape, mp, q), cmd))
        running = []
        while todo or running:
            while todo and len(running) < args.jobs:
                (arch, shape, mp, q), cmd = todo.pop(0)
                print(f"[dryrun] {arch} x {shape}{' x q2' if q else ''} x "
                      f"{'2x16x16' if mp else '16x16'}", flush=True)
                running.append(((arch, shape, mp, q), subprocess.Popen(cmd, env={**os.environ})))
            cell, proc = running.pop(0)
            if proc.wait() != 0:
                failures.append(cell)
        if failures:
            print("FAILURES:", failures)
            return 1
        print("dry-run matrix complete")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch/--shape required without --all")
    path = _result_path(args.arch, args.shape, args.multi_pod, args.quantized)
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, quantized=args.quantized)
    except Exception as e:
        rec = {
            "arch": args.arch, "shape": args.shape,
            "mesh": "2x16x16" if args.multi_pod else "16x16", "quantized": args.quantized,
            "rank": 0, "status": "ERROR", "site": error_site(traceback.extract_tb(e.__traceback__)),
            "error": traceback.format_exc(),
        }
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        print(rec["error"], file=sys.stderr)
        return 1
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
