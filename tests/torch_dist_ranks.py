"""Rank side of the port's multi-process CPU tests (not collected: no
``test_`` prefix; ``test_torch_sharded_serve.py`` and
``test_torch_distributed.py`` import it).

``run_ranks(fn, world, payload)`` starts ``world`` spawned processes, each a
gloo rank with one intra-op thread, runs ``fn(rank, world, payload)`` (a
function of this module) in each and returns their results.  A rank that
raises reports its traceback; every process is joined within ``timeout``
and killed past it, and the process group's own timeout fails a rank whose
peer died.  This module imports torch and the port only: JAX references
are computed in the parent.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


class _Failure:
    def __init__(self, text: str):
        self.text = text


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, world: int, payload, *, timeout: float = 240.0):
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "payload.pt")
        torch.save(payload, src)
        port = _free_port()
        outs = [os.path.join(tmp, f"out{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_entry, args=(fn.__name__, r, world, port, src, outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5)
        results, errors = [], []
        for r, p in enumerate(procs):
            res = torch.load(outs[r], weights_only=False) if os.path.exists(outs[r]) else None
            if isinstance(res, _Failure):
                errors.append(f"rank {r}:\n{res.text}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
            results.append(res)
        if alive:
            errors.append(f"{len(alive)} rank(s) still running after {timeout} s: killed")
        if errors:
            raise RuntimeError("\n".join(errors))
        return results


def _entry(name, rank, world, port, src, out):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        payload = torch.load(src, weights_only=False)
        res = globals()[name](rank, world, payload)
        torch.save(res, out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, then this rank exits non-zero
        torch.save(_Failure(traceback.format_exc()), out)
        os._exit(1)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def serve_jobs(rank, world, payload):
    """Each job: an engine on a (d, m) mesh serving ``requests`` greedily;
    returns per job the token streams and what the engine placed."""
    from repro_torch.models.lm import PAGED_CACHE_LEAVES, scan_groups
    from repro_torch.nn.sharding import Mesh
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.serve.sharding import pool_bytes_per_device

    out = {}
    for job in payload["jobs"]:
        mesh = Mesh(job["mesh"], ("data", "model"))
        if job.get("refused"):  # a family with no tensor-parallel form
            try:
                ServeEngine(job["cfg"], job["params"], max_len=job["max_len"],
                            compute_dtype=torch.float32, device="cpu", mesh=mesh)
            except NotImplementedError as e:
                out[job["name"]] = {"refused": str(e)}
            continue
        eng = ServeEngine(job["cfg"], job["params"], max_len=job["max_len"],
                          compute_dtype=torch.float32, device="cpu", mesh=mesh)
        reqs = [Request(tokens=np.asarray(t), max_new_tokens=b) for t, b in job["requests"]]
        sc = ServeConfig(n_slots=2, block_size=16, temperature=0.0)
        comps, sched = eng.serve(reqs, sc, return_scheduler=True)
        pools, scales = {}, {}
        for g in scan_groups(eng.cfg):
            for j, paged in enumerate(g.paged):
                for name, leaf in sched.caches[g.name][f"sub{j}"].items():
                    key = f"{g.name}/sub{j}/{name}"
                    if paged and name in PAGED_CACHE_LEAVES:
                        pools[key] = tuple(leaf.shape)
                    elif paged and name.removesuffix("_scale") in PAGED_CACHE_LEAVES:
                        scales[key] = leaf.clone()
        n_blocks = sched.n_blocks
        out[job["name"]] = {
            "tokens": [list(map(int, c.tokens)) for c in comps],
            "model_shards": eng.model_shards(),
            "plan": {k: getattr(eng.tp, k) for k in ("attn", "mlp", "embed", "head", "ep")},
            "ep_moe": bool(eng.capabilities()["ep_moe"]),
            "pools": pools,
            "scales": scales,
            "block_tables": sched._block_tables.clone(),
            "paged_pool_bytes": sched.paged_pool_bytes(),
            "pool_bytes": pool_bytes_per_device(eng, sched.block_size, n_blocks),
            "local_heads": (eng.cfg.n_heads, eng.cfg.n_kv_heads),
        }
    return out


# ---------------------------------------------------------------------------
# expert parallelism, data parallelism, compression, checkpoints
# ---------------------------------------------------------------------------
def ep_jobs(rank, world, payload):
    """``moe_apply_ep`` on a (2, 2) mesh with x split over 'data': 1-D EP
    (experts over 'model') and 2-D (over ('data', 'model')); y, and the
    grads of sum(y²) w.r.t. x and every param."""
    from repro_torch.models.moe_ep import moe_apply_ep
    from repro_torch.nn.sharding import Mesh

    mesh = Mesh((2, 2), ("data", "model"))
    x_all = torch.from_numpy(payload["x"])
    b = x_all.shape[0] // 2
    out = {"coords": dict(mesh.coords)}
    for name, ep_axes in (("1d", ("model",)), ("2d", ("data", "model"))):
        x = x_all[mesh.coords["data"] * b:(mesh.coords["data"] + 1) * b].clone().requires_grad_(True)
        p = {k: {kk: {"kernel": v["kernel"].clone().requires_grad_(True)} for kk, v in sub.items()}
             if k != "router" else {"kernel": sub["kernel"].clone().requires_grad_(True)}
             for k, sub in payload["params"].items()}
        y, aux = moe_apply_ep(p, x, cfg=payload["cfg"], compute_dtype=torch.float32,
                              ep_axes=ep_axes, dp_axes=("data",), capacity_mult=8.0, mesh=mesh)
        torch.sum(y ** 2).backward()
        grads = {"x": x.grad, "router": p["router"]["kernel"].grad}
        for k in ("experts", "shared"):
            for kk, v in p[k].items():
                grads[f"{k}/{kk}"] = v["kernel"].grad
        out[name] = {"y": y.detach(), "grads": grads,
                     "aux": {k: float(v) for k, v in aux.items()}}
    return out


def dp_jobs(rank, world, payload):
    """A data-parallel step on a (2, 1) mesh (fused and composed updates),
    the checkpoint of the initial and the stepped state written by rank 0,
    its restore onto a (1, 2) mesh, and rounds of ``compressed_psum_int8``."""
    from repro_torch import core, optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import CompressionState, compressed_psum_int8
    from repro_torch.kernels import dispatch
    from repro_torch.models import init_lm
    from repro_torch.nn.sharding import Mesh, make_rules
    from repro_torch.train import init_train_state, make_train_step

    cfg = payload["cfg"]
    mesh = Mesh((2, 1), ("data", "model"))
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    scfg = core.SymogConfig(n_bits=2, total_steps=10)
    out = {}
    for route in ("fused", "composed"):
        dispatch.set_update_backend(route)
        state = init_train_state(init_lm(0, cfg, device="cpu"), tx, scfg)
        if route == "fused":
            CheckpointManager(payload["ckpt_init"]).save(0, state, blocking=True, mesh=mesh)
        step = make_train_step(cfg, tx, lambda s: 0.01, symog_cfg=scfg,
                               compute_dtype=torch.float32, mesh=mesh)
        state, metrics = step(state, payload["batch"])
        out[route] = {"params": state.params, "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"])}
        if route == "fused":
            CheckpointManager(payload["ckpt_step"]).save(1, state, blocking=True, mesh=mesh)
    dispatch.set_update_backend("auto")
    dist.barrier()  # rank 0's files are complete
    mesh12 = Mesh((1, 2), ("data", "model"))
    like = init_train_state(init_lm(0, cfg, device="cpu"), tx, scfg)
    restored, _, st = CheckpointManager(payload["ckpt_step"]).restore(
        like, mesh=mesh12, rules=make_rules(mesh12, "dp_tp"))
    out["restored"] = {"step": st, "params": restored.params, "index": mesh12.coords["model"]}
    # compressed all-reduce: rank r holds row r of the gradients
    g = torch.from_numpy(payload["grads"][rank])
    st = CompressionState(err={"w": torch.zeros_like(g)})
    rounds = []
    for _ in range(payload["rounds"]):
        mean, st = compressed_psum_int8({"w": g}, st, mesh.group("data"))
        rounds.append((mean["w"].clone(), st.err["w"].clone()))
    out["compressed"] = rounds
    return out
