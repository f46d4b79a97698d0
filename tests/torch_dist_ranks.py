"""Rank side of the port's multi-process CPU tests (not collected: no
``test_`` prefix; ``test_torch_sharded_serve.py``,
``test_torch_distributed.py`` and ``test_torch_tp_train.py`` import it).

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
        if dist.is_initialized():  # (a launcher's main leaves the group itself)
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
            "plan": {k: getattr(eng.tp, k) for k in ("attn", "mlp", "embed", "head", "ep",
                                                      "ssd")},
            "ep_moe": bool(eng.capabilities()["ep_moe"]),
            "pools": pools,
            "scales": scales,
            "block_tables": sched._block_tables.clone(),
            "paged_pool_bytes": sched.paged_pool_bytes(),
            "pool_bytes": pool_bytes_per_device(eng, sched.block_size, n_blocks),
            "local_heads": (eng.cfg.n_heads, eng.cfg.n_kv_heads),
            "local_ssm_heads": eng.cfg.ssm_heads,
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


# ---------------------------------------------------------------------------
# tensor-parallel and FSDP training
# ---------------------------------------------------------------------------
def _tp_run(job, route):
    """``job``'s steps on its mesh from the bridged whole params: per step
    metrics, and this rank's params, momentum, f and specs after."""
    from repro_torch import core, optim
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import dispatch
    from repro_torch.nn.sharding import Mesh
    from repro_torch.nn.tree import flatten_with_paths
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.sharding import shard_train_state, train_layout

    cfg = job["cfg"]
    mesh = Mesh(job["mesh"], ("data", "model"))
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    scfg = core.SymogConfig(n_bits=2, total_steps=10, lambda0=job["lam"])
    dispatch.set_update_backend(route)
    try:
        whole = init_train_state(params_from_numpy(job["params"]), tx, scfg)
        layout = train_layout(cfg, mesh)
        state = shard_train_state(whole, layout)
        if job.get("ckpt") and route == "fused":  # the initial state, from every rank
            CheckpointManager(job["ckpt"] + "_init").save(0, state, blocking=True, mesh=mesh,
                                                          spec_fn=layout.spec_fn)
        step = make_train_step(cfg, tx, lambda s: 0.01, symog_cfg=scfg,
                               compute_dtype=torch.float32, mesh=mesh)
        metrics = []
        for b in job["batches"]:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        dispatch.set_update_backend("auto")
    return mesh, layout, state, {
        "metrics": metrics, "params": state.params, "momentum": state.opt_state[1],
        "f": state.symog.f, "coords": dict(mesh.coords), "specs": dict(layout.specs),
        "plan": {k: getattr(layout.plan, k) for k in ("attn", "mlp", "embed", "head", "ep")},
        "fsdp": dict(layout.plan.fsdp or {}),
        "f_specs": {p: layout.spec_fn(f"symog/0/{p}", tuple(f.shape))
                    for p, f in flatten_with_paths(state.symog.f)},
    }


def tp_train_jobs(rank, world, payload):
    """Each job: 2 steps on a (d, m) mesh, fused and composed.  Then, on
    world 2: the vocab-parallel cross entropy, a checkpoint of a (1, 2)
    state, and the launcher at --mesh 1x2 (last: it leaves the group); on
    world 4: a restore of that checkpoint onto (2, 2)."""
    from repro_torch.checkpoint import CheckpointManager

    out = {}
    for job in payload["jobs"]:
        for route in job["routes"]:
            mesh, layout, state, res = _tp_run(job, route)
            out[(job["name"], route)] = res
            if job.get("ckpt") and route == "fused":  # the stepped state
                CheckpointManager(job["ckpt"]).save(2, state, blocking=True, mesh=mesh,
                                                    spec_fn=layout.spec_fn)
    if "ce" in payload:
        out["ce"] = _vocab_parallel_ce(payload["ce"])
    if "remat" in payload:
        out["remat"] = _remat_backward_elsewhere(payload["remat"])
    if "restore" in payload:
        out["restore"] = _restore_onto(payload["restore"])
    if "launch" in payload:
        import contextlib
        import io

        from repro_torch.launch import train as launch

        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world))
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res = launch.main(payload["launch"])
        out["launch"] = {"losses": res["losses"], "clip_scales": res["clip_scales"],
                         "text": text.getvalue()}
    return out


def _vocab_parallel_ce(p):
    """The vocab-parallel cross entropy on this rank's vocab slice of the
    logits, and the gathered form under the same plan: losses and the grads
    of this rank's slice."""
    from repro_torch.models.layers import TPPlan, gather_vocab, set_tp
    from repro_torch.models.lm import cross_entropy, vocab_parallel_cross_entropy
    from repro_torch.nn.sharding import Mesh

    mesh = Mesh((1, 2), ("data", "model"))
    i = mesh.coords["model"]
    plan = TPPlan(mesh=mesh, group=mesh.group("model"), size=2, index=i, head=True)
    z = torch.from_numpy(p["logits"])
    v = z.shape[-1] // 2
    labels, mask = torch.from_numpy(p["labels"]), torch.from_numpy(p["mask"])
    res = {}
    prev = set_tp(plan)
    try:
        for name, fn in (("parallel", vocab_parallel_cross_entropy),
                         ("gathered", lambda x, y, m: cross_entropy(gather_vocab(x), y, m))):
            for masked in (False, True):
                local = z[..., i * v:(i + 1) * v].clone().requires_grad_(True)
                loss = fn(local, labels, mask if masked else None)
                loss.backward()
                res[(name, masked)] = (float(loss), local.grad)
    finally:
        set_tp(prev)
    res["index"] = i
    return res


def _remat_backward_elsewhere(p):
    """The loss's grads under remat with the backward run outside the plan
    and the mesh — on another thread, as the card's autograd engine runs
    it, and on this one after leaving them — against the backward run
    inside them: a layer's recompute must re-enter both."""
    import threading

    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.layers import set_tp
    from repro_torch.models.lm import lm_train_loss
    from repro_torch.nn.sharding import Mesh
    from repro_torch.nn.tree import tree_leaves, tree_map
    from repro_torch.train.sharding import shard_train_state, train_layout

    mesh = Mesh((1, 2), ("data", "model"))
    layout = train_layout(p["cfg"], mesh)
    params = shard_train_state(params_from_numpy(p["params"]), layout)
    batch = {k: torch.as_tensor(v) for k, v in p.get("batch", {"tokens": p.get("tokens")}).items()}
    out = {}
    for where in ("inside", "this_thread", "other_thread"):
        live = tree_map(lambda w: w.detach().requires_grad_(True), params)
        box = {}

        def backward():
            try:
                box["grads"] = torch.autograd.grad(box["loss"], tree_leaves(live))
            except Exception as e:  # reported, not raised: the peer rank waits on it
                box["error"] = repr(e)

        prev = set_tp(layout.plan)
        try:
            with mesh:
                box["loss"], _ = lm_train_loss(live, batch, layout.cfg,
                                               compute_dtype=torch.float32)
                if where == "inside":
                    backward()
        finally:
            set_tp(prev)
        if where == "this_thread":
            backward()
        elif where == "other_thread":
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        out[where] = box.get("error") or box["grads"]
    return out


def _restore_onto(p):
    """A checkpoint written from (1, 2) restored onto ``p['mesh']``'s pieces."""
    from repro_torch import core, optim
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.nn.sharding import Mesh
    from repro_torch.train import init_train_state
    from repro_torch.train.sharding import train_layout

    cfg = p["cfg"]
    mesh = Mesh(p["mesh"], ("data", "model"))
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9, nesterov=True))
    like = init_train_state(params_from_numpy(p["params"]), tx,
                            core.SymogConfig(n_bits=2, total_steps=10))
    layout = train_layout(cfg, mesh)
    state, _, step = CheckpointManager(p["ckpt"]).restore(
        like, mesh=mesh, rules=layout.rules, spec_fn=layout.spec_fn)
    return {"step": step, "params": state.params, "momentum": state.opt_state[1],
            "coords": dict(mesh.coords), "specs": dict(layout.specs)}


# ---------------------------------------------------------------------------
# the tensor-parallel forms of mamba2, recurrentgemma, whisper and paligemma
# ---------------------------------------------------------------------------
def static_logits(eng, batch, steps: int):
    """The greedy static loop's tokens and its final decode step's logits
    (``ServeEngine.generate_static`` with the logits kept)."""
    from repro_torch.models.lm import image_prefix_len
    from repro_torch.serve.engine import _greedy

    batch = eng._tokens(batch)
    T = batch["tokens"].shape[1]
    logits, caches = eng.prefill(batch)
    cur = _greedy(logits[:, -1:])
    out = [cur]
    for i in range(steps - 1):
        logits, caches = eng.decode(caches, cur, image_prefix_len(eng.cfg) + T + i)
        cur = _greedy(logits[:, -1:])
        out.append(cur)
    return torch.cat(out, dim=1), logits[:, -1]


def family_serve(job, mesh=None):
    """``job``'s greedy serve (each request with its frames / patches) and
    static loop on ``mesh`` (None: one rank), and what the engine placed:
    the scheduler's pool leaves by name, shapes and bytes."""
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    eng = ServeEngine(job["cfg"], job["params"], max_len=job["max_len"],
                      compute_dtype=torch.float32, device="cpu", mesh=mesh)
    reqs = [Request(tokens=np.asarray(t), max_new_tokens=b, extras=e)
            for t, b, e in job["requests"]]
    comps, sched = eng.serve(reqs, ServeConfig(n_slots=2, temperature=0.0),
                             return_scheduler=True)
    static, logits = static_logits(eng, job["batch"], job["steps"])
    leaves = {f"{g}/{s}/{n}": tuple(leaf.shape) for g, sub in sched.caches.items()
              for s, c in sub.items() for n, leaf in c.items()}
    tp = eng.tp
    return {
        "tokens": [list(map(int, c.tokens)) for c in comps],
        "static": static, "logits": logits,
        "plan": {k: getattr(tp, k) for k in ("attn", "mlp", "embed", "head", "ssd", "rglru")}
        if tp is not None else {},
        "whole": {k: sorted(v) for k, v in (tp.whole or {}).items()} if tp is not None else {},
        "leaves": leaves,
        "cache_bytes": sched.cache_bytes(), "paged_pool_bytes": sched.paged_pool_bytes(),
        "local": {k: getattr(eng.cfg, k) for k in ("n_heads", "n_kv_heads", "d_inner",
                                                    "ssm_heads", "d_rnn", "rnn_heads")},
    }


def _rejoin(port: int, rank: int, world: int) -> None:
    """Join a fresh default group after a launcher left the last one."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))


def _faulty(fault: str):
    """A context in which one trap's repair is undone: 'norm_identity_backward'
    (the gated norm's sum of squares summed with ``ReduceSum``, whose
    backward is the identity), 'norm_no_reduce' (each rank's own sum of
    squares) or 'bias_before_reduce' (a row-parallel bias added to every
    rank's partial)."""
    import contextlib

    from repro_torch.distributed import collectives
    from repro_torch.models import blocks

    @contextlib.contextmanager
    def ctx():
        saved = collectives.SumShared, blocks.split_row_bias
        if fault == "norm_identity_backward":
            collectives.SumShared = collectives.ReduceSum
        elif fault == "norm_no_reduce":
            class _Own(torch.autograd.Function):
                @staticmethod
                def forward(c, x, group):
                    return x * 2  # this rank's channels stand for all m = 2 shares

                @staticmethod
                def backward(c, g):
                    return g * 2, None

            collectives.SumShared = _Own
        elif fault == "bias_before_reduce":
            blocks.split_row_bias = lambda p, piece: (p, None)
        try:
            yield
        finally:
            collectives.SumShared, blocks.split_row_bias = saved

    return ctx()


def family_tp_jobs(rank, world, payload):
    """Serve jobs, then training jobs (2 steps, each of the job's routes), then
    one fused step under each fault of ``payload['faults']``, then the
    launchers (each leaves the group: the next joins a fresh one)."""
    import contextlib
    import io

    from repro_torch.nn.sharding import Mesh

    out = {}
    mesh = Mesh((1, 2), ("data", "model"))
    for job in payload["serve"]:
        out[("serve", job["name"])] = family_serve(job, mesh)
    for job in payload["train"]:
        for route in job["routes"]:
            _, layout, state, res = _tp_run(job, route)
            res["whole"] = {k: sorted(v) for k, v in (layout.plan.whole or {}).items()}
            out[(job["name"], route)] = res
    for name, job in payload.get("remat", {}).items():
        out[("remat", name)] = _remat_backward_elsewhere(job)
    for name, (job, fault) in payload.get("faults", {}).items():
        with _faulty(fault):
            out[("fault", name)] = _tp_run(job, "fused")[3]
    for i, (kind, argv) in enumerate(payload.get("launch", [])):
        _rejoin(payload["ports"][i], rank, world)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world))
        if kind == "serve":
            from repro_torch.launch import serve as launch

            got = []
            inner = launch.run_continuous

            def run(*a, **kw):
                comps = inner(*a, **kw)
                got.append([list(map(int, c.tokens)) for c in comps])
                return comps

            launch.run_continuous = run
            try:
                with contextlib.redirect_stdout(io.StringIO()) as text:
                    launch.main(argv)
            finally:
                launch.run_continuous = inner
            out[("launch", i)] = {"streams": got, "text": text.getvalue()}
        else:
            from repro_torch.launch import train as launch

            with contextlib.redirect_stdout(io.StringIO()) as text:
                res = launch.main(argv)
            out[("launch", i)] = {"losses": res["losses"], "clip_scales": res["clip_scales"],
                                  "text": text.getvalue()}
    return out
