"""Times gloo collectives on CUDA tensors between two ranks that share one
card, the way ``repro_torch.distributed.collectives`` stages them (and,
``parent_*``, the all-gather and reduce-scatter as the port first staged
them: received into pageable memory and joined on the host), beside the
parts of that time: the device-to-host copy into a pinned buffer
allocated for the call, into a pinned buffer allocated once, and into
pageable memory; gloo's own time on host tensors; the copy back.  Prints
one JSON line per size from rank 0 and the card's name and power limit.

    PYTHONPATH=src python scripts/gloo_staging_bench.py --sizes-mb 8 256 1024

Needs a CUDA card (both ranks use card 0)."""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _t(fn, reps):
    """Seconds of each of ``reps`` calls (the card synchronized around each)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def _parent_all_gather(x, group, dim):
    """The all-gather as first staged: pageable parts, joined on the host."""
    from repro_torch.distributed.collectives import _from_wire, _to_wire

    w = _to_wire(x, True)
    parts = [torch.empty_like(w) for _ in range(2)]
    dist.all_gather(parts, w, group=group)
    return _from_wire(torch.cat(parts, dim=dim), x)


def _parent_reduce_scatter(x, group, dim):
    """The reduce-scatter as first staged: cut on the host."""
    from repro_torch.distributed.collectives import _from_wire, _to_wire

    w = _to_wire(x, True)
    parts = [p.contiguous() for p in w.chunk(2, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return _from_wire(out, x)


def _rank(rank, port, sizes, reps, q):
    from repro_torch.distributed import collectives as C

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    rows = []
    for mb in sizes:
        n = mb * (1 << 20) // 4
        x = torch.randn(n, device=dev)
        host = torch.empty(n)
        pinned = torch.empty(n, pin_memory=True)
        row = {"mb": mb}
        row["d2h_pinned_new_s"] = _t(lambda: torch.empty(n, pin_memory=True).copy_(x), reps)
        row["d2h_pinned_reused_s"] = _t(lambda: pinned.copy_(x), reps)
        row["d2h_pageable_s"] = _t(lambda: host.copy_(x), reps)
        row["h2d_from_pinned_s"] = _t(lambda: x.copy_(pinned), reps)
        row["h2d_from_pageable_s"] = _t(lambda: x.copy_(host), reps)
        dist.barrier()
        row["gloo_all_reduce_host_s"] = _t(lambda: dist.all_reduce(host), reps)
        parts = [torch.empty(n) for _ in range(2)]
        dist.barrier()
        row["gloo_all_gather_host_s"] = _t(lambda: dist.all_gather(parts, host), reps)
        half = torch.empty(n // 2)
        dist.barrier()
        row["gloo_reduce_scatter_host_s"] = _t(
            lambda: dist.reduce_scatter(half, list(host.chunk(2))), reps)
        group = dist.new_group([0, 1])
        dist.barrier()
        row["port_all_reduce_s"] = _t(lambda: C.all_reduce(x, group), reps)
        dist.barrier()
        row["port_all_gather_s"] = _t(lambda: C.all_gather(x, group, dim=0), reps)
        dist.barrier()
        row["port_reduce_scatter_s"] = _t(lambda: C.reduce_scatter(x, group, dim=0), reps)
        x2 = x.view(1024, -1)  # FSDP joins an embedding's columns: dim 1
        for name, fn in (("all_gather", C.all_gather), ("parent_all_gather", _parent_all_gather),
                         ("reduce_scatter", C.reduce_scatter),
                         ("parent_reduce_scatter", _parent_reduce_scatter)):
            dist.barrier()
            row[f"{name}_dim1_s"] = _t(lambda: fn(x2, group, 1), reps)
        rows.append(row)
        del x, x2, host, pinned, parts, half
        torch.cuda.empty_cache()
    if rank == 0:
        q.put(rows)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes-mb", type=int, nargs="+", default=[8, 256, 1024])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, args.sizes_mb, args.reps, q))
             for r in range(2)]
    for p in procs:
        p.start()
    rows = q.get(timeout=900)
    for p in procs:
        p.join(60)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"card": smi, "torch": torch.__version__, "pid": os.getpid()}))


if __name__ == "__main__":
    main()
