"""Serving launcher of the port: batched prefill + greedy decode, float or
SYMOG-packed (the counterpart of ``repro/launch/serve.py``, same flags and
report, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch internlm2-1.8b --reduced --device cpu --batch 4 --prompt-len 32 \\
        --steps 16 [--quantized | --packed] [--n-bits 2]

Without ``--device`` it runs on the card (and refuses to start without one).

``--quantized`` serves SYMOG post-quantized weights (exact fixed-point
values in float representation) and reports the agreement of generated
tokens with the float model.  ``--packed`` serves the ``pack_tree``
artifact itself: 2/4-bit mantissas in int8 words, run by the CUDA
``fixedpoint_matmul`` kernels on the card (the exact unpack on the CPU);
it reports resident weight bytes vs float and the token agreement with
the float and the quantize_tree engines (the latter must be 100%).

``--continuous`` drives a synthetic ragged-arrival workload through the
continuous-batching scheduler on its paged KV block pool: ``--requests``
prompts with ragged budgets arriving over time, on ``--slots`` decode
rows, against the static loop that runs every batch to its slowest
member.  ``make_ragged_workload`` draws the JAX package's launcher
workload from the same seed (``launch/threefry.py``), so the two
launchers' schedules and counters agree.  All serving knobs flow through
one ``serve.ServeConfig``; ``warn_inert_flags`` reads
``engine.capabilities()`` to flag structurally inert features.

Telemetry: the report is the scheduler's metrics-registry snapshot;
``--metrics-json PATH`` writes it as JSON, ``--trace-out PATH`` turns on
step-span tracing and exports a Chrome ``trace_event`` file, and
``--profile-dir PATH`` wraps the first ``--profile-steps`` serve steps in
a ``torch.profiler`` capture (a Chrome trace with the device's kernels).

``--ckpt-dir`` restores the params from the newest checkpoint there; the
format is the JAX package's, so a checkpoint its trainer wrote serves here.

``--mesh DxM`` serves sharded on a (data, model) mesh of D·M ranks started
by ``torchrun`` (``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.serve ... --mesh DxM``; ``dxm`` sizes the model axis to
the world): every rank runs this program, holds its shard of the params and
of the paged KV pool, and serves the same requests; rank 0 prints, and the
ranks' token streams are checked equal.  NCCL joins ranks that have a card
each, gloo ranks that share one (or the CPU).  ``--moe-impl ep`` routes MoE
layers expert-parallel when the mesh's EP axes exceed 1; off a mesh they
take the capacity dispatch and ``ep_moe`` says why.
The weights are the port's own seeded init (``models.init_lm``), not the
JAX package's: the two launchers agree on the workload and the schedule,
and on the tokens only when both restore one checkpoint.  whisper's frame
and paligemma's patch embeddings (the stub frontends' outputs, N(0, 0.01))
come from a ``torch.Generator`` seeded ``--seed`` + 1, not from
``jax.random.normal``: every continuous request carries the batch's first
row of them, as in the JAX launcher.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import math
import time

import numpy as np
import torch

from repro_torch import core
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.launch import threefry
from repro_torch.launch.mesh import close_distributed, make_host_mesh, world_from_env
from repro_torch.models import init_lm
from repro_torch.models.lm import image_prefix_len
from repro_torch.serve import (
    Request,
    ServeConfig,
    ServeEngine,
    SpeculativeConfig,
    TelemetryConfig,
    latency_stats,
)

def warn_inert_flags(eng: ServeEngine, config: ServeConfig) -> None:
    """One-line warning per requested serving feature that is structurally
    inert on this architecture: the flag is accepted and serve() stays
    correct, but silently no-opping would hide a misconfiguration.  Verdicts
    and reasons come from ``engine.capabilities()``, the report the
    scheduler's own decisions read."""
    caps = eng.capabilities()
    arch = eng.cfg.name
    wanted = [
        ("--prefix-cache", config.prefix_cache, "prefix_cache",
         "every request will take the miss path"),
        ("--speculative", config.speculative is not None, "speculative",
         "every step runs the vanilla decode"),
        ("--prefill-chunk", config.prefill_chunk > 0, "chunked_prefill",
         "every admission prefills one-shot"),
    ]
    for flag, requested, cap, effect in wanted:
        if requested and not caps[cap]:
            print(f"WARNING: {flag} is structurally inert on {arch} "
                  f"({caps[cap].reason}) — {effect}")


def kv_pool_report(eng: ServeEngine, config: ServeConfig) -> None:
    """One line of capacity math for the paged KV pool: bytes per decode
    slot at the engine's KV dtype (per-block SYMOG mantissas + int32 scale
    leaves when quantized) next to the bf16 pool of the same geometry."""
    from repro_torch.models.lm import PAGED_CACHE_LEAVES, init_caches, scan_groups

    blk = config.block_size
    n_per_slot = math.ceil(eng.max_len / blk)
    qbits = eng.kv_quant_bits
    # the whole model's pool (a sharded engine's own is its shard of it)
    specs = init_caches(eng.global_cfg, 1, eng.max_len, eng.compute_dtype, device="meta",
                        prefill=True)
    quant = bf16 = 0
    for g in scan_groups(eng.global_cfg):
        axis = 1 if g.stacked else 0
        for j, paged in enumerate(g.paged):
            for name, sd in specs[g.name][f"sub{j}"].items():
                if not (paged and name in PAGED_CACHE_LEAVES):
                    continue
                stack = sd.shape[0] if g.stacked else 1
                feat = int(np.prod(sd.shape[axis + 2:]))
                width = sd.shape[-1]
                bf16 += stack * n_per_slot * blk * feat * 2
                if qbits:
                    quant += stack * n_per_slot * (blk * feat * qbits // 8 + (feat // width) * 4)
                else:
                    quant += stack * n_per_slot * blk * feat * sd.dtype.itemsize
    if not bf16:
        return
    print(f"  kv pool: {quant} bytes/slot (kv_bits={qbits or 16}, "
          f"block={blk}) vs {bf16} at bf16 — "
          f"{bf16 / quant:.1f}x the dense-bf16 slot capacity on the same "
          f"HBM budget")
    if eng.model_shards() > 1:
        from repro_torch.serve.sharding import pool_bytes_per_device

        total, per_dev = pool_bytes_per_device(eng, blk, n_per_slot)
        print(f"  sharded pool: {per_dev} of {total} bytes/slot resident per "
              f"device ({total / per_dev:.1f}x capacity at {eng.model_shards()} "
              "model shards; scale leaves and block tables replicated)")


def make_ragged_workload(cfg, *, n_requests: int, prompt_len: int, steps: int, seed: int,
                         batch_extras=None, system_len: int = 0):
    """Synthetic ragged-arrival workload: uniform prompt length (so the
    static baseline can batch them), ragged generation budgets in
    [2, steps], arrivals spread over time in decode-step units — the JAX
    package's launcher workload for the same seed, request for request.

    ``batch_extras`` (whisper's frames, paligemma's patches: (B, ...)
    arrays): every request carries their first row.  ``system_len`` > 0
    prepends ONE shared random system prompt to every request (total
    prompt = system_len + prompt_len): the shape where the --prefix-cache
    radix index turns refcounts into capacity."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.integers(0, 3, size=n_requests))
    key = threefry.prng_key(seed + 2)
    system = threefry.randint(threefry.fold_in(key, 10_000), (system_len,), 0, cfg.vocab_size)
    reqs = []
    for i in range(n_requests):
        toks = threefry.randint(threefry.fold_in(key, i), (prompt_len,), 0, cfg.vocab_size)
        if system_len:
            toks = np.concatenate([system, toks])
        extras = None
        if batch_extras is not None:
            extras = {k: np.asarray(v[:1]) for k, v in batch_extras.items()}
        reqs.append(Request(tokens=toks, max_new_tokens=int(rng.integers(2, steps + 1)),
                            arrival=int(arrivals[i]), extras=extras))
    return reqs


def _suffixed(path: str, tag: str) -> str:
    """``out.json`` + ``packed`` -> ``out.packed.json``: the second engine's
    artifacts must not overwrite the float run's."""
    if not path:
        return ""
    root, dot, ext = path.rpartition(".")
    return f"{root}.{tag}.{ext}" if dot else f"{path}.{tag}"


def run_continuous(eng: ServeEngine, reqs, config: ServeConfig, *, label: str,
                   metrics_json: str = "", trace_out: str = ""):
    useful = sum(r.max_new_tokens for r in reqs)
    # warm up with the SAME sampling config but default telemetry, so the
    # warmup neither spends the --profile-dir window nor leaves first-call
    # (kernel build) spans in the exported trace
    eng.serve(reqs[:1], dataclasses.replace(config, telemetry=TelemetryConfig()))
    _sync(eng)
    t0 = time.time()
    comps, sched = eng.serve(reqs, config, return_scheduler=True)
    _sync(eng)
    dt = time.time() - t0
    # static loop: batches of n_slots in arrival order, each run to the max
    # budget in the batch (finished rows burn decode steps)
    slots = config.resolve(eng, reqs).n_slots
    static_steps = 0
    for lo in range(0, len(reqs), slots):
        static_steps += max(r.max_new_tokens for r in reqs[lo: lo + slots])
    print(f"continuous ({label}): {len(comps)} requests, {useful} useful tokens "
          f"in {dt:.2f}s ({useful / dt:.1f} tok/s), "
          f"{sched.stats['decode_steps']} ragged decode steps "
          f"(+{sched.stats['idle_steps']} idle) vs {static_steps} static; "
          f"reasons={ {c.finish_reason for c in comps} }")
    for line in sched.registry.render_text():
        print(f"  {line}")
    mon = sched.monitor
    if mon.count:
        print(f"  step time: ewma {mon.ewma * 1e3:.1f} ms over {mon.count} observed "
              f"steps, straggler fraction {mon.straggler_fraction():.2%} "
              f"(steps > {mon.threshold:.1f}x ewma after {mon.warmup}-step warmup)")
    lat = latency_stats(comps)
    if lat:
        q, t, tp = lat["queue_steps"], lat["ttft_steps"], lat["tokens_per_step"]
        print(f"  latency (decode-step units): queue p50={q['p50']:.1f} "
              f"p99={q['p99']:.1f}; ttft p50={t['p50']:.1f} p99={t['p99']:.1f}; "
              f"tokens/step p50={tp['p50']:.2f} p99={tp['p99']:.2f}")
        if "accepted_per_step" in lat:
            a = lat["accepted_per_step"]
            print(f"  accepted tokens/verify-step: p50={a['p50']:.2f} "
                  f"p99={a['p99']:.2f} mean={a['mean']:.2f}")
    if metrics_json:
        with open(metrics_json, "w") as f:
            f.write(sched.registry.to_json(label=label, requests=len(reqs),
                                           wall_s=round(dt, 4)))
        print(f"  metrics json -> {metrics_json}")
    if trace_out and sched.tracer.enabled:
        sched.tracer.export_chrome(trace_out)
        print(f"  chrome trace -> {trace_out} ({len(sched.tracer)} events, "
              f"{sched.tracer.dropped} dropped; load in Perfetto or chrome://tracing)")
    if sched._profile is not None and sched._profile.trace_path:
        print(f"  profiler trace -> {sched._profile.trace_path}")
    return comps


def _agreement(a, b) -> float:
    """Share of equal tokens over two completion lists, position by position."""
    pairs = [(x, y) for ca, cb in zip(a, b) for x, y in zip(ca.tokens, cb.tokens)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


def _sync(eng: ServeEngine) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Serve a SYMOG artifact with the port.")
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card; 'cpu' on request)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="serve the pack_tree int8-word artifact end to end")
    ap.add_argument("--n-bits", type=int, default=2)
    ap.add_argument("--kv-bits", type=int, default=16, choices=(16, 8, 4),
                    help="KV cache wordlength: 8/4 select the per-block SYMOG "
                         "fixed-point paged pools; 16 keeps bf16")
    ap.add_argument("--continuous", action="store_true",
                    help="ragged-arrival workload through the continuous-"
                         "batching scheduler vs the static loop")
    ap.add_argument("--requests", type=int, default=16,
                    help="--continuous: number of synthetic requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="--continuous: decode slot-table size")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="--continuous: sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="--continuous: top-k sampling cutoff (0 = off)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="--continuous: automatic prefix caching over the "
                         "paged pool (fully-paged archs only)")
    ap.add_argument("--system-prompt-len", type=int, default=0,
                    help="--continuous: prepend one shared system prompt of "
                         "this many tokens to every request")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="--continuous: split admission prefills into chunks "
                         "of at most this many tokens, one per step beside "
                         "live decode (fully-paged archs only; 0 = one-shot)")
    ap.add_argument("--speculative", action="store_true",
                    help="--continuous: self-speculative decoding — draft "
                         "with the --draft-bits pack_tree twin, verify K+1 "
                         "positions per step on the served params")
    ap.add_argument("--draft-bits", type=int, default=2,
                    help="--speculative: bit-width of the packed draft artifact")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="--speculative: max draft tokens per verify round")
    ap.add_argument("--mesh", default="",
                    help="serve sharded on a DxM (data, model) mesh of D·M torchrun "
                         "ranks, e.g. --mesh 1x2: params and the paged KV pool shard "
                         "over 'model' per the nn/sharding rules; 'dxm' sizes the "
                         "model axis to the world")
    ap.add_argument("--moe-impl", default="", choices=("dispatch", "ep"),
                    help="override cfg.moe_impl: 'ep' routes MoE layers expert-"
                         "parallel by all-to-all (needs --mesh whose EP axes exceed "
                         "1; the capacity dispatch otherwise). No-op on dense archs")
    ap.add_argument("--metrics-json", default="",
                    help="--continuous: write the metrics-registry snapshot "
                         "(counters/gauges/histograms) as JSON to this path")
    ap.add_argument("--trace-out", default="",
                    help="--continuous: enable step-span tracing and write a "
                         "Chrome trace_event JSON to this path")
    ap.add_argument("--trace-capacity", type=int, default=4096,
                    help="span-ring capacity for --trace-out (oldest records "
                         "drop first; also bounds the scheduler event logs)")
    ap.add_argument("--profile-dir", default="",
                    help="--continuous: capture a torch.profiler Chrome trace "
                         "of the first --profile-steps serve steps into this dir")
    ap.add_argument("--profile-steps", type=int, default=8,
                    help="--profile-dir: serve steps inside the capture window")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _parse_mesh(ap, spec: str, world: int):
    if spec == "dxm":
        d, m = 1, world
    else:
        try:
            d, m = (int(v) for v in spec.lower().split("x"))
        except ValueError:
            ap.error(f"--mesh must be DxM (e.g. 2x4) or 'dxm', got {spec!r}")
    if d * m != world:
        ap.error(f"--mesh {d}x{m} needs {d * m} devices, have {world}")
    return d, m


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.speculative and args.prefix_cache:
        ap.error("--speculative and --prefix-cache are mutually exclusive")
    rank, world, _, _ = world_from_env()
    mesh = None
    if args.mesh:
        d, m = _parse_mesh(ap, args.mesh, world)
        mesh = make_host_mesh((d, m), device=args.device)
    elif world > 1:
        ap.error(f"{world} ranks need --mesh (DxM with D·M = {world})")
    # every rank runs the program; rank 0 alone prints
    out = contextlib.nullcontext() if rank == 0 else contextlib.redirect_stdout(io.StringIO())
    with out:
        _serve(args, mesh)
    if mesh is not None:
        close_distributed()


def _streams_equal(mesh, comps) -> bool:
    """Whether every rank produced the same token streams (SPMD)."""
    import torch.distributed as dist

    mine = [list(c.tokens) for c in comps]
    if mesh is None or mesh.size == 1:
        return True
    every = [None] * mesh.size
    dist.all_gather_object(every, mine)
    return all(e == every[0] for e in every)


def _serve(args, mesh) -> None:
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    if args.kv_bits != 16:
        cfg = dataclasses.replace(cfg, kv_cache_dtype={8: "int8_fp", 4: "int4_fp"}[args.kv_bits])
    dev = resolve_device(args.device)
    if mesh is not None:
        print(f"mesh: {mesh.shape['data']} data x {mesh.shape['model']} model over "
              f"{mesh.size} {dev.type} ranks ({mesh.backend or 'one process'})")
    params = init_lm(args.seed, cfg, device=dev)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        params, _, step = mgr.restore(params, device=dev)
        print(f"restored checkpoint step {step}")

    key = threefry.prng_key(args.seed + 1)
    batch = {"tokens": threefry.randint(key, (args.batch, args.prompt_len), 0, cfg.vocab_size)}
    gen = torch.Generator().manual_seed(args.seed + 1)
    stub = {"encdec": ("frames", cfg.encoder_len), "vlm": ("patches", cfg.prefix_len)}
    if cfg.family in stub:
        name, n = stub[cfg.family]
        batch[name] = (torch.randn((args.batch, n, cfg.d_model), generator=gen) * 0.1).numpy()

    max_len = args.prompt_len + args.steps + args.system_prompt_len + image_prefix_len(cfg)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    eng = ServeEngine(cfg, params, max_len=max_len, compute_dtype=dtype, device=dev, mesh=mesh)
    if mesh is not None:
        ep = eng.capabilities()["ep_moe"]
        print(f"  sharded: profile '{eng.sharding_profile or cfg.sharding_profile}', "
              f"{eng.model_shards()} model shards; ep_moe: "
              f"{'on' if ep else 'off (' + ep.reason + ')'}")
    elif args.moe_impl == "ep" and cfg.moe:
        print(f"  ep_moe: off ({eng.capabilities()['ep_moe'].reason}) — MoE layers take "
              "the capacity dispatch")

    if args.continuous:
        spec = None
        if args.speculative:
            # the free cheap twin: the SAME weights packed at --draft-bits
            dcfg = core.SymogConfig(n_bits=args.draft_bits, total_steps=1)
            draft = core.pack_tree(params, core.symog_init(params, dcfg), dcfg)
            spec = SpeculativeConfig(draft=draft, k=args.draft_k)
        tele = TelemetryConfig(trace=bool(args.trace_out), trace_capacity=args.trace_capacity,
                               profile_dir=args.profile_dir, profile_steps=args.profile_steps)
        serve_cfg = ServeConfig(n_slots=args.slots, temperature=args.temperature,
                                top_k=args.top_k, seed=args.seed,
                                prefix_cache=args.prefix_cache, speculative=spec,
                                prefill_chunk=args.prefill_chunk, telemetry=tele)
        warn_inert_flags(eng, serve_cfg)
        kv_pool_report(eng, serve_cfg)
        extras = {k: v for k, v in batch.items() if k != "tokens"} or None
        reqs = make_ragged_workload(cfg, n_requests=args.requests, prompt_len=args.prompt_len,
                                    steps=args.steps, seed=args.seed, batch_extras=extras,
                                    system_len=args.system_prompt_len)
        comps = run_continuous(eng, reqs, serve_cfg, label="float",
                               metrics_json=args.metrics_json, trace_out=args.trace_out)
        same = _streams_equal(mesh, comps)
        if args.quantized or args.packed:
            scfg = core.SymogConfig(n_bits=args.n_bits, total_steps=1)
            sst = core.symog_init(params, scfg)
            qt = core.quantize_tree(params, sst, scfg)
            if args.packed:
                qeng = ServeEngine.from_symog(cfg, params, sst, scfg, max_len=max_len,
                                              compute_dtype=dtype, device=dev, mesh=mesh)
                label = f"packed {args.n_bits}-bit"
            else:
                qeng = ServeEngine(cfg, qt, max_len=max_len, compute_dtype=dtype, device=dev,
                                   mesh=mesh)
                label = f"quantized {args.n_bits}-bit"
            del params
            qcomps = run_continuous(qeng, reqs, serve_cfg, label=label,
                                    metrics_json=_suffixed(args.metrics_json, label.split()[0]),
                                    trace_out=_suffixed(args.trace_out, label.split()[0]))
            same = same and _streams_equal(mesh, qcomps)
            if args.packed:
                del qeng
                ceng = ServeEngine(cfg, qt, max_len=max_len, compute_dtype=dtype, device=dev,
                                   mesh=mesh)
                # default telemetry: no trace, metrics or profiler window of its own
                ref = ceng.serve(reqs, dataclasses.replace(serve_cfg, telemetry=TelemetryConfig()))
                exact = _agreement(qcomps, ref)
                print(f"continuous packed vs quantized token agreement: {exact:.2%}; "
                      f"vs float: {_agreement(qcomps, comps):.2%}")
        if mesh is not None:
            print(f"ranks' token streams equal: {same}")
            if not same:
                raise SystemExit("the ranks' token streams differ")
        return

    t0 = time.time()
    out_float = eng.generate(batch, args.steps)
    dt = time.time() - t0
    print(f"float generation: {tuple(out_float.shape)} in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s)")

    if args.quantized or args.packed:
        scfg = core.SymogConfig(n_bits=args.n_bits, total_steps=1)
        sst = core.symog_init(params, scfg)
        qparams = core.quantize_tree(params, sst, scfg)
        qeng = ServeEngine(cfg, qparams, max_len=max_len, compute_dtype=dtype, device=dev,
                           mesh=mesh)
        out_q = qeng.generate(batch, args.steps)
        agree = float(np.mean(out_q.numpy() == out_float.numpy()))
        qm = core.quant_error_metrics(params, sst, scfg)
        print(f"quantized ({args.n_bits}-bit) agreement with float: {agree:.2%} "
              f"(rel quant err {float(qm['rel_quant_error']):.3f} — "
              "train with SYMOG to drive this to ~0)")

    if args.packed:
        peng = ServeEngine.from_symog(cfg, params, sst, scfg, max_len=max_len,
                                      compute_dtype=dtype, device=dev, mesh=mesh)
        t0 = time.time()
        out_p = peng.generate(batch, args.steps)
        dt = time.time() - t0
        exact = float(np.mean(out_p.numpy() == out_q.numpy()))
        agree_f = float(np.mean(out_p.numpy() == out_float.numpy()))
        fb = eng.weight_bytes()
        print(f"packed ({args.n_bits}-bit) serving: {peng.weight_bytes()} weight bytes "
              f"vs {fb} float ({fb / peng.weight_bytes():.1f}x smaller), "
              f"{args.batch * args.steps / dt:.1f} tok/s")
        print(f"packed vs quantized token agreement: {exact:.2%} (must be 100%); "
              f"vs float: {agree_f:.2%}")


if __name__ == "__main__":
    main()
