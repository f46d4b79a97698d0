#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, one JSON line each:
  1. device  — card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build   — nvcc builds every kernel source under src/repro_torch/csrc;
  3. kernels — each hand-written kernel against its plain torch version at the
               shapes its path gives it, with kernel / plain / library times
               (CUDA events; the serving kernels in CUDA graphs of many
               launches with operands rotated past the 50 MB L2) and the
               bound from bytes and operations: 3a fixedpoint_matmul at
               internlm2's 7 projections (M 4 in bf16 and fp32, M 128 in
               fp32, the prefill buckets M 32..512 in bf16), 3b
               paged_attention (and, timed only, its internlm2 decode
               shape at rows of about 64, 300 and 500 cached tokens), 3c
               symog_update on every quantizable leaf
               shape of internlm2-1.8b plus an odd n, half-step ties, the
               clip and a misaligned operand, 3d fixedpoint_matmul_experts
               on olmoe-1b-7b's expert stacks (64 experts, one f each, C = 4
               and 80 in bf16 and fp32, the prefill capacities C = 5, 20, 80
               in bf16, 2 and 4 bits) and fixedpoint_matmul at olmoe's
               packed head (M 4, K 2048, N 50304, fp32); both again at
               deepseek-v3's shapes, 2-bit: every 2-D projection of its path
               (the MLA layer's, the dense MLP, the shared expert, the
               129,280-row head; M 4 and 128 in bf16 and fp32, M 512 in bf16)
               and one MoE layer's three 256-expert stacks (C 4 in bf16 and
               fp32, C 2, 10, 20 in bf16); every bf16 case holds its rule's
               kernel (forced: the decode kernel up to 8 rows, the tensor
               cores above) to the plain version, bit-identical over two
               calls, and times it beside the streaming kernel; the bf16
               C = 4 stacks take ``rows`` from a top-8 routing of 4 random
               tokens (the occupied count, the bound at occupied bytes and
               at every expert's, and the same kernel reading every expert,
               which must give the same bits); 3g the three kernels at
               2..16 rows (internlm2's gate_proj, olmoe's gate stack): the
               route rule must not sit on the wrong side of a measured
               crossover; fixedpoint_matmul again at gemma3-4b's 7
               projections (M 4 and 512) and its 262,144-row head as a
               packed (2560, 262144) matrix (M 4); 3b also at the dense
               configs' decode shapes (gemma3's head_dim 256 under its
               1,024 window, granite's K 1 G 48, gemma2's softcap 50 under
               its 4,096 window), every case bit-identical over two calls;
               3e
               paged attention over int8 and int4 SYMOG pools (olmoe's and
               internlm2's decode shapes, exponents over [-8, 4], a window
               + softcap case, an fp32 case; timed only, olmoe's int4 decode
               shape at rows of about 64, 300 and 500 cached tokens; the
               tail-prefill launches of gemma3's admission, B 1, T 32, 512
               and 2048 from position 0 and T 512 from 1000, int4), 3f
               the absorbed MLA decode (``paged_attention_mla``) at
               deepseek-v3's shape (128 heads, rank 512, rope 64) over bf16
               / fp32, KV_F int8 and SYMOG int8 / int4 pools (one exponent
               per block over [-8, 4]), T 1 and 3, a row at position 0:
               every bf16 case through both kernels (the tensor-core
               ``mla_decode_tc``, which the rule picks and which must be the
               faster, and ``mla_partial``), the tensor-core kernel also at
               4 and 8 ranks beside the rule's; fp32 cases on
               ``mla_partial``; and an fp64 conditioning check;
  4. parity  — internlm2-1.8b, gemma2-27b, granite-34b and olmoe-1b-7b at
               full width, 4 layers (gemma3-4b 6, from an int4 pool through
               the tail-prefill admission, its writes held array_equal to
               the same writes on the CPU), fp32
               compute, 2-bit packed: prefill + 4 teacher-forced paged decode
               steps through the kernels vs through the plain paths; logits
               must agree; olmoe a second time from an int4 SYMOG pool
               (quantizing admission held array_equal to the same writes on
               the CPU, quantized decode writes, the quantized kernel vs
               ``_paged_read``, packed matmuls through the kernels on both
               routes so that both write the same words; the SYMOG
               exponents and words written on the card array_equal to the
               CPU's where the exponent steps); deepseek-v3 (3
               dense + 1 MoE layer, 256 experts, built layer by layer) from a
               bf16 and from an int4 MLA pool, the matmuls through the
               kernels on both routes (MLA's fp32 queries on
               ``mla_partial``), argmax agreement 1.0; the two pools'
               logits compared row by row (top-1 - top-2 margin beside the
               largest logit gap, the int4 pool's c_kv / k_rope error);
  5. serve   — internlm2-1.8b at full width, all 24 layers, 2-bit
               ``ServeEngine.from_symog``, bf16, 4 slots, 8 requests of
               24..400 prompt tokens and 32 new tokens each through the
               continuous-batching scheduler; each admission (bucketed
               prefill) and decode step timed; every kernel's launch count,
               split by matmul route, must equal the count the path implies;
  6. profile — a few decode steps of that engine under cProfile (host
               functions) and torch.profiler (device busy time, top kernels,
               the matmul kernels' device time by route and form);
  7. train   — SYMOG training of internlm2-1.8b at full width and all 24
               layers (fp32 master weights, bf16 compute, 4 x 512 tokens):
               the Δ search, step 1's fused update against the composed one
               leaf by leaf, 6 steps through ``make_train_step`` on the fused
               route (8 symog_update launches per step), then the trained
               weights packed and served;
  8. olmoe   — olmoe-1b-7b at full width and all 16 layers, 2-bit packed
               with one Δ per expert (``symog_init`` timed), served as in
               phase 5 (same traffic and checks) from an int4 SYMOG KV pool;
               the same requests again must give identical tokens; a bf16
               pool's greedy agreement is printed; then its decode profile;
  9. deepseek — deepseek-v3 at full width, 7 layers (its 3 dense layers and
               4 MoE layers of 256 experts top-8 + a shared expert, vocab
               129,280), 2-bit packed with one Δ per (layer, expert), built
               one layer at a time (``build_layerwise``: the fp32 tree of
               198.5 GB never exists), served as in phase 8 from an int4 MLA
               pool; the bf16-pool serve gates the float MLA kernel's
               launches (both serves: every MLA launch on the tensor-core
               kernel, one a call); then its decode profile (MLA device
               ms a step by kernel) under the parent's MLA route rule
               (every call on ``mla_partial`` + ``attn_combine``) and under
               this one, in turns (parent, this, this, parent);
 10. gemma3  — gemma3-4b at full width and all 34 layers (vocab 262,144,
               head_dim 256), 2-bit packed, served from an int4 SYMOG KV
               pool (max_len 2048, prompts of 24..1,800 tokens: buckets
               32..2048, the window binding), every admission a tail
               prefill: launch counts by route (34 tail-prefill launches an
               admission), the greedy serve repeated token-identical, the
               sampled serve (temperature 0.7, top-k 50, seed 123) identical
               again, with 3 slots and with staggered arrivals; a bf16
               pool's greedy agreement; then its decode profile.
Each serving and training path zeroes every kernel's launch count just
before it runs and reads them just after.
Then each phase's seconds and the total, the ``kernels`` summary line (the
seven kernels, the tensor-core and decode routes of both matmul forms, and
MLA's tensor-core route for float and quantized pools), the
nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.
The script imports no jax and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, no sparsity
FPMM_SHAPES = [  # internlm2-1.8b per-layer projections, K x N
    ("q_proj", 2048, 2048), ("k_proj", 2048, 1024), ("v_proj", 2048, 1024),
    ("o_proj", 2048, 2048), ("gate_proj", 2048, 8192), ("up_proj", 2048, 8192),
    ("down_proj", 8192, 2048),
]
TOL = {  # kernel vs plain version
    "float32": dict(rtol=1e-5, atol=1e-5),  # tests/test_kernels.py bar
    "bfloat16": dict(rtol=1e-2, atol=1e-2),  # one bf16 rounding of the fp32 result
}
# attention: fp32 as tests/test_paged_attention.py; bf16 is a few output ulps
# (kernel and plain version both reduce in fp32 and round to bf16 once)
ATTN_TOL = {"float32": dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
PARITY_ATOL = 1e-3  # fp32 logits, 4 layers: same math, other summation orders
# the MLA launch counts: every launch of rows 4 / 5 (float / quantized pools),
# then the tensor-core route's alone
MLA_COUNTS = ("paged_attention_mla", "paged_attention_mla_quant", "paged_attention_mla_tc",
              "paged_attention_mla_tc_quant")
PARITY_LAYERS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unavailable"


def timed(fn, args_list, torch, reps: int = 5) -> float:
    """ms per call: a CUDA graph of ``len(args_list)`` (>= 16) calls rotating
    over the operand copies, replayed ``reps`` times between CUDA events."""
    n = max(16, len(args_list))
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(*args_list[i % len(args_list)])
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * n)


def copies_for(nbytes: int) -> int:
    """Operand copies whose total exceeds the 50 MB L2 (cold reads, as in
    serving, where each layer's weights are read once per step)."""
    return max(2, min(64, math.ceil(128e6 / max(nbytes, 1))))


def bound(nbytes: int, flops: int, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3a: fixedpoint_matmul
# ---------------------------------------------------------------------------
ROUTE_KEY = {"streaming": "stream", "tensor_core": "tc", "decode": "dec"}  # row key prefixes


def _bf16_routes(dt, rows: int):
    """The routes a bf16 case forces, checks and times beside the streaming
    kernel: the decode kernel up to its row limit, else the tensor cores
    (prefill sizes); none for fp32 (streaming only)."""
    from repro_torch.kernels.fixedpoint_matmul import ops as fops

    if str(dt) != "torch.bfloat16":
        return ()
    return ("decode",) if rows <= fops.DECODE_MAX_ROWS else ("tensor_core",)


def _routes(torch, row, call, ref, route, args, slow, check):
    """A bf16 case: each route of ``check`` forced, held to the plain
    version at the bf16 bar and bit-identical over two calls; when ``args``
    are given, those routes and the streaming kernel timed (``ms`` is the
    route the rule picks; a ``slow`` streaming call is timed with CUDA events
    over single calls).  Returns False if a check failed."""
    ok = True
    for r in check:
        key = ROUTE_KEY[r]
        yt = [call(r, *args[0]) if args else call(r) for _ in range(2)]
        torch.cuda.synchronize()
        row[f"{key}_max_abs_err"] = (yt[0].float() - ref.float()).abs().max().item()
        row[f"{key}_bit_identical"] = bool(torch.equal(yt[0], yt[1]))
        ok = (ok and bool(torch.allclose(yt[0].float(), ref.float(), **TOL["bfloat16"]))
              and row[f"{key}_bit_identical"])
        del yt
    row["route"] = route
    if args:
        for r in dict.fromkeys(check + ("streaming",)):
            if r == "streaming" and slow:
                row["stream_ms"] = events_ms(lambda: call("streaming", *args[0]), 3, torch)
                row["stream_timing"] = "CUDA events, single calls"
            else:
                row[f"{ROUTE_KEY[r]}_ms"] = timed(lambda *a, r=r: call(r, *a), args, torch)
        row["ms"] = row[f"{ROUTE_KEY[route]}_ms"]
    return ok


def _fpmm_case(torch, gen, dev, name, K, N, M, dt, n_bits, *, with_bias, timing, routes=(),
               plain=True, library=True):
    """One 2-D case: Gaussian weights packed with their optimal f, x (M, K)
    of ``dt``, the kernel the route rule picks held to its plain version;
    timed (kernel, plain, ``torch.matmul`` on the dequantized weight) when
    ``timing``.  ``routes`` (bf16): those kernels forced, checked and timed
    beside the streaming one (``_routes``).  A plain version whose fp32
    unpacked weight exceeds 1 GB is timed with CUDA events over single calls
    (a graph of 16 would hold 16 sets of its temporaries)."""
    from repro_torch.core import optimal_f, unpack_int
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_ref

    dname = str(dt).split(".")[-1]
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    f, _ = optimal_f(w, n_bits)
    f = f.to(torch.int32)
    pw = fops.pack_weight(w, f, n_bits)
    del w
    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
    bias = torch.randn((N,), generator=gen, device=dev) * 0.1 if with_bias else None
    y = fops.fixedpoint_matmul(x, pw, f, bias, n_bits=n_bits, n_out=N)
    ref = fixedpoint_matmul_ref(x, pw, f, bias, n_bits=n_bits, n_out=N).to(dt)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    tol = TOL[dname]
    ok = bool(torch.allclose(y.float(), ref.float(), **tol))
    del y
    wbytes = pw.numel()
    io = x.numel() * x.element_size() + wbytes + 4 + M * N * x.element_size()
    io += 0 if bias is None else N * 4
    b_ms, b_by = bound(io, 2 * M * K * N, dname)
    row = {"phase": "kernel", "kernel": "fixedpoint_matmul", "proj": name, "M": M, "K": K,
           "N": N, "n_bits": n_bits, "dtype": dname, "bias": bias is not None,
           "route": fops._pick_route(dt, M, True), "max_abs_err": err, "tol": tol}

    def call(route, a=x, b=pw):
        return fops.fixedpoint_matmul(a, b, f, bias, n_bits=n_bits, n_out=N, _route=route)

    args = None
    if timing:
        n = copies_for(wbytes)
        args = list(zip([x.clone() for _ in range(n)], [pw.clone() for _ in range(n)]))
    if routes:
        ok = _routes(torch, row, call, ref, row["route"], args, 2 * M * K * N > 1e11,
                     routes) and ok
    del ref
    row["pass"] = ok
    if timing:
        if not routes:
            row["ms"] = timed(lambda a, b: call(None, a, b), args, torch)
        if plain and K * N * 4 > 1e9:
            row["plain_ms"] = events_ms(lambda: fixedpoint_matmul_ref(
                args[0][0], args[0][1], f, bias, n_bits=n_bits, n_out=N), 5, torch)
            row["plain_timing"] = "CUDA events, single calls"
        elif plain:
            row["plain_ms"] = timed(lambda a, b: fixedpoint_matmul_ref(a, b, f, bias,
                                                                       n_bits=n_bits, n_out=N),
                                    args, torch)
        if library:
            wd = (unpack_int(pw, n_bits, N).float() * torch.exp2(-f.float())).to(dt)
            nl = copies_for(wd.numel() * wd.element_size())
            wds = [wd] + [wd.clone() for _ in range(nl - 1)]
            del wd
            row["library_ms"] = timed(lambda a, b: torch.matmul(a, b),
                                      [(args[i % len(args)][0], wds[i]) for i in range(nl)],
                                      torch)
            del wds
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        row["achieved_TFLOPs"] = 2 * M * K * N / (row["ms"] * 1e-3) / 1e12
        del args
    return row


PREFILL_M = (32, 64, 128, 256, 512)  # the serve's prompt buckets


def _err(row):
    return max([row["max_abs_err"]] + [row[f"{k}_max_abs_err"] for k in ROUTE_KEY.values()
                                       if f"{k}_max_abs_err" in row])


def _bound_by(rows) -> str:
    """What bounds a sum of cases: the bound that bounds the most of its time."""
    t = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        t[r["bound_by"]] += r["bound_ms"]
    return max(t, key=t.get)


def _route_err(rows, route: str) -> float:
    """Largest error of one kernel over ``rows``: the calls the rule sent
    to ``route``, and the calls forced onto it."""
    key = f"{ROUTE_KEY[route]}_max_abs_err"
    errs = [r["max_abs_err"] for r in rows if r["route"] == route]
    return max(errs + [r[key] for r in rows if key in r])


def phase_fpmm(torch, dev):
    """Row 1 at internlm2-1.8b's 7 projections: M = 4 (decode) in bf16 and
    fp32, 2 and 4 bits, M = 128 in fp32, and the prefill buckets M = 32..512
    in bf16 at 2 bits (plus M = 128 at 4 bits); every bf16 case checks and
    times its rule's kernel (decode at M = 4, the tensor cores at prefill)
    beside the streaming one.  Returns the rows and the sums over one layer
    at M = 4 and at M = 512 (bf16, 2-bit)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    decode = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    prefill = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = []  # (n_bits, M, dtype, timed)
    for n_bits in (2, 4):
        cases += [(n_bits, 4, bf16, True), (n_bits, 4, fp32, True),
                  (n_bits, 128, fp32, n_bits == 2)]
    cases += [(2, M, bf16, True) for M in PREFILL_M] + [(4, 128, bf16, False)]
    for n_bits, M, dt, timing in cases:
        for name, K, N in FPMM_SHAPES:
            row = _fpmm_case(torch, gen, dev, name, K, N, M, dt, n_bits, with_bias=M >= 128,
                             timing=timing, routes=_bf16_routes(dt, M))
            if n_bits == 2 and dt == bf16 and M in (4, 512):
                acc = decode if M == 4 else prefill
                for k in acc:
                    acc[k] += row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul {name} M={M} bits={n_bits} {row['dtype']}: "
                             f"err {_err(row)}")
    prefill["bound_by"] = _bound_by(r for r in rows if r["M"] == 512)
    return rows, decode, prefill


# deepseek-v3's 2-D packed projections, K x N: the MLA layer's (kv_b_k /
# kv_b_v, 512 x 16384 each, run through the kernel at prefill only; decode
# absorbs them), the dense layers' MLP, the shared expert, the untied head
DEEPSEEK_FPMM_SHAPES = [
    ("q_a_proj", 7168, 1536), ("q_b_proj", 1536, 24576), ("kv_a_proj", 7168, 512),
    ("k_rope_proj", 7168, 64), ("kv_b_k_proj", 512, 16384), ("o_proj", 16384, 7168),
    ("mlp gate_proj", 7168, 18432), ("mlp down_proj", 18432, 7168),
    ("shared gate_proj", 7168, 2048), ("shared down_proj", 2048, 7168),
    ("lm_head", 7168, 129280),
]
# one MoE layer's 2-D matmuls at decode: 5 MLA projections, the shared expert's 3
DEEPSEEK_DECODE_LAYER = {"q_a_proj": 1, "q_b_proj": 1, "kv_a_proj": 1, "k_rope_proj": 1,
                         "o_proj": 1, "shared gate_proj": 2, "shared down_proj": 1}


def phase_fpmm_deepseek(torch, dev):
    """Row 1 at deepseek-v3's 2-D shapes, 2-bit (the serve phase's width),
    M = 4 (decode) and 128 in bf16 (serve) and fp32 (parity), and M = 512
    in bf16; every bf16 case checks and times its rule's kernel beside the
    streaming one (the plain version at M = 4 and 128).  Returns the rows
    and the sums over one MoE layer's decode matmuls at M = 4 bf16."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows = []
    layer = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bf16, fp32 = torch.bfloat16, torch.float32
    for name, K, N in DEEPSEEK_FPMM_SHAPES:
        for M, dt in ((4, bf16), (4, fp32), (128, bf16), (128, fp32), (512, bf16)):
            row = _fpmm_case(torch, gen, dev, name, K, N, M, dt, 2, with_bias=False,
                             timing=True, routes=_bf16_routes(dt, M), plain=M < 512)
            row["arch"] = DEEPSEEK
            if M == 4 and dt == bf16 and name in DEEPSEEK_DECODE_LAYER:
                for k in layer:
                    layer[k] += DEEPSEEK_DECODE_LAYER[name] * row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul deepseek {name} M={M} {row['dtype']}: "
                             f"err {_err(row)}")
        torch.cuda.empty_cache()
    return rows, layer


# gemma3-4b's 2-D packed projections, K x N: one layer's 7, and the tied
# 262,144-row read-out as a (d, vocab) matrix
GEMMA3_FPMM_SHAPES = [
    ("q_proj", 2560, 2048), ("k_proj", 2560, 1024), ("v_proj", 2560, 1024),
    ("o_proj", 2048, 2560), ("gate_proj", 2560, 10240), ("up_proj", 2560, 10240),
    ("down_proj", 10240, 2560), ("head", 2560, 262144),
]


def phase_fpmm_gemma3(torch, dev):
    """Row 1 at gemma3-4b's shapes, 2-bit, bf16: one layer's 7 projections
    at M = 4 (decode) and 512 (a prefill bucket), and the 262,144-row head
    at M = 4; each holds its rule's kernel to the plain version and times it
    beside the streaming kernel, ``torch.matmul`` and the bound.  (The serve
    reads the tied head through ``embed_logits``, which dequantizes the
    table, as the JAX package does: the phase times that too.)  Returns the
    rows, the layer's sums at M = 4 and the head's row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rows = []
    layer = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    head = None
    for name, K, N in GEMMA3_FPMM_SHAPES:
        for M in ((4,) if name == "head" else (4, 512)):
            row = _fpmm_case(torch, gen, dev, name, K, N, M, torch.bfloat16, 2,
                             with_bias=False, timing=True,
                             routes=_bf16_routes(torch.bfloat16, M))
            row["arch"] = "gemma3-4b"
            if name == "head":
                head = row
            elif M == 4:
                for k in layer:
                    layer[k] += row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul gemma3 {name} M={M}: err {_err(row)}")
        torch.cuda.empty_cache()
    return rows, layer, head


# ---------------------------------------------------------------------------
# phase 3b: paged attention
# ---------------------------------------------------------------------------
def _attn_case(torch, gen, dev, *, B, K, G, hd, block, max_blocks, T, dt, int8, q_mult,
               pos_last=(280, 320)):
    n_phys = B * max_blocks + 1
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    pos_last = torch.randint(*pos_last, (B,), generator=gen, device=dev)
    pos0 = (pos_last - (T - 1)).to(torch.int32)
    shape = (n_phys, block, K, hd)
    kp = torch.randn(shape, generator=gen, device=dev)
    vp = torch.randn(shape, generator=gen, device=dev)
    if int8:
        kp = torch.clamp(torch.round(kp * 0.5 * 32), -127, 127).to(torch.int8)
        vp = torch.clamp(torch.round(vp * 0.5 * 32), -127, 127).to(torch.int8)
    else:
        kp, vp = kp.to(dt), vp.to(dt)
    q = (torch.randn((B, T, K, G, hd), generator=gen, device=dev) * q_mult).to(dt)
    return q, kp, vp, bt, pos0


def _sdpa_ms(torch, q, kl, vl, pos0, window) -> float:
    """The library yardstick of a paged-attention case: one
    ``scaled_dot_product_attention`` over the gathered logical cache (kl, vl
    (B, S, K, hd), already dequantized, in q's dtype) under the causal /
    window mask, its K/V copies rotated past the L2.  Timed only."""
    import torch.nn.functional as F

    B, T, K, G, hd = q.shape
    dev = q.device
    kv_pos = torch.arange(kl.shape[1], device=dev)
    q_pos = pos0.long()[:, None] + torch.arange(T, device=dev)[None]
    mask = kv_pos[None, None] <= q_pos[:, :, None]
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[None, None] < window)
    qs = q.reshape(B, T, K * G, hd).transpose(1, 2)
    ks = kl.transpose(1, 2).repeat_interleave(G, dim=1)
    vs = vl.transpose(1, 2).repeat_interleave(G, dim=1)
    n = copies_for(ks.numel() * ks.element_size() * 2)
    args = [(qs, ks.clone(), vs.clone()) for _ in range(n)]
    return timed(lambda a, b, c: F.scaled_dot_product_attention(a, b, c, attn_mask=mask[:, None]),
                 args, torch)


SWEEP_TOKENS = (64, 300, 500)  # about this many cached tokens a row


def _attn_length_sweep(torch, dev, gen, *, quant: bool):
    """Timed only: the phase's main decode shape (internlm2: bf16 pool, K 8,
    G 2; olmoe: int4 pool, K 16, G 1; B 4, T 1, bf16 queries) with rows of
    about 64, 300 and 500 cached tokens: the kernel, SDPA, the byte bound
    and the rate the kernel reached."""
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import dequant_logical, gather_logical

    hd, block, max_blocks, B, T, dt = 128, 16, 32, 4, 1, torch.bfloat16
    K, G = (16, 1) if quant else (8, 2)
    rows = []
    for tokens in SWEEP_TOKENS:
        span = (tokens - 8, min(tokens + 8, max_blocks * block))
        shape = dict(B=B, K=K, G=G, hd=hd, block=block, max_blocks=max_blocks, T=T, dt=dt,
                     q_mult=1.0, pos_last=span)
        if quant:
            q, kp, vp, ke, ve, bt, pos0 = _attn_quant_case(torch, gen, dev, bits=4, wide=True,
                                                           **shape)
            kw = dict(k_scale_exp=ke, v_scale_exp=ve, kv_bits=4)
            args = [(kp.clone(), vp.clone(), ke.clone(), ve.clone())
                    for _ in range(copies_for((kp.numel() + ke.numel() * 4) * 2))]
            kl, vl = (dequant_logical(p, e, bt, kv_bits=4).to(dt) for p, e in ((kp, ke), (vp, ve)))
            per_block = block * K * kp.shape[-1] + 4 * K
        else:
            q, kp, vp, bt, pos0 = _attn_case(torch, gen, dev, int8=False, **shape)
            kw = {}
            args = [(kp.clone(), vp.clone(), None, None)
                    for _ in range(copies_for(kp.numel() * kp.element_size() * 2))]
            kl, vl = gather_logical(kp, bt), gather_logical(vp, bt)
            per_block = block * K * hd * kp.element_size()
        kw = dict(kw, scale=hd**-0.5)
        vis_blocks = ((pos0.long() + T - 1) // block + 1).sum().item()
        io = 2 * q.numel() * q.element_size() + 2 * vis_blocks * per_block + bt.numel() * 4 + B * 4
        b_ms, b_by = bound(io, 4 * (pos0.long() + T).sum().item() * T * K * G * hd, "bfloat16")

        def call(a, b, e, f):
            ekw = dict(kw, k_scale_exp=e, v_scale_exp=f) if quant else kw
            return aops.paged_attention(q, a, b, bt, pos0, **ekw)

        ms = timed(call, args, torch)
        row = {"phase": "kernel_sweep", "kernel": "paged_attention_quant" if quant
               else "paged_attention", "B": B, "K": K, "G": G, "hd": hd, "block": block, "T": T,
               "pool": "int4" if quant else "bfloat16", "q_dtype": "bfloat16",
               "mean_cached_tokens": (pos0.float() + T).mean().item(), "ms": ms,
               "library_ms": _sdpa_ms(torch, q, kl, vl, pos0, None), "bound_ms": b_ms,
               "bound_by": b_by, "achieved_GBps": io / (ms * 1e-3) / 1e9}
        del args, kl, vl
        emit(row)
        rows.append(row)
    return rows


def _case_entry(row):
    """A kernel case's shape, times and bound, for the ``kernels`` line."""
    keys = ("arch", "B", "K", "G", "hd", "T", "pos0", "window", "cap", "q_mult", "M", "N",
            "mean_cached_tokens", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bytes_bound_ms", "achieved_GBps", "achieved_TFLOPs")
    return {k: row[k] for k in keys if k in row}


def _sweep_entry(row):
    return {k: row[k] for k in ("mean_cached_tokens", "ms", "library_ms", "bound_ms",
                                "achieved_GBps")}


def _visible_blocks(pos0, T: int, window, block: int) -> int:
    """Blocks the query rows of each batch row can see, summed over rows:
    from the first row's window start to the last row's position."""
    hi = (pos0.long() + T - 1) // block
    lo = 0 if window is None else (pos0.long() - window + 1).clamp(min=0) // block
    return int((hi - lo + 1).sum().item())


def _visible_keys(pos0, T: int, window) -> int:
    """Keys the T query rows of each batch row attend, summed: query t of
    row b sees min(pos0[b] + t + 1, window) keys."""
    import torch

    t = pos0.long()[:, None] + torch.arange(1, T + 1, device=pos0.device)[None]
    if window is not None:
        t = t.clamp(max=window)
    return int(t.sum().item())


# the decode shapes of the dense configs (bf16 queries and pool): gemma3's
# head_dim 256 under its 1,024-token window, granite's MQA (K 1, G 48),
# gemma2's softcap 50 under its 4,096-token window; rows long enough that
# each window binds
DENSE_ATTN_CASES = [
    dict(arch="gemma3-4b", B=4, K=4, G=2, hd=256, max_blocks=128, pos_last=(1500, 1900),
         window=1024, cap=0.0, scale=256**-0.5),
    dict(arch="granite-34b", B=4, K=1, G=48, hd=128, max_blocks=32, pos_last=(280, 320),
         window=None, cap=0.0, scale=128**-0.5),
    dict(arch="gemma2-27b", B=4, K=16, G=2, hd=128, max_blocks=320, pos_last=(4400, 5000),
         window=4096, cap=50.0, scale=144.0**-0.5),
]


def phase_attn(torch, dev):
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import gather_logical, paged_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    base = dict(B=4, K=8, G=2, hd=128, block=16, max_blocks=32, pos_last=(280, 320))
    # The int8 case scales q so that |logit|/cap is about 1 and keeps the window
    # to 4-5 blocks: with the plain version on the same inputs, dropping the
    # softcap moves the output by > 1 and a window off by one by ~0.08, both far
    # outside the bf16 tolerance.
    cases = [
        dict(T=1, dt=torch.bfloat16, int8=False, window=None, cap=0.0, q_mult=1.0),
        dict(T=4, dt=torch.bfloat16, int8=False, window=None, cap=0.0, q_mult=1.0),
        dict(T=1, dt=torch.bfloat16, int8=True, window=64, cap=2.0, q_mult=4.0),
        dict(T=1, dt=torch.float32, int8=False, window=None, cap=0.0, q_mult=1.0),
    ]
    cases += [dict(T=1, dt=torch.bfloat16, int8=False, q_mult=1.0,
                   shape={k: c[k] for k in ("B", "K", "G", "hd", "max_blocks", "pos_last")},
                   **{k: c[k] for k in ("arch", "window", "cap", "scale")})
              for c in DENSE_ATTN_CASES]
    rows, worst, main = [], 0.0, None
    for c in cases:
        T, dt, int8 = c["T"], c["dt"], c["int8"]
        shape = dict(base, **c.get("shape", {}))
        B, K, G, hd, block = (shape[k] for k in ("B", "K", "G", "hd", "block"))
        dname = str(dt).split(".")[-1]
        q, kp, vp, bt, pos0 = _attn_case(torch, gen, dev, T=T, dt=dt, int8=int8,
                                         q_mult=c["q_mult"], **shape)
        kv_scale = 2.0**-5 if int8 else 1.0
        kw = dict(scale=c.get("scale", hd**-0.5), cap=c["cap"], window=c["window"],
                  kv_scale=kv_scale)
        out = aops.paged_attention(q, kp, vp, bt, pos0, **kw)
        again = aops.paged_attention(q, kp, vp, bt, pos0, **kw)
        ref = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL[dname]
        same = bool(torch.equal(out, again))
        ok = bool(torch.allclose(out.float(), ref.float(), **tol)) and same
        worst = max(worst, err)
        # bytes this run's data needs: the blocks each row can see, once
        kv_bytes = 2 * _visible_blocks(pos0, T, c["window"], block) * block * K * hd * \
            kp.element_size()
        io = 2 * q.numel() * q.element_size() + kv_bytes + bt.numel() * 4 + B * 4
        flops = 4 * _visible_keys(pos0, T, c["window"]) * K * G * hd
        b_ms, b_by = bound(io, flops, dname)
        n = copies_for(kp.numel() * kp.element_size() * 2)
        pools = [(kp.clone(), vp.clone()) for _ in range(n)]
        args = [(q, a, b) for a, b in pools]
        row = {"phase": "kernel", "kernel": "paged_attention", "arch": c.get("arch"), "B": B,
               "K": K, "G": G, "hd": hd, "block": block, "T": T,
               "kv_dtype": str(kp.dtype).split(".")[-1], "q_dtype": dname,
               "window": c["window"], "cap": c["cap"], "q_mult": c["q_mult"],
               "mean_cached_tokens": (pos0.float() + T).mean().item(), "max_abs_err": err,
               "tol": tol, "bit_identical": same, "pass": ok}
        row["ms"] = timed(lambda a, b, cc: aops.paged_attention(a, b, cc, bt, pos0, **kw),
                          args, torch)
        row["plain_ms"] = timed(lambda a, b, cc: paged_attention_ref(a, b, cc, bt, pos0, **kw),
                                args, torch)
        # library yardstick: SDPA over the gathered (logical) cache; timed
        # only, and without the softcap, which SDPA does not compute
        if c["cap"] and "arch" not in c:
            row["library_ms"] = None
        else:
            row["library_ms"] = _sdpa_ms(
                torch, q, gather_logical(kp, bt).to(dt) * kv_scale,
                gather_logical(vp, bt).to(dt) * kv_scale, pos0, c["window"])
            if c["cap"]:
                row["library_note"] = "SDPA without the softcap (it has none)"
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        del pools, args
        emit(row)
        rows.append(row)
        if main is None:
            main = row
        if not ok:
            raise Failed(f"paged_attention case {c}: err {err}, bit-identical {same}")
    main["length_sweep"] = _attn_length_sweep(torch, dev, gen, quant=False)
    return rows, worst, main


# ---------------------------------------------------------------------------
# phase 3d: fixedpoint_matmul_experts (olmoe's expert stacks, one f per expert)
# ---------------------------------------------------------------------------
OLMOE_EXPERT_SHAPES = [  # olmoe-1b-7b per-layer expert stacks, E x K x N
    ("gate_proj", 2048, 1024), ("up_proj", 2048, 1024), ("down_proj", 1024, 2048),
]
N_EXPERTS = 64


def _experts_stack(torch, gen, dev, E, K, N, n_bits):
    """(words, f, sc): Gaussian weights, expert e scaled by 2^s_e, packed
    with one f per expert; the stack is drawn and scaled in place (one fp32
    copy: 15 GB for a deepseek-v3 stack)."""
    from repro_torch.core import optimal_f, pack

    sc = torch.exp2(torch.randint(-2, 3, (E, 1, 1), generator=gen, device=dev).float())
    w = torch.randn((E, K, N), generator=gen, device=dev).mul_(sc / math.sqrt(K))
    f = torch.stack([optimal_f(w[e], n_bits)[0] for e in range(E)]).to(torch.int32)
    words = pack(w, f, n_bits).data
    del w
    return words, f, sc


TOP_K, DECODE_TOKENS = 8, 4  # both MoE models route top-8; the serves decode 4 slots
# one layer's 3 stacks at a decode step: the decode kernel reading the
# occupied experts, the same kernel and the streaming one reading all
DECODE_SUMS = ("ms", "dec_all_ms", "stream_ms", "plain_ms", "library_ms", "bound_ms",
               "bound_all_ms", "occupied")


def _routing(torch, gen, dev, E):
    """rows (E,) int32: each expert's assignments under a top-8 routing of 4
    random tokens, as ``moe_apply`` counts them at a decode step."""
    idx = torch.randn((DECODE_TOKENS, E), generator=gen, device=dev).topk(TOP_K, dim=-1)[1]
    idx = idx.reshape(-1)
    return torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def _experts_case(torch, gen, dev, name, words, f, sc, C, dt, n_bits, N, *, timing,
                  routes=(), plain=True, routed=False):
    """One experts case: x (E, C, K) of ``dt`` with expert e's rows scaled
    by 2^-s_e, the kernel the route rule picks held to its plain version;
    timed (kernel, plain, ``torch.bmm`` on the dequantized stack) when
    ``timing``; ``routes`` (bf16): those kernels forced, checked and timed
    beside the streaming one (``_routes``).  ``routed`` (a decode step):
    the rows of x a top-8 routing of 4 tokens fills (the rest zero) and
    their count per expert passed as ``rows``; the output must equal, bit
    for bit, the same kernel computing every expert, and ``bound_ms``
    counts the occupied experts' bytes (``bound_all_ms`` every expert's).
    A stack whose fp32 unpacking exceeds 1 GB is timed with CUDA events
    over single calls of the plain version and ``torch.bmm`` (a graph of 16
    plain calls would hold 16 sets of its temporaries)."""
    from repro_torch.core import unpack_int
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_experts_ref

    E, K = words.shape[0], words.shape[1]
    dname = str(dt).split(".")[-1]
    x = torch.randn((E, C, K), generator=gen, device=dev) / sc
    kw, occ = {}, E
    if routed:
        rows = _routing(torch, gen, dev, E)
        x[torch.arange(C, device=dev)[None, :] >= rows[:, None]] = 0.0
        kw = dict(rows=rows, max_active=min(E, DECODE_TOKENS * TOP_K))
        occ = int((rows > 0).sum().item())
    x = x.to(dt)
    y = fops.fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N, **kw)
    ref = fixedpoint_matmul_experts_ref(x, words, f, n_bits=n_bits, n_out=N,
                                        rows=kw.get("rows")).to(dt)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    tol = TOL[dname]
    ok = bool(torch.allclose(y.float(), ref.float(), **tol))
    wbytes = words.numel()
    out_b = E * C * N * x.element_size()
    io = x.numel() * x.element_size() + wbytes + 4 * E + out_b
    b_ms, b_by = bound(io, 2 * E * C * K * N, dname)
    row = {"phase": "kernel", "kernel": "fixedpoint_matmul_experts", "proj": name,
           "E": E, "C": C, "K": K, "N": N, "n_bits": n_bits, "dtype": dname,
           "route": fops._pick_route(dt, C, True),
           "f_range": [int(f.min()), int(f.max())], "max_abs_err": err,
           "tol": tol, "bound_ms": b_ms, "bound_by": b_by}
    if routed:
        # what this run's data needs: the occupied experts' x and words, f
        # and rows, and every expert's output (+0 for the empty ones)
        io_occ = (x.numel() * x.element_size() + wbytes) * occ // E + 8 * E + out_b
        row.update(occupied=occ, max_active=kw["max_active"], bound_all_ms=b_ms,
                   bound_all_by=b_by)
        row["bound_ms"], row["bound_by"] = bound(io_occ, 2 * occ * C * K * N, dname)
        every = fops.fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N,
                                               max_active=kw["max_active"])
        row["equal_to_every_expert"] = bool(torch.equal(y, every))
        ok = ok and row["equal_to_every_expert"]
        del every
    del y

    def call(route, a=x, b=words, **extra):
        return fops.fixedpoint_matmul_experts(a, b, f, n_bits=n_bits, n_out=N, _route=route,
                                              **{**kw, **extra})

    args = [(x.clone(), words.clone()) for _ in range(copies_for(wbytes * occ // E))] \
        if timing else None
    if routes:
        ok = _routes(torch, row, call, ref, row["route"], args, False, routes) and ok
    del ref
    row["pass"] = ok
    if timing:
        if not routes:
            row["ms"] = timed(lambda a, b: call(None, a, b), args, torch)
        if routed:  # the same kernel reading every expert's words
            row["dec_all_ms"] = timed(lambda a, b: call("decode", a, b, rows=None), args, torch)
        big = wbytes * (8 // n_bits) * 4 > 1e9
        if plain and big:
            row["plain_ms"] = events_ms(lambda: fixedpoint_matmul_experts_ref(
                x, words, f, n_bits=n_bits, n_out=N), 3, torch)
        elif plain:
            row["plain_ms"] = timed(lambda a, b: fixedpoint_matmul_experts_ref(
                a, b, f, n_bits=n_bits, n_out=N), args, torch)
        del args
        wd = unpack_int(words, n_bits, N).to(dt).mul_(torch.exp2(-f.to(dt))[:, None, None])
        if big:
            row["plain_timing"] = row["library_timing"] = "CUDA events, single calls"
            row["library_ms"] = events_ms(lambda: torch.bmm(x, wd), 5, torch)
        else:
            nl = copies_for(wd.numel() * wd.element_size())
            largs = [(x, wd)] + [(x.clone(), wd.clone()) for _ in range(nl - 1)]
            row["library_ms"] = timed(lambda a, b: torch.bmm(a, b), largs, torch)
            del largs
        del wd
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        if routed:
            row["achieved_GBps_occupied"] = io_occ / (row["ms"] * 1e-3) / 1e9
    return row


def phase_fpmm_experts(torch, dev):
    """Stacks as SYMOG makes them: Gaussian weights, expert e scaled by 2^s_e
    (s_e in [-2, 2]) so that its own optimal f differs, packed with one f
    per expert; the expert's rows of x scaled by 2^-s_e keep every output
    at unit scale, where the fp32 bar of the 2-D phase applies.  C = 4
    (decode) in bf16 and fp32 and C = 80 in fp32, 2 and 4 bits; the olmoe
    prefill capacities C = 5, 20, 80 (buckets 32, 128, 512) in bf16 at 2
    bits (and C = 80 at 4 bits).  Every bf16 case checks and times its
    rule's kernel beside the streaming one; the bf16 C = 4 cases run a
    decode step's routing (``routed``).  Returns the rows and the sums over
    one layer's 3 stacks at C = 4 and at C = 80 (bf16, 2-bit)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    E = N_EXPERTS
    rows = []
    decode = dict.fromkeys(DECODE_SUMS, 0.0)
    prefill = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bf16, fp32 = torch.bfloat16, torch.float32
    for n_bits in (2, 4):
        cases = [(4, bf16, True), (4, fp32, True), (80, fp32, n_bits == 2)]
        cases += [(C, bf16, True) for C in (5, 20, 80)] if n_bits == 2 else [(80, bf16, False)]
        for name, K, N in OLMOE_EXPERT_SHAPES:
            words, f, sc = _experts_stack(torch, gen, dev, E, K, N, n_bits)
            for C, dt, timing in cases:
                row = _experts_case(torch, gen, dev, name, words, f, sc, C, dt, n_bits, N,
                                    timing=timing, routes=_bf16_routes(dt, C),
                                    routed=dt == bf16 and C == 4)
                if n_bits == 2 and dt == bf16 and C in (4, 80):
                    acc = decode if C == 4 else prefill
                    for k in acc:
                        acc[k] += row[k]
                emit(row)
                rows.append(row)
                if not row["pass"]:
                    raise Failed(f"fixedpoint_matmul_experts {name} C={C} bits={n_bits} "
                                 f"{row['dtype']}: err {_err(row)}")
            del words
    torch.cuda.empty_cache()
    prefill["bound_by"] = _bound_by(r for r in rows if r["C"] == 80 and r["dtype"] == "bfloat16"
                                    and r["n_bits"] == 2)
    return rows, decode, prefill


DEEPSEEK_EXPERT_SHAPES = [  # deepseek-v3 per-MoE-layer expert stacks, E x K x N
    ("gate_proj", 7168, 2048), ("up_proj", 7168, 2048), ("down_proj", 2048, 7168),
]
DEEPSEEK_EXPERTS = 256


def phase_fpmm_experts_deepseek(torch, dev):
    """Row 1b at one deepseek-v3 MoE layer's three 2-bit stacks (256
    experts, one f each, 940 MB of words a stack): C = 4 (decode, 4 slots)
    in bf16 (serve: a decode step's routing, ``routed``) and fp32 (parity),
    and the prefill capacities C = 2, 10, 20 (buckets 32, 256, 512:
    ceil(1.25*bucket*8/256)) in bf16, each bf16 case checking and timing
    its rule's kernel beside the streaming one, every case timed.  Returns
    the rows and the sums over the layer's 3 stacks at C = 4 and at C = 20."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rows = []
    decode = dict.fromkeys(DECODE_SUMS, 0.0)
    prefill = {"ms": 0.0, "stream_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bf16 = torch.bfloat16
    for name, K, N in DEEPSEEK_EXPERT_SHAPES:
        words, f, sc = _experts_stack(torch, gen, dev, DEEPSEEK_EXPERTS, K, N, 2)
        for C, dt in ((4, bf16), (4, torch.float32), (2, bf16), (10, bf16), (20, bf16)):
            row = _experts_case(torch, gen, dev, name, words, f, sc, C, dt, 2, N, timing=True,
                                routes=_bf16_routes(dt, C), plain=C in (4, 20),
                                routed=dt == bf16 and C == 4)
            row["arch"] = DEEPSEEK
            if dt == bf16 and C in (4, 20):
                acc = decode if C == 4 else prefill
                for k in acc:
                    acc[k] += row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul_experts deepseek {name} C={C} "
                             f"{row['dtype']}: err {_err(row)}")
        del words, f, sc
        torch.cuda.empty_cache()
    prefill["bound_by"] = _bound_by(r for r in rows if r["C"] == 20)
    return rows, decode, prefill


CROSSOVER_ROWS = (2, 3, 4, 5, 8, 16)


def _crossover(rows, fast: str, slow: str, up: bool = True):
    """Fewest rows from which ``fast``'s kernel is faster than ``slow``'s at
    every larger swept count (``up``), or most rows up to which it is faster
    at every smaller swept count (not ``up``); None: it never is."""
    best = None
    for r in sorted(rows, key=lambda r: r["rows"], reverse=up):
        if fast not in r or slow not in r:
            continue
        if r[fast] >= r[slow]:
            break
        best = r["rows"]
    return best


def phase_crossover(torch, dev):
    """Phase 3g: the three kernels at 2..16 rows in bf16, 2-bit, at
    internlm2's gate_proj (2048 x 8192, M rows) and olmoe's gate stack (64
    x 2048 x 1024, C rows per expert), each checked (bf16 bar,
    bit-identical) and timed (the decode kernel up to its 8 rows).  The
    route rule must not sit on the wrong side of a measured crossover: the
    decode kernel must beat both others at every swept count up to
    DECODE_MAX_ROWS, and the tensor cores must beat the streaming kernel
    at every swept count they take."""
    from repro_torch.kernels.fixedpoint_matmul import ops as fops

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    bf16 = torch.bfloat16
    out = {"phase": "crossover", "tc_min_rows": fops.TC_MIN_ROWS,
           "decode_max_rows": fops.DECODE_MAX_ROWS}
    rows = []

    def sweep_entry(row, n):
        e = dict(rows=n, tc_ms=row["tc_ms"], stream_ms=row["stream_ms"])
        if "dec_ms" in row:
            e["dec_ms"] = row["dec_ms"]
            e["dec_best"] = row["dec_ms"] < min(row["tc_ms"], row["stream_ms"])
        return e

    def routes(n):
        return ("decode", "tensor_core") if n <= fops.DECODE_MAX_ROWS else ("tensor_core",)

    sweep = []
    for M in CROSSOVER_ROWS:
        row = _fpmm_case(torch, gen, dev, "gate_proj", 2048, 8192, M, bf16, 2, with_bias=False,
                         timing=True, routes=routes(M), plain=False, library=False)
        row["sweep"] = "crossover"
        emit(row)
        rows.append(row)
        sweep.append(sweep_entry(row, M))
    out["2d"] = {"shape": "internlm2 gate_proj 2048 x 8192", "cases": sweep}
    words, f, sc = _experts_stack(torch, gen, dev, N_EXPERTS, 2048, 1024, 2)
    sweep = []
    for C in CROSSOVER_ROWS:
        row = _experts_case(torch, gen, dev, "gate_proj", words, f, sc, C, bf16, 2, 1024,
                            timing=True, routes=routes(C), plain=False)
        row["sweep"] = "crossover"
        emit(row)
        rows.append(row)
        sweep.append(sweep_entry(row, C))
    del words
    torch.cuda.empty_cache()
    out["experts"] = {"shape": "olmoe gate_proj stack 64 x 2048 x 1024", "cases": sweep}
    ok = all(r["pass"] for r in rows)
    for k in ("2d", "experts"):
        cases = out[k]["cases"]
        out[k]["crossover_rows"] = _crossover(cases, "tc_ms", "stream_ms")
        # decode's last row count below both other kernels (swept upwards)
        dec_vs = [dict(c, best_other=min(c["tc_ms"], c["stream_ms"])) for c in cases
                  if "dec_ms" in c]
        out[k]["decode_crossover_rows"] = _crossover(dec_vs, "dec_ms", "best_other", up=False)
        tc_ok = all(c["tc_ms"] < c["stream_ms"] for c in cases
                    if c["rows"] >= fops.TC_MIN_ROWS)
        dec_ok = all(c["dec_best"] for c in cases if c["rows"] <= fops.DECODE_MAX_ROWS)
        out[k]["rule_ok"] = tc_ok and dec_ok
        ok = ok and tc_ok and dec_ok
    out["pass"] = ok
    emit(out)
    if not out["pass"]:
        raise Failed(f"route rule against the crossover: {out}")
    return rows, out


def phase_fpmm_head(torch, dev):
    """Row 1 at olmoe's packed untied head: M = 4 decode rows, fp32 x,
    K 2048 -> N 50304, 2-bit."""
    from repro_torch.core import optimal_f, unpack_int
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    M, K, N, n_bits = 4, 2048, 50304, 2
    w = torch.randn((K, N), generator=gen, device=dev) / math.sqrt(K)
    f = optimal_f(w, n_bits)[0].to(torch.int32)
    pw = fops.pack_weight(w, f, n_bits)
    del w
    x = torch.randn((M, K), generator=gen, device=dev)
    y = fops.fixedpoint_matmul(x, pw, f, n_bits=n_bits, n_out=N)
    ref = fixedpoint_matmul_ref(x, pw, f, n_bits=n_bits, n_out=N)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = TOL["float32"]
    ok = bool(torch.allclose(y, ref, **tol))
    io = x.numel() * 4 + pw.numel() + 4 + M * N * 4
    b_ms, b_by = bound(io, 2 * M * K * N, "float32")
    n = copies_for(pw.numel())
    args = [(x.clone(), pw.clone()) for _ in range(n)]
    wd = unpack_int(pw, n_bits, N).float() * torch.exp2(-f.float())
    largs = [(x, wd.clone()) for _ in range(copies_for(wd.numel() * 4))]
    row = {"phase": "kernel", "kernel": "fixedpoint_matmul", "proj": "olmoe lm_head", "M": M,
           "K": K, "N": N, "n_bits": n_bits, "dtype": "float32", "route": "streaming", "max_abs_err": err, "tol": tol,
           "pass": ok, "bound_ms": b_ms, "bound_by": b_by,
           "ms": timed(lambda a, b: fops.fixedpoint_matmul(a, b, f, n_bits=n_bits, n_out=N),
                       args, torch),
           "plain_ms": timed(lambda a, b: fixedpoint_matmul_ref(a, b, f, n_bits=n_bits, n_out=N),
                             args, torch),
           "library_ms": timed(lambda a, b: torch.matmul(a, b), largs, torch)}
    row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
    emit(row)
    del args, largs, wd
    if not ok:
        raise Failed(f"fixedpoint_matmul at the olmoe head shape: err {err}")
    return row


# ---------------------------------------------------------------------------
# phase 3e: paged attention over SYMOG-quantized int8 / int4 pools
# ---------------------------------------------------------------------------
def _attn_quant_case(torch, gen, dev, *, B, K, G, hd, block, max_blocks, T, dt, bits, q_mult,
                     wide, pos_last=(280, 320)):
    """Quantized pools over ~300 cached tokens a row.  ``wide``: random
    mantissas under per-(block, head) exponents spread over [-8, 4];
    otherwise the pools a paged write makes of unit-scale k/v (values
    N(0,1)·2^s, s in [-3, 1] per (block, head), exponents from each block's
    first token)."""
    from repro_torch.models.attention import KV_QMAX, block_scale_exp, pack_int4, quantize_fixed

    n_phys = B * max_blocks + 1
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    pos_last = torch.randint(*pos_last, (B,), generator=gen, device=dev)
    pos0 = (pos_last - (T - 1)).to(torch.int32)
    qmax = KV_QMAX[bits]
    pools, exps = [], []
    for _ in range(2):
        if wide:
            m = torch.randint(-qmax, qmax + 1, (n_phys, block, K, hd), generator=gen,
                              device=dev).to(torch.int8)
            e = torch.randint(-8, 5, (n_phys, K), generator=gen, device=dev).to(torch.int32)
        else:
            s = torch.randint(-3, 2, (n_phys, 1, K, 1), generator=gen, device=dev).float()
            x = torch.randn((n_phys, block, K, hd), generator=gen, device=dev) * torch.exp2(s)
            e = block_scale_exp(x[:, 0], qmax)
            m = quantize_fixed(x, e[:, None], qmax)
        pools.append(pack_int4(m) if bits == 4 else m)
        exps.append(e)
    q = (torch.randn((B, T, K, G, hd), generator=gen, device=dev) * q_mult).to(dt)
    return q, pools[0], pools[1], exps[0], exps[1], bt, pos0


# the tail-prefill launches of row 3 (gemma3's admission to an int4 pool:
# B 1, T = the tail bucket, K 4, G 2, hd 256): from position 0 under the
# local layers' window of 1,024 (it binds at T 2048) and the global layers'
# none, and a tail that starts mid-sequence.  Over 1,000-2,000 keys unit
# queries give outputs of a few 1e-2, which a dropped key tile or a window
# off by a block moves by less than the bf16 bar; so two more cases, built
# like 3b's windowed int8 case, scale q by 4 (logits of a few units, a
# softcap of 2 on one) under a window of 64 that binds on every row past
# the first 64, at T 2048 from 0 and from 1,000: on those the plain version
# with its window one block wider, or its causal horizon one key later,
# must fail the bar (``faults_caught``)
TAIL_PREFILL_CASES = [dict(T=32, pos0=0, window=1024), dict(T=512, pos0=0, window=1024),
                      dict(T=2048, pos0=0, window=1024), dict(T=2048, pos0=0, window=None),
                      dict(T=512, pos0=1000, window=1024),
                      dict(T=2048, pos0=0, window=64, q_mult=4.0),
                      dict(T=2048, pos0=1000, window=64, cap=2.0, q_mult=4.0)]


def phase_attn_quant(torch, dev):
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import dequant_logical, paged_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    base = dict(B=4, hd=128, block=16, max_blocks=32, pos_last=(280, 320))
    # olmoe decode (16 MHA heads, G = 1) and internlm2's GQA (8 KV heads, G = 2), int4 and
    # int8, bf16 queries (the serving dtype); one window-64 softcap-2 case on which, with the
    # plain version on the same inputs, a dropped softcap or a window off by one fails the
    # bf16 tolerance; one fp32 case on unit-scale pools at the fp32 tolerance.
    cases = [dict(K=16, G=1, bits=4, dt=torch.bfloat16, window=None, cap=0.0, wide=True),
             dict(K=16, G=1, bits=8, dt=torch.bfloat16, window=None, cap=0.0, wide=True),
             dict(K=8, G=2, bits=4, dt=torch.bfloat16, window=None, cap=0.0, wide=True),
             dict(K=8, G=2, bits=8, dt=torch.bfloat16, window=None, cap=0.0, wide=True),
             dict(K=16, G=1, bits=4, dt=torch.bfloat16, window=64, cap=2.0, wide=True),
             dict(K=16, G=1, bits=4, dt=torch.float32, window=None, cap=0.0, wide=False)]
    # the tail-prefill launches, on the pools a paged write makes of unit-scale k/v
    cases += [dict(K=4, G=2, bits=4, dt=torch.bfloat16, window=c["window"],
                   cap=c.get("cap", 0.0), q_mult=c.get("q_mult", 1.0), wide=False, T=c["T"],
                   tail_prefill=True,
                   shape=dict(B=1, hd=256, max_blocks=max(128, -(-(c["pos0"] + c["T"]) // 16)),
                              pos_last=(c["pos0"] + c["T"] - 1, c["pos0"] + c["T"])))
              for c in TAIL_PREFILL_CASES]
    rows, worst, main = [], 0.0, None
    for c in cases:
        K, G, bits, dt, T = c["K"], c["G"], c["bits"], c["dt"], c.get("T", 1)
        shape = dict(base, **c.get("shape", {}))
        B, hd, block = shape["B"], shape["hd"], shape["block"]
        dname = str(dt).split(".")[-1]
        q, kp, vp, ke, ve, bt, pos0 = _attn_quant_case(
            torch, gen, dev, K=K, G=G, T=T, dt=dt, bits=bits, q_mult=c.get("q_mult", 1.0),
            wide=c["wide"], **shape)
        kw = dict(scale=hd**-0.5, cap=c["cap"], window=c["window"], kv_bits=bits)
        out = aops.paged_attention(q, kp, vp, bt, pos0, k_scale_exp=ke, v_scale_exp=ve, **kw)
        again = aops.paged_attention(q, kp, vp, bt, pos0, k_scale_exp=ke, v_scale_exp=ve, **kw)
        ref = paged_attention_ref(q, kp, vp, bt, pos0, k_scale_exp=ke, v_scale_exp=ve, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL[dname]
        same = bool(torch.equal(out, again))
        ok = bool(torch.allclose(out.float(), ref.float(), **tol)) and same
        worst = max(worst, err)
        caught = None
        if c.get("tail_prefill") and c.get("q_mult", 1.0) != 1.0:
            # the bar's power: faults the case must see, as the plain version
            # makes them (each must fail the bar that the kernel passes)
            faults = {"window_plus_block": (pos0, dict(kw, window=c["window"] + block)),
                      "window_minus_block": (pos0, dict(kw, window=c["window"] - block)),
                      "horizon_plus_one": (pos0 + 1, kw)}
            caught = {}
            for fname, (p0, fkw) in faults.items():
                bad = paged_attention_ref(q, kp, vp, bt, p0, k_scale_exp=ke, v_scale_exp=ve,
                                          **fkw)
                caught[fname] = {"max_abs_diff": (bad.float() - out.float()).abs().max().item(),
                                 "fails_bar": not torch.allclose(out.float(), bad.float(), **tol)}
                del bad
            ok = ok and all(f["fails_bar"] for f in caught.values())
        del out, again, ref
        # bytes this run's data needs: the words and exponents of the blocks each row sees
        kv_bytes = 2 * _visible_blocks(pos0, T, c["window"], block) * \
            (block * K * kp.shape[-1] + 4 * K)
        io = 2 * q.numel() * q.element_size() + kv_bytes + bt.numel() * 4 + B * 4
        b_ms, b_by = bound(io, 4 * _visible_keys(pos0, T, c["window"]) * K * G * hd, dname)
        n = copies_for((kp.numel() + ke.numel() * 4) * 2)
        args = [(q, kp.clone(), vp.clone(), ke.clone(), ve.clone()) for _ in range(n)]
        row = {"phase": "kernel", "kernel": "paged_attention_quant", "B": B, "K": K, "G": G,
               "hd": hd, "block": block, "T": T, "pos0": int(pos0.min()) if B == 1 else None,
               "kv_bits": bits, "q_dtype": dname, "window": c["window"], "cap": c["cap"],
               "tail_prefill": c.get("tail_prefill", False), "wide_exponents": c["wide"],
               "exp_range": [int(min(ke.min(), ve.min())), int(max(ke.max(), ve.max()))],
               "q_mult": c.get("q_mult", 1.0), "faults_caught": caught,
               "max_abs_err": err, "tol": tol, "bit_identical": same, "pass": ok}
        row["ms"] = timed(lambda a, b, cc, d, e: aops.paged_attention(
            a, b, cc, bt, pos0, k_scale_exp=d, v_scale_exp=e, **kw), args, torch)
        row["plain_ms"] = timed(lambda a, b, cc, d, e: paged_attention_ref(
            a, b, cc, bt, pos0, k_scale_exp=d, v_scale_exp=e, **kw), args, torch)
        # library yardstick: SDPA over the gathered, dequantized cache; timed only
        row["library_ms"] = None if c["cap"] else _sdpa_ms(
            torch, q, dequant_logical(kp, ke, bt, kv_bits=bits).to(dt),
            dequant_logical(vp, ve, bt, kv_bits=bits).to(dt), pos0, c["window"])
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["bytes_bound_ms"] = io / HBM_BYTES_PER_S * 1e3
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        row["achieved_TFLOPs"] = 4 * _visible_keys(pos0, T, c["window"]) * K * G * hd / \
            (row["ms"] * 1e-3) / 1e12
        del args
        emit(row)
        rows.append(row)
        if main is None:
            main = row
        if not ok:
            raise Failed(f"paged_attention_quant case {c}: err {err}, bit-identical {same}")
    main["length_sweep"] = _attn_length_sweep(torch, dev, gen, quant=True)
    return rows, worst, main


# ---------------------------------------------------------------------------
# phase 3c: symog_update
# ---------------------------------------------------------------------------
SYMOG_TOL = dict(rtol=1e-6, atol=1e-7)  # tests/test_kernels.py:22-23
SYMOG_FLOPS = 16  # per element: div, rint, 4 min/max, 5 mul, 5 add/sub


def symog_leaf_shapes(cfg):
    """Every quantizable leaf of internlm2-1.8b: the tied embedding and the
    7 projections, each stacked over the layer axis (one f per leaf)."""
    L, D, H, K, hd, F = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.d_ff)
    return [("embed", (cfg.vocab_size, D)), ("q_proj", (L, D, H, hd)),
            ("k_proj", (L, D, K, hd)), ("v_proj", (L, D, K, hd)), ("o_proj", (L, H, hd, D)),
            ("gate_proj", (L, D, F)), ("up_proj", (L, D, F)), ("down_proj", (L, F, D))]


def events_ms(fn, reps: int, torch) -> float:
    """ms per call of ``fn`` (work of 100s of MB per call: cold operands, no
    graph needed), CUDA events around ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def _symog_operands(torch, gen, dev, shape, n_bits, case):
    """(w, g, v, kw): weights at init scale with their own Δ, gradients and
    momentum of training scale, λ_eff = λ_end·2/M_l; or a case cut to fail on
    a wrong kernel: 'ties' (half of w exactly on (k+½)Δ, g = v = 0,
    λ_eff = 1, so a wrong rounding moves v' by Δ), 'clip' (a third of |w|
    far above Δ·qmax), 'misaligned' (4 bytes off 16: the scalar path)."""
    from repro_torch.core import optimal_f

    n = math.prod(shape)
    fan_in = shape[-2] if len(shape) >= 2 else 1
    w = torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan_in)
    f, delta = optimal_f(w, n_bits)
    delta = delta.to(dev, torch.float32)
    d, q = float(delta), 2 ** (n_bits - 1) - 1
    g = torch.randn(shape, generator=gen, device=dev) * 1e-4
    v = torch.randn(shape, generator=gen, device=dev) * 1e-4
    kw = dict(delta=delta, lam_eff=10.0 * math.exp(9.0) * 2.0 / n, lr=0.01, mu=0.9,
              n_bits=n_bits)
    flat = w.view(-1)
    if case == "ties":
        k = torch.randint(-q - 1, q + 1, (n // 2,), generator=gen, device=dev)
        flat[: n // 2] = (k.float() + 0.5) * d
        g.zero_()
        v.zero_()
        kw.update(lam_eff=1.0, lr=1e-3)
    elif case == "clip":
        sign = torch.randint(0, 2, (n // 3,), generator=gen, device=dev).float() * 2 - 1
        flat[: n // 3] = sign * (q + 3) * d
    elif case == "misaligned":
        w, g, v = (torch.cat([torch.zeros(1, device=dev), t.reshape(-1)])[1:] for t in (w, g, v))
    return w, g, v, kw


def phase_symog(torch, dev, cfg):
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.kernels.symog_update.ref import symog_update_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = [(name, shape, 2, "random") for name, shape in symog_leaf_shapes(cfg)]
    cases += [("gate_proj", symog_leaf_shapes(cfg)[5][1], 4, "random"),
              ("odd_n", (1_000_003,), 2, "random"), ("ties", (1 << 24,), 2, "ties"),
              ("ties_4bit", (1_000_003,), 4, "ties"), ("clip", (1 << 24,), 2, "clip"),
              ("misaligned", (1_000_003,), 2, "misaligned")]
    rows, worst = [], 0.0
    full = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "elements": 0}
    for name, shape, n_bits, case in cases:
        w, g, v, kw = _symog_operands(torch, gen, dev, shape, n_bits, case)
        w_ref, v_ref = symog_update_ref(w, g, v, **kw)
        sops.symog_update(w, g, v, **kw)
        torch.cuda.synchronize()
        err = max((w - w_ref).abs().max().item(), (v - v_ref).abs().max().item())
        ok = bool(torch.allclose(w, w_ref, **SYMOG_TOL) and torch.allclose(v, v_ref, **SYMOG_TOL))
        worst = max(worst, err)
        del w_ref, v_ref
        n = w.numel()
        b_ms, b_by = bound(20 * n, SYMOG_FLOPS * n, "float32")
        row = {"phase": "kernel", "kernel": "symog_update", "leaf": name, "shape": list(shape),
               "n": n, "n_bits": n_bits, "case": case, "max_abs_err": err, "tol": SYMOG_TOL,
               "pass": ok, "bound_ms": b_ms, "bound_by": b_by}
        if case == "random" and n_bits == 2 and name != "odd_n":  # one full update
            row["ms"] = events_ms(lambda: sops.symog_update(w, g, v, **kw), 5, torch)
            row["plain_ms"] = events_ms(lambda: symog_update_ref(w, g, v, **kw), 3, torch)
            row["achieved_GBps"] = 20 * n / (row["ms"] * 1e-3) / 1e9
            for k in ("ms", "plain_ms", "bound_ms"):
                full[k] += row[k]
            full["elements"] += n
        emit(row)
        rows.append(row)
        del w, g, v
        if not ok:
            raise Failed(f"symog_update {name} {shape} bits={n_bits} {case}: err {err}")
    torch.cuda.empty_cache()
    return rows, worst, full


# ---------------------------------------------------------------------------
# phase 4: full-width parity, kernels vs plain paths
# ---------------------------------------------------------------------------
# amaxes at which the port's SYMOG exponent once differed from the JAX
# package's jitted one (tests/test_torch_kv_exponent.py), by qmax
KV_EXP_AMAXES = {127: [63.5, 127.0, 254.0, 508.0, 65024.0, 130048.0], 7: [3.5]}


def _kv_exponent_card_vs_cpu(torch, dev):
    """The exponents and words a quantized pool's writes make on the card
    against the CPU's (which tests/test_torch_kv_exponent.py holds to jitted
    JAX), array_equal: at the amaxes above, qmax·2^k for k in -12..12, every
    step point of the exponent, and the fp32 neighbours of each; and the
    arithmetic behind the step points (``jitted_exponent``) on those amaxes."""
    from repro_torch.models.attention import block_scale_exp, quantize_fixed
    from repro_torch.models.kv_exponent import exponent_thresholds, jitted_exponent

    out = {}
    for qmax in (127, 7):
        vals = torch.tensor(KV_EXP_AMAXES[qmax] + [qmax * 2.0**k for k in range(-12, 13)])
        vals = torch.cat([vals, exponent_thresholds(qmax)])
        a = torch.cat([vals, torch.nextafter(vals, torch.zeros(())),
                       torch.nextafter(vals, vals * 2)])
        x = a[:, None] * torch.tensor([1.0, -0.5, 0.25])  # entries whose amax is a
        e_cpu, e_dev = block_scale_exp(x, qmax), block_scale_exp(x.to(dev), qmax).cpu()
        w_cpu = quantize_fixed(x, e_cpu, qmax)
        w_dev = quantize_fixed(x.to(dev), e_dev.to(dev), qmax).cpu()
        j_cpu, j_dev = jitted_exponent(a, qmax), jitted_exponent(a.to(dev), qmax).cpu()
        out[qmax] = {"amaxes": int(a.numel()), "exponents_equal": torch.equal(e_dev, e_cpu),
                     "words_equal": torch.equal(w_dev, w_cpu),
                     "arithmetic_equal": torch.equal(j_dev, j_cpu),
                     "arithmetic_equals_steps": torch.equal(j_cpu, e_cpu)}
    return out


def _past_trash(t, group: str, groups, tail: bool):
    """A pool leaf without its trash block (physical row 0) when ``tail``."""
    if not tail:
        return t
    stacked = next(g for g in groups if g.name == group).stacked
    return t[:, 1:] if stacked else t[1:]


def _record_paged_writes(torch, log, forced=None):
    """Wrap the model's paged write (``attention._paged_write``, the one
    every admission and decode step of a paged pool makes): append each
    call's (names, k/v entries written, flat indices, the route's own
    entries) to ``log``.  With ``forced`` (the kernel route's log) each
    call writes that route's entries at the same indices in place of its
    own, so the plain route attends the kernel route's very pool words.
    Returns the function that restores the model's write."""
    from repro_torch.models import attention as attn_mod

    inner = attn_mod._paged_write

    def write(cache, names, news, idx):
        own = list(news)
        if forced is not None:
            i = len(log)
            if i >= len(forced) or forced[i][0] != names or not torch.equal(forced[i][2], idx):
                raise Failed(f"paged write {i} {names}: not the kernel route's write")
            news = forced[i][1]
        log.append((names, [n.detach().clone() for n in news], idx.clone(), own))
        return inner(cache, names, news, idx)

    write.inner = inner
    attn_mod._paged_write = write
    return lambda: setattr(attn_mod, "_paged_write", inner)


def _tail_admission(torch, eng, caches, host, prompt, bt_row, groups, log):
    """One request's tail-prefill admission (start 0) through the engine's
    backends, under ``_record_paged_writes``: the paged writes it made
    (each layer's k/v entries and flat indices, in layer order) are made
    again on the CPU into ``host``.  Returns the last real position's
    logits."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import prefill_prefix_lm

    L = int(prompt.shape[0])
    bucket = 1 << (L - 1).bit_length()
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=eng.device)
    tokens[0, :L] = prompt.to(eng.device)
    n0 = len(log)
    lg, _ = eng._with_backend(prefill_prefix_lm, eng.params, {"tokens": tokens}, caches,
                              bt_row, 0, eng.cfg, seq_len=L, compute_dtype=torch.float32)
    writes = log[n0:]
    layer_views = []
    for g in groups:
        hp = host[g.name]
        layer_views += ([{n: t[i] for n, t in hp.items()} for i in range(g.count)]
                        if g.stacked else [hp])
    if len(writes) != len(layer_views):
        raise Failed(f"tail prefill made {len(writes)} paged writes for {len(layer_views)} layers")
    real_write = attn_mod._paged_write.inner
    for view, (names, news, idx, _) in zip(layer_views, writes):
        real_write(view, names, [n.cpu() for n in news], idx.cpu())
    return lg[0, -1]


def phase_parity(torch, dev, layers: int, arch: str = "internlm2-1.8b",
                 kv_cache_dtype: str = "bf16", build=None, plain_packed: str = "unpack",
                 tail=None):
    """Logits through the kernels against the plain paths.  With a quantized
    ``kv_cache_dtype`` the pools hold int8 / int4 words and one exponent per
    (block, KV head) (per block for MLA's c_kv / k_rope): admission
    quantizes through ``_scatter_blocks_quant``, each decode step writes
    through ``paged_quant_update``, and the fused route reads with the
    quantized kernel, the composed one with ``_paged_read``.  Both routes
    then run the packed matmuls through the kernels (held to the plain
    version by the float-pool run): rounding a decode token's k/v to the
    pool's grid is discontinuous, so the ~1e-6 between the matmul routes
    flips int4 words and moves logits well past ``PARITY_ATOL``: the two
    routes must write the same words for their logits to be comparable.
    ``plain_packed="kernel"`` keeps the matmul kernels on the plain route
    of a float pool too (deepseek-v3: unpacking a 256-expert stack to fp32
    takes 15 GB).  ``build(cfg)`` returns the packed artifact (default:
    ``init_lm`` + ``symog_init`` + ``pack_tree`` of the whole tree).

    The admission is the scheduler's: the tail prefill for a quantized
    pool of an all-attention decoder (``tail=True`` forces it on a float
    pool too), each layer's writes held array_equal to the same writes made
    on the CPU.  A tail prefill attends the pool inside the admission, so
    on a quantized pool the two routes' ~1e-6 apart k/v of every layer
    past the first would round to different words there.  So on that run
    the plain route writes the kernel route's k/v entries in place of its
    own (``_record_paged_writes``): both attend the same words, the logits
    are held to ``PARITY_ATOL``, and the entries each route computed for
    itself to the same bar."""
    from repro_torch import configs
    from repro_torch.core import SymogConfig, pack_tree, symog_init
    from repro_torch.kernels import dispatch
    from repro_torch.models import decode_lm, init_lm, prefill_lm
    from repro_torch.models.lm import PAGED_CACHE_LEAVES, scan_groups
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import _scatter_blocks, _scatter_blocks_quant
    from repro_torch.serve.scheduler import Scheduler

    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers,
                              kv_cache_dtype=kv_cache_dtype)
    if build is None:
        params = init_lm(11, cfg, device=dev)
        scfg = SymogConfig(n_bits=2)
        packed = pack_tree(params, symog_init(params, scfg), scfg)
        del params
    else:
        packed = build(cfg)
    max_len, block, steps = 128, 16, 4
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    lens = [37, 70]
    prompts = [torch.randint(0, cfg.vocab_size, (L,), generator=gen) for L in lens]
    forced = torch.randint(0, cfg.vocab_size, (steps, len(lens)), generator=gen)
    # the attention kernels of this family: float pools, quantized pools
    names = (MLA_COUNTS if cfg.use_mla else ("paged_attention", "paged_attention_quant"))
    logits, attn_launches, admission_equal, final, mm_launches = {}, {}, {}, {}, {}
    plain_pb = plain_packed if kv_cache_dtype == "bf16" else "kernel"
    quant = kv_cache_dtype != "bf16"
    logs = {}  # the paged writes of each route of a tail-prefill run
    for path, (pb, ab) in {"kernels": ("kernel", "fused"), "plain": (plain_pb, "composed")}.items():
        dispatch.set_packed_backend(pb)
        dispatch.set_attention_backend(ab)
        eng = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=torch.float32, device=dev)
        dispatch.set_packed_backend("auto")
        dispatch.set_attention_backend("auto")
        nb = max_len // block
        # the scheduler's pool layout for two slots: (n_phys, block, ...) per
        # paged leaf (a leading layer axis per stacked group), exponent leaves
        # for a quantized pool; and its admission route (the tail prefill
        # for a quantized pool of an all-attention decoder)
        sched = Scheduler(eng, ServeConfig(n_slots=len(lens), block_size=block))
        caches = sched.caches
        tail = sched._quant_admit if tail is None else tail
        del sched
        groups = scan_groups(cfg)
        bt = (torch.arange(len(lens) * nb, device=dev, dtype=torch.int32) + 1).reshape(len(lens), nb)
        # the admission on the card (quantizing, for a quantized pool), held
        # array_equal to the same writes made on the CPU from the same caches
        host = {g.name: {n: t.new_zeros(t.shape, device="cpu")
                         for n, t in caches[g.name]["sub0"].items()} for g in groups}
        zero_counts()
        outs = []
        # a tail-prefill run records its paged writes; on a quantized pool
        # the plain route writes the kernel route's entries (see above)
        log = logs.setdefault(path, [])
        restore = _record_paged_writes(
            torch, log, logs["kernels"] if quant and path == "plain" else None) if tail \
            else (lambda: None)
        try:
            for b, pr in enumerate(prompts):
                if tail:
                    outs.append(_tail_admission(torch, eng, caches, host, pr, bt[b], groups, log))
                    continue
                lg, one = eng._with_backend(prefill_lm, eng.params,
                                            {"tokens": pr[None].to(dev)}, cfg,
                                            max_len=max_len, compute_dtype=torch.float32)
                outs.append(lg[0, -1])
                for g in groups:
                    axis = 1 if g.stacked else 0
                    pool, hp = caches[g.name]["sub0"], host[g.name]
                    for n, src in one[g.name]["sub0"].items():
                        if n not in PAGED_CACHE_LEAVES:
                            continue
                        if n + "_scale" in pool:
                            _scatter_blocks_quant(pool[n], pool[n + "_scale"], src, bt[b], axis, nb)
                            _scatter_blocks_quant(hp[n], hp[n + "_scale"], src.cpu(), bt[b].cpu(),
                                                  axis, nb)
                        else:
                            _scatter_blocks(pool[n], src, bt[b], axis, nb)
                            _scatter_blocks(hp[n], src.cpu(), bt[b].cpu(), axis, nb)
            # (a tail prefill's pad rows all write into the trash block, physical
            # row 0, in an order the card does not define: it is left out)
            admission_equal[path] = all(
                torch.equal(_past_trash(t.cpu(), g, groups, tail),
                            _past_trash(host[g][n], g, groups, tail))
                for g in host for n, t in caches[g]["sub0"].items())
            pos = torch.tensor(lens, dtype=torch.int32, device=dev)
            active = torch.ones(len(lens), dtype=torch.bool, device=dev)
            for s in range(steps):
                lg, caches = eng._with_backend(decode_lm, eng.params, caches,
                                               forced[s].to(dev)[:, None].to(torch.int32), pos, cfg,
                                               compute_dtype=torch.float32, active=active,
                                               block_tables=bt)
                outs.extend(lg[:, 0])
                pos = pos + 1
        finally:
            restore()
        logits[path] = torch.stack(outs)
        final[path] = caches
        counts = read_counts()
        attn_launches[path] = {n: counts[n] for n in names}
        mm_launches[path] = {n: c for n, c in counts.items() if n.startswith("fixedpoint")}
        del eng, caches
    torch.cuda.synchronize()
    words_differing = {f"{g}/{n}": int((_past_trash(t, g, groups, tail) != _past_trash(
        final["plain"][g]["sub0"][n], g, groups, tail)).sum().item())
        for g in final["kernels"] for n, t in final["kernels"][g]["sub0"].items()}
    del final, packed
    torch.cuda.empty_cache()
    a, b = logits["kernels"], logits["plain"]
    err = (a - b).abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(a).all().item())
    # the fused route must have read the pool with the family's kernel for
    # its pool (quantized or not) at every decode step of every layer, the
    # plain route never
    exponents = _kv_exponent_card_vs_cpu(torch, dev) if quant else None
    # (fp32 queries: MLA on mla_partial, its tensor-core counts 0)
    # (a tail-prefill admission launches the pool's kernel once a layer)
    n_attn = layers * (steps + (len(lens) if tail else 0))
    want = {"kernels": {names[0]: 0 if quant else n_attn, names[1]: n_attn if quant else 0},
            "plain": dict.fromkeys(names, 0)}
    # a quantized tail-prefill run's plain route wrote the kernel route's
    # entries: the pools must be equal, and the entries each route computed
    # for itself within the logits' bar
    shared = bool(tail and quant)
    kv_err = max(((o.float() - w.float()).abs().max().item() for _, ws, _, owns in logs["plain"]
                  for o, w in zip(owns, ws)), default=0.0) if shared else None
    want["kernels"].update(dict.fromkeys(names[2:], 0))
    row = {"phase": "parity", "arch": arch, "layers": layers, "n_bits": 2,
           "kv_cache_dtype": kv_cache_dtype, "compute": "float32", "prompts": lens,
           "decode_steps": steps, "logit_rows": int(a.shape[0]), "max_abs_logit_err": err,
           "atol": PARITY_ATOL, "plain_route_writes_kernel_entries": shared,
           "own_kv_entries_max_abs_err": kv_err,
           "logit_scale": a.abs().max().item(), "argmax_agreement": agree,
           "finite": finite, "attention_launches": attn_launches, "matmul_launches": mm_launches,
           "expected_attention_launches": want,
           "admission": "tail prefill" if tail else "bucketed prefill + block scatter",
           "admission_pool_equal_cpu": admission_equal, "plain_packed_backend": plain_pb,
           "pool_words_differing_after_decode": words_differing,
           "kv_exponent_card_equal_cpu": exponents,
           "pass": (finite and err <= PARITY_ATOL and agree == 1.0
                    and (not shared or (kv_err <= PARITY_ATOL
                                        and not any(words_differing.values())))
                    and attn_launches == want
                    and all(admission_equal.values())
                    and (exponents is None or all(v for e in exponents.values()
                                                  for k, v in e.items() if k != "amaxes")))}
    emit(row)
    if not row["pass"]:
        raise Failed(f"parity {arch} {kv_cache_dtype}: {row}")
    return row


# ---------------------------------------------------------------------------
# launch counts: every wrapper counts its own kernel's launches
# ---------------------------------------------------------------------------
def _counters():
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.symog_update import ops as sops

    return {"fixedpoint_matmul": (fops, "launches"),
            "fixedpoint_matmul_tc": (fops, "tc_launches"),
            "fixedpoint_matmul_decode": (fops, "decode_launches"),
            "fixedpoint_matmul_experts": (fops, "experts_launches"),
            "fixedpoint_matmul_experts_tc": (fops, "tc_experts_launches"),
            "fixedpoint_matmul_experts_decode": (fops, "decode_experts_launches"),
            "paged_attention": (aops, "launches"),
            "paged_attention_quant": (aops, "quant_launches"),
            "paged_attention_mla": (aops, "mla_launches"),
            "paged_attention_mla_quant": (aops, "mla_quant_launches"),
            "paged_attention_mla_tc": (aops, "mla_tc_launches"),
            "paged_attention_mla_tc_quant": (aops, "mla_tc_quant_launches"),
            "symog_update": (sops, "launches")}


def zero_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def _capacity(cfg, bucket: int) -> int:
    """Rows per expert of a bucketed prefill (``moe_apply``'s C)."""
    return max(1, int(math.ceil(cfg.capacity_factor * bucket * cfg.top_k / cfg.n_experts)))


MATMUL_KERNEL = {"streaming": "fixedpoint_matmul", "tensor_core": "fixedpoint_matmul_tc",
                 "decode": "fixedpoint_matmul_decode"}


def _matmul_counts(n_2d: int, n_experts: int, decode_steps: int, buckets, cfg=None, *,
                   head: bool = False, decode_2d: int = None):
    """Launches of the matmul kernels on a serve path, each bf16 call on
    the kernel the route rule picks for its rows: per decode step
    ``decode_2d`` (default ``n_2d``) 2-D launches at M = 4 slots and
    ``n_experts`` experts launches at C = 4; per admission of ``bucket``
    tokens ``n_2d`` 2-D launches at M = bucket and ``n_experts`` at C =
    ``_capacity``.  ``head``: the fp32 head adds one streaming launch per
    decode step (M = 4) and per admission (M = 1)."""
    import torch
    from repro_torch.kernels.fixedpoint_matmul import ops as fops

    out = dict.fromkeys(list(MATMUL_KERNEL.values()) +
                        [k.replace("matmul", "matmul_experts") for k in MATMUL_KERNEL.values()], 0)

    def add(n, rows, experts=False):
        name = MATMUL_KERNEL[fops._pick_route(torch.bfloat16, rows, True)]
        out[name.replace("matmul", "matmul_experts") if experts else name] += n

    add((n_2d if decode_2d is None else decode_2d) * decode_steps, DECODE_TOKENS)
    if n_experts:
        add(n_experts * decode_steps, DECODE_TOKENS, experts=True)
    for b in buckets:
        add(n_2d, b)
        if n_experts:
            add(n_experts, _capacity(cfg, b), experts=True)
    if head:
        out["fixedpoint_matmul"] += decode_steps + len(buckets)
    return out


def _record_admissions(torch, fns):
    """Wrap the scheduler's admission steps (the bucketed prefill + block
    scatter, and the tail prefill), each with its first token, as
    ``timed_decode`` wraps decode: host clock between synchronizations, each
    admission's bucket and ms.  Returns (record, restore)."""
    inner = {k: getattr(fns, k) for k in ("admit_step", "admit_prefix_step")}
    rec = {"buckets": [], "ms": []}

    def wrap(make):
        def admit(bucket, block_size):
            fn = make(bucket, block_size)

            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t) * 1e3)
                rec["buckets"].append(int(bucket))
                return out

            return run

        return admit

    for k, make in inner.items():
        setattr(fns, k, wrap(make))
    return rec, lambda: [setattr(fns, k, make) for k, make in inner.items()]


# ---------------------------------------------------------------------------
# phase 5: full-width serve through the scheduler
# ---------------------------------------------------------------------------
def phase_serve(torch, dev, arch: str, kv_cache_dtype: str, seed: int, expected,
                layers: int = 0, build=None, max_len: int = 512, lens=None):
    """Serve the seeded traffic (4 slots, block 16, max_len 512, 8 requests
    of 24..400 prompt tokens, or of ``lens`` tokens under ``max_len``, 32
    new tokens each) through the
    continuous-batching scheduler from a 2-bit packed artifact of ``arch``
    at full width and all its layers (``layers`` > 0 cuts the depth), made
    on the card from random weights (``seed``) by ``symog_init`` +
    ``pack_tree`` (``build(cfg, seed)`` -> (artifact, n_params, seconds by
    step) instead, for a model too large to hold in fp32).
    ``expected(cfg, stats, buckets)`` gives every kernel's launch count on
    this path (``buckets``: each admission's prompt bucket, in order): the
    counts are zeroed just before the serve and read just after.  Each
    admission is timed as each decode step is.
    Returns the row (emitted by the caller, which may add to it), the
    engine, the requests, the serve config and the tokens."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import SymogConfig, symog_init
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.models import init_lm
    from repro_torch.nn.tree import tree_leaves
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    cfg = dataclasses.replace(configs.get_config(arch), kv_cache_dtype=kv_cache_dtype)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    if build is not None:
        tree, n_params, secs = build(cfg, seed)
        eng = ServeEngine(cfg, tree, max_len=max_len, compute_dtype=torch.bfloat16, device=dev)
        del tree
    else:
        t_init = time.perf_counter()
        params = init_lm(seed, cfg, device=dev)
        torch.cuda.synchronize()
        t_symog = time.perf_counter()
        n_params = sum(t.numel() for t in tree_leaves(params))
        scfg = SymogConfig(n_bits=2)
        state = symog_init(params, scfg)
        torch.cuda.synchronize()
        t_pack = time.perf_counter()
        eng = ServeEngine.from_symog(cfg, params, state, scfg, max_len=max_len,
                                     compute_dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        t_done = time.perf_counter()
        del params, state
        secs = {"init_s": t_symog - t_init, "symog_init_s": t_pack - t_symog,
                "pack_s": t_done - t_pack}
    build_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    lens = rng.integers(24, 401, size=8) if lens is None else np.asarray(lens)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=int(L)), max_new_tokens=32)
            for L in lens]
    sc = ServeConfig(n_slots=4, block_size=16)
    fns = eng.scheduler_fns(greedy=True, top_k=0)
    inner = fns.decode_step
    dec = {"s": 0.0, "rows": 0, "steps": 0, "ms": []}

    def timed_decode(params, caches, tokens, pos, active, *rest):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(params, caches, tokens, pos, active, *rest)
        torch.cuda.synchronize()
        dec["ms"].append((time.perf_counter() - t) * 1e3)
        dec["s"] += dec["ms"][-1] / 1e3
        dec["rows"] += int(active.sum().item())
        dec["steps"] += 1
        return out

    fns.decode_step = timed_decode
    adm, restore = _record_admissions(torch, fns)
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    comps, sched = eng.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    fns.decode_step = inner
    restore()
    peak = torch.cuda.max_memory_allocated(dev)
    st = sched.stats
    want = expected(cfg, st, adm["buckets"])
    prefill_s = sum(adm["ms"]) / 1e3
    tokens = [list(map(int, c.tokens)) for c in comps]
    reasons = sorted({c.finish_reason for c in comps})
    lengths_ok = all(len(c.tokens) == 32 or c.finish_reason == "eos" for c in comps)
    tokens_ok = all(0 <= t < cfg.vocab_size for a in tokens for t in a)
    row = {
        "phase": "serve", "arch": arch, "layers": cfg.n_layers, "params": n_params, "n_bits": 2,
        "kv_cache_dtype": kv_cache_dtype, "compute": "bfloat16", "n_slots": 4, "block_size": 16,
        "max_len": max_len, "requests": len(reqs), "prompt_lens": [int(x) for x in lens],
        "new_tokens": 32, **secs, "build_peak_device_bytes": build_peak,
        "wall_s": wall, "decode_steps": st["decode_steps"],
        "prefills": st["prefills"], "preemptions": st["preemptions"],
        "admitted_mid_run": sum(1 for c in comps if c.admitted_step > 0),
        "finish_reasons": reasons, "tokens_emitted": st["tokens_emitted"],
        "decode_tokens_per_s": dec["rows"] / dec["s"] if dec["s"] else None,
        "decode_step_ms": dec["s"] / max(dec["steps"], 1) * 1e3,
        "decode_step_ms_p50_max": [float(np.percentile(dec["ms"], 50)), max(dec["ms"])]
        if dec["ms"] else None,
        "end_to_end_tokens_per_s": st["tokens_emitted"] / wall,
        "prefill_s": prefill_s, "prefill_share_of_wall": prefill_s / wall,
        "prefill_ms": [[b, ms] for b, ms in zip(adm["buckets"], adm["ms"])],
        "tc_min_rows": fops.TC_MIN_ROWS, "decode_max_rows": fops.DECODE_MAX_ROWS,
        "kv_pool_bytes": sched.cache_bytes(), "weight_bytes": eng.weight_bytes(),
        "peak_device_bytes": peak, "launches": counts, "expected_launches": want,
    }
    # every kernel the path runs must have launched, each exactly as often
    # as the path implies (so every bf16 matmul ran on the kernel the rule
    # picks for its rows: decode steps and small admissions on the decode
    # kernel, larger admissions on the tensor cores; the fp32 head on the
    # streaming kernel)
    row["pass"] = (set(reasons) <= {"length", "eos"} and lengths_ok and tokens_ok
                   and len(adm["buckets"]) == st["prefills"]
                   and counts == want and all(counts[k] > 0 for k, n in want.items() if n))
    return row, eng, reqs, sc, tokens


def report(row):
    emit(row)
    if not row["pass"]:
        raise Failed(f"{row['phase']} {row['arch']} failed: {row}")
    return row


def phase_serve_internlm2(torch, dev):
    from repro_torch.models.layers import embed_logits

    def expected(cfg, st, buckets):
        # every packed projection of every layer, once per decode step and
        # once per admission prefill (the prefill cache reuses attention's k/v)
        return {**_matmul_counts(7 * cfg.n_layers, 0, st["decode_steps"], buckets),
                "paged_attention": cfg.n_layers * st["decode_steps"],
                "paged_attention_quant": 0, **dict.fromkeys(MLA_COUNTS, 0), "symog_update": 0}

    row, eng, *_ = phase_serve(torch, dev, "internlm2-1.8b", "bf16", 7, expected)
    # the tied head: the packed 92544x2048 table is dequantized on every call
    h = torch.randn((4, 1, eng.cfg.d_model), device=dev, dtype=torch.bfloat16)
    row["head_dequant_matmul_ms"] = timed(lambda a: embed_logits(eng.params["embed"], a), [(h,)],
                                          torch)
    return report(row), eng


def kernel_times(evs):
    """[(name, device us, count)] of the device-side entries of a profiler's
    ``key_averages()`` (kernels, copies, memsets), largest first.  An
    operator's entry (``aten::mm``) repeats the device time of the kernels
    it launched, so summing every entry would count each kernel twice."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    out = [(e.key, dev_us(e), e.count) for e in evs if e.device_type == DeviceType.CUDA]
    return sorted((k for k in out if k[1] > 0), key=lambda k: k[1], reverse=True)


# ---------------------------------------------------------------------------
# phase 6: where a decode step's time goes (host profile + device busy share)
# ---------------------------------------------------------------------------
# the matmul kernels by route and form, as the profiler names them
MATMUL_GROUPS = {"decode_experts": ("fpmm_decode", "true>"),
                 "decode_2d": ("fpmm_decode", "false>"),
                 "tensor_core": ("fpmm_tc", ""), "streaming": ("fpmm_", "")}


# the MLA kernels, as the profiler names them
MLA_GROUPS = {"tensor_core": "mla_decode_tc", "partial": "mla_partial",
              "combine": "attn_combine"}


def _mla_groups(kern, steps: int):
    """Device ms a step of the MLA kernels by route (``attn_combine`` is
    mla_partial's second launch)."""
    return {g: sum(us for name, us, _ in kern if k in name) / steps / 1e3
            for g, k in MLA_GROUPS.items()}


def _matmul_groups(kern, steps: int):
    """Device ms a step by matmul group (first match wins, in the order of
    MATMUL_GROUPS; the streaming group is fpmm_partial + fpmm_finish)."""
    out = dict.fromkeys(MATMUL_GROUPS, 0.0)
    for name, us, _ in kern:
        for g, (a, b) in MATMUL_GROUPS.items():
            if a in name and b in name:
                out[g] += us / steps / 1e3
                break
    return out


def _parent_mla_route(*args) -> str:
    """The MLA route rule before the tensor-core kernel: every call on
    ``mla_partial`` + ``attn_combine``."""
    return "partial"


def phase_profile(torch, dev, eng, steps: int = 4, mla_rule=None):
    """A few decode steps of ``eng``: step ms, host functions (cProfile),
    device busy time and top kernels (torch.profiler), the matmul kernels'
    device ms by route and form, and (MLA models) the MLA kernels' device
    ms.  ``mla_rule`` replaces the MLA route rule for this phase only (the
    parent's rule, to measure the step as it was in one run with the
    change)."""
    from repro_torch.kernels.paged_attention import ops as aops

    if mla_rule is None:
        return _profile(torch, dev, eng, steps)
    inner = aops._mla_route
    aops._mla_route = mla_rule
    try:
        row = _profile(torch, dev, eng, steps, rule=mla_rule.__name__)
    finally:
        aops._mla_route = inner
    return row


def _profile(torch, dev, eng, steps: int, rule: str = "_mla_route"):
    import cProfile
    import pstats

    import numpy as np
    from repro_torch.serve import Request, Scheduler, ServeConfig

    rng = np.random.default_rng(1)
    sched = Scheduler(eng, ServeConfig(n_slots=4, block_size=16))
    for _ in range(4):
        sched.submit(Request(tokens=rng.integers(0, eng.cfg.vocab_size, size=300),
                             max_new_tokens=64))
    for _ in range(3):  # admit all four, then two warm decode steps
        sched.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    row = {"phase": "profile", "arch": eng.cfg.name, "layers": eng.cfg.n_layers,
           "kv_cache_dtype": eng.cfg.kv_cache_dtype, "live_slots": sched._n_live,
           "route_rule": rule, "decode_step_ms": step_ms}
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    top = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:12]
    row["host_top_tottime_ms_per_step"] = [
        [f"{os.path.basename(k[0])}:{k[1]}:{k[2]}", v[2] / steps * 1e3] for k, v in top
    ]
    # Only the profiler's own calls may fail softly (it is untried on some
    # machines); an error raised by the port's steps fails the script.
    tp = None
    try:
        from torch.profiler import ProfilerActivity, profile

        tp = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        tp.start()
    except Exception as e:
        row["device_busy_ms_per_step"] = f"not measured ({type(e).__name__}: {e})"
        tp = None
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tp is not None:
        try:
            tp.stop()
            evs = tp.key_averages()
        except Exception as e:
            row["device_busy_ms_per_step"] = f"not measured ({type(e).__name__}: {e})"
            evs = None
        if evs is not None:
            kern = kernel_times(evs)
            busy_us = sum(us for _, us, _ in kern)
            row["profiled_step_ms"] = wall / steps * 1e3
            row["device_busy_ms_per_step"] = busy_us / steps / 1e3
            row["device_idle_share"] = 1.0 - busy_us / 1e6 / wall if wall else None
            row["device_top_ms_per_step"] = [[k[:60], us / steps / 1e3, n // steps]
                                             for k, us, n in kern[:10]]
            row["matmul_device_ms_per_step"] = _matmul_groups(kern, steps)
            if eng.cfg.use_mla:
                row["mla_device_ms_per_step"] = _mla_groups(kern, steps)
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 7: SYMOG training at full width and depth, then serve the result
# ---------------------------------------------------------------------------
TRAIN_STEPS = 6
TRAIN_TOL = dict(rtol=1e-5, atol=1e-7)  # fused vs composed, tests/test_kernels.py:56-57


def _profiled_step(torch, step, state, batch):
    """One train step under torch.profiler: (state, metrics, symog_update
    device ms, {device busy ms, idle share, GEMM ms, top kernels}, wall ms);
    the two middle fields say "not measured" / None if the trace fails."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof.stop()
    try:
        evs = prof.key_averages()
    except Exception as e:  # the profiler's own failure only
        return state, m, f"not measured ({type(e).__name__}: {e})", None, wall

    kern = kernel_times(evs)
    busy = sum(us for _, us, _ in kern) / 1e3
    upd = sum(us for k, us, _ in kern if "symog_update" in k) / 1e3
    gemm = sum(us for k, us, _ in kern
               if any(t in k.lower() for t in ("gemm", "nvjet", "xmma", "cutlass"))) / 1e3
    return state, m, upd, {"busy_ms": busy, "idle_share": 1.0 - busy / wall, "gemm_ms": gemm,
                           "top": [[k[:60], us / 1e3, n] for k, us, n in kern[:12]]}, wall


def phase_train(torch, dev):
    import numpy as np
    from repro_torch import configs, core, optim
    from repro_torch.data import SyntheticLM, SyntheticLMConfig
    from repro_torch.kernels.symog_update import ops as sops
    from repro_torch.models import init_lm, lm_train_loss
    from repro_torch.nn.tree import flatten_with_paths, tree_leaves
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.train import (composed_update, fused_update, init_train_state,
                                   make_train_step)
    from repro_torch.train.trainer import _accum_grads

    cfg = configs.get_config("internlm2-1.8b")  # full width, all 24 layers
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    params = init_lm(gen, cfg, device=dev)  # fp32 master weights
    n_params = sum(t.numel() for t in tree_leaves(params))
    tx = optim.sgd(momentum=0.9)
    scfg = core.SymogConfig(n_bits=2, total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init_train_state(params, tx, scfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    quant_paths = [p for p, m in state.symog.mask.items() if m]
    rqe_before = core.quant_error_metrics(state.params, state.symog, scfg)["rel_quant_error"].item()
    data = SyntheticLM(SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=512, global_batch=4,
                                         seed=0))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
               for _ in range(TRAIN_STEPS)]
    lr_fn = core.linear_lr(0.01, 0.001, TRAIN_STEPS)

    # step 1 from one set of grads, fused vs composed, leaf by leaf (copies)
    def loss_fn(p, b):
        return lm_train_loss(p, b, cfg, compute_dtype=torch.bfloat16)

    _, _, grads = _accum_grads(loss_fn, state.params, batches[0], 1)
    lam, lr = core.lambda_at(scfg, 0), lr_fn(0)
    g_by, v_by, f_by = (dict(flatten_with_paths(t)) for t in (grads, state.opt_state,
                                                                state.symog.f))
    cmp_rows, cmp_worst, cmp_ok = [], 0.0, True
    for path, w in flatten_with_paths(state.params):
        sub = core.SymogState(f={"w": f_by[path]}, mask={"w": state.symog.mask[path]})
        g = {"w": g_by[path]}
        fp, fv = fused_update({"w": w.clone()}, g, {"w": v_by[path].clone()}, sub, scfg, tx,
                              lr=lr, lam=lam)
        cp, cv = composed_update({"w": w}, g, {"w": v_by[path]}, sub, scfg, tx, lr=lr, lam=lam)
        errs = [(fp["w"] - cp["w"]).abs().max().item(), (fv["w"] - cv["w"]).abs().max().item()]
        ok = bool(torch.allclose(fp["w"], cp["w"], **TRAIN_TOL)
                  and torch.allclose(fv["w"], cv["w"], **TRAIN_TOL))
        cmp_rows.append([path, list(w.shape), errs[0], errs[1], ok])
        cmp_worst, cmp_ok = max(cmp_worst, *errs), cmp_ok and ok
        del fp, fv, cp, cv
    del grads, g_by, v_by
    torch.cuda.empty_cache()
    emit({"phase": "train_step1_fused_vs_composed", "tol": TRAIN_TOL, "leaves": cmp_rows,
          "max_abs_err": cmp_worst, "pass": cmp_ok})
    if not cmp_ok:
        raise Failed("train: fused and composed step-1 updates disagree")

    # the main path: TRAIN_STEPS fused steps through make_train_step
    step = make_train_step(cfg, tx, lr_fn, symog_cfg=scfg, compute_dtype=torch.bfloat16)
    losses, step_ms, per_step_launches = [], [], []
    prof = None
    zero_counts()
    for i, batch in enumerate(batches):
        before = sops.launches
        if i == TRAIN_STEPS - 1:
            state, m, upd_ms, prof, wall = _profiled_step(torch, step, state, batch)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            step_ms.append(wall)
        per_step_launches.append(sops.launches - before)
        losses.append(m["loss"].item())
        emit({"phase": "train_step", "step": i, "loss": losses[-1], "ce": m["ce"].item(),
              "grad_norm": m["grad_norm"].item(), "lr": m["lr"],
              "symog_lambda": m["symog_lambda"], "ms": wall,
              "symog_update_launches": per_step_launches[-1]})
    n_launch = sops.launches
    peak = torch.cuda.max_memory_allocated(dev)
    rqe_after = core.quant_error_metrics(state.params, state.symog, scfg)["rel_quant_error"].item()
    median_ms = float(np.median(step_ms[1:]))  # step 0 warms allocator and kernels
    row = {"phase": "train", "arch": "internlm2-1.8b", "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params, "quantizable_leaves": len(quant_paths),
           "batch": [4, 512], "compute": "bfloat16", "master": "float32", "n_bits": 2,
           "optimizer": "sgd nesterov 0.9, linear_lr 0.01->0.001, SYMOG lambda0 10 alpha 9",
           "symog_init_s": init_s, "losses": losses, "step_ms": step_ms,
           "median_step_ms": median_ms, "symog_update_launches": n_launch,
           "launches_per_step": per_step_launches, "profiled_step_ms": wall,
           "update_device_ms": upd_ms, "profile": prof,
           "update_share_of_step": (upd_ms / median_ms if isinstance(upd_ms, float) else None),
           "peak_device_bytes": peak, "rel_quant_error_before": rqe_before,
           "rel_quant_error_after": rqe_after}
    row["pass"] = (all(math.isfinite(x) for x in losses)
                   and per_step_launches == [len(quant_paths)] * TRAIN_STEPS
                   and len(quant_paths) == 8)
    emit(row)
    if not row["pass"]:
        raise Failed(f"train phase failed: {row}")

    # serve the trained weights, packed, through the kernels
    eng = ServeEngine.from_symog(cfg, state.params, state.symog, scfg, max_len=128,
                                 compute_dtype=torch.bfloat16, device=dev)
    del state, params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(2)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=L), max_new_tokens=8)
            for L in (40, 100)]
    comps = eng.serve(reqs, ServeConfig(n_slots=2, block_size=16))
    srow = {"phase": "train_serve", "requests": len(reqs),
            "tokens": [list(map(int, c.tokens)) for c in comps],
            "finish_reasons": [c.finish_reason for c in comps]}
    srow["pass"] = all(len(c.tokens) == 8 and c.finish_reason == "length" for c in comps)
    emit(srow)
    if not srow["pass"]:
        raise Failed(f"serving the trained model failed: {srow}")
    del eng
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# phase 8: olmoe-1b-7b at full width and depth, 2-bit packed with one Δ per
# expert, served from an int4 SYMOG KV pool
# ---------------------------------------------------------------------------
def phase_serve_olmoe(torch, dev):
    from repro_torch.serve import ServeEngine

    def expected(cfg, st, buckets):
        # every packed projection of every layer per decode step and per
        # prefill: q, k, v, o (+ the lm_head: M = 4 slots at decode, M = 1 at
        # prefill), the experts' gate, up, down
        L = cfg.n_layers
        return {**_matmul_counts(4 * L, 3 * L, st["decode_steps"], buckets, cfg, head=True),
                "paged_attention": 0,  # the pool is int4: every decode read is quantized
                "paged_attention_quant": cfg.n_layers * st["decode_steps"],
                **dict.fromkeys(MLA_COUNTS, 0), "symog_update": 0}

    row, eng, reqs, sc, tokens = phase_serve(torch, dev, "olmoe-1b-7b", "int4_fp", 17, expected)
    cfg = eng.cfg
    f_gate = eng.params["layers0"]["sub0"]["moe"]["experts"]["gate_proj"]["kernel"].f
    per_expert = tuple(f_gate.shape) == (cfg.n_layers, cfg.n_experts)
    again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]
    # the same requests from a bf16 pool of the same artifact: greedy agreement, no gate
    eng16 = ServeEngine(dataclasses.replace(cfg, kv_cache_dtype="bf16"), eng.params, max_len=512,
                        compute_dtype=torch.bfloat16, device=dev)
    comps16, sched16 = eng16.serve(reqs, sc, return_scheduler=True)
    same = total = 0
    for a, c in zip(tokens, comps16):
        same += sum(int(x == y) for x, y in zip(a, c.tokens))
        total += max(len(a), len(c.tokens))
    row.update({"per_expert_f": per_expert, "expert_f_range": [int(f_gate.min()), int(f_gate.max())],
                "kv_pool_bytes_bf16": sched16.cache_bytes(),
                "repeat_tokens_identical": again == tokens,
                "greedy_agreement_vs_bf16_pool": same / max(total, 1)})
    row["pass"] = row["pass"] and per_expert and again == tokens
    del eng16, sched16
    torch.cuda.empty_cache()
    return report(row), eng


# ---------------------------------------------------------------------------
# phase 3f: the absorbed MLA decode kernel (deepseek-v3's shape)
# ---------------------------------------------------------------------------
MLA_SHAPE = dict(B=4, H=128, r=512, rope=64, block=16, max_blocks=32)  # deepseek-v3 decode


def _mla_case(torch, gen, dev, *, B, H, r, rope, block, max_blocks, T, dt, pool, pos_zero,
              q_mult=None):
    """Operands over ~300 cached tokens a row.  ``pool``: 'float' (the
    compute dtype), 'kv_f' (int8 x 2^-5), 'q8'/'q4' (random SYMOG words under
    one exponent per physical block over [-8, 4]) or 'q8w'/'q4w' (the words a
    paged write makes of unit-scale c_kv / k_rope: N(0,1) x 2^s, s in
    [-3, 1] per block, exponents from each block's first token).
    ``pos_zero``: row 0 starts at position 0.  ``q_mult``: the queries'
    scale (default: 1, or 1 / the pool's largest value for 'q8'/'q4')."""
    from repro_torch.models.attention import KV_QMAX, block_scale_exp, pack_int4, quantize_fixed

    n_phys = B * max_blocks + 1
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    pos0 = (torch.randint(280, 320, (B,), generator=gen, device=dev) - (T - 1)).to(torch.int32)
    if pos_zero:
        pos0[0] = 0
    # queries scaled by the pool's largest value for the wide spread, so that
    # logits stay O(1) as in serving: with |c_kv| up to 127 x 2^4 and unit
    # queries the logits reach ~1e3, where fp32 summation order alone moves
    # a near-tied softmax (checked against fp64 below)
    if q_mult is None:
        q_mult = 1.0 / (KV_QMAX[4 if pool == "q4" else 8] * 2**4) if pool in ("q8", "q4") else 1.0
    q_eff = (torch.randn((B, T, H, r), generator=gen, device=dev) * q_mult).to(dt)
    q_rope = (torch.randn((B, T, H, rope), generator=gen, device=dev) * q_mult).to(dt)
    kw = dict(scale=(128 + 64) ** -0.5)  # deepseek-v3: (qk_nope + qk_rope)^-0.5
    pools, exps = [], []
    for w in (r, rope):
        x = torch.randn((n_phys, block, w), generator=gen, device=dev)
        if pool == "float":
            pools.append(x.to(dt))
        elif pool == "kv_f":
            pools.append(torch.clamp(torch.round(x * 0.5 * 32), -127, 127).to(torch.int8))
        else:
            bits = 4 if pool.startswith("q4") else 8
            qmax = KV_QMAX[bits]
            if pool.endswith("w"):
                s = torch.randint(-3, 2, (n_phys, 1, 1), generator=gen, device=dev).float()
                x = x * torch.exp2(s)
                e = block_scale_exp(x[:, 0], qmax)
                m = quantize_fixed(x, e[:, None], qmax)
            else:
                m = torch.randint(-qmax, qmax + 1, (n_phys, block, w), generator=gen,
                                  device=dev).to(torch.int8)
                e = torch.randint(-8, 5, (n_phys,), generator=gen, device=dev).to(torch.int32)
            pools.append(pack_int4(m) if bits == 4 else m)
            exps.append(e)
    if pool == "kv_f":
        kw["kv_scale"] = 2.0**-5
    elif exps:
        kw.update(ckv_scale_exp=exps[0], kr_scale_exp=exps[1],
                  kv_bits=4 if pool.startswith("q4") else 8)
    return q_eff, q_rope, pools[0], pools[1], bt, pos0, kw, q_mult


def _mla_ref64(qe, qr, cp, kp, bt, pos0, *, scale, ckv_scale_exp, kr_scale_exp, kv_bits):
    """``paged_attention_mla_ref`` of a quantized pool in fp64 (float64 for
    the conditioning check only)."""
    import torch

    from repro_torch.kernels.paged_attention.ref import dequant_logical

    c = dequant_logical(cp, ckv_scale_exp, bt, kv_bits=kv_bits).double()
    k = dequant_logical(kp, kr_scale_exp, bt, kv_bits=kv_bits).double()
    T, S = qe.shape[1], c.shape[1]
    q_pos = pos0.long()[:, None] + torch.arange(T, device=qe.device)[None]
    mask = torch.arange(S, device=qe.device)[None, None, None] <= q_pos[:, None, :, None]
    lg = (torch.einsum("bthr,bsr->bhts", qe.double(), c)
          + torch.einsum("bthr,bsr->bhts", qr.double(), k)) * scale
    lg = torch.where(mask, lg, torch.full_like(lg, -1e30))
    return torch.einsum("bhts,bsr->bthr", torch.softmax(lg, dim=-1), c)


def phase_attn_mla(torch, dev):
    """Rows 4 and 5 at deepseek-v3's decode shape (B 4, T 1, 128 heads, r
    512, rope 64, block 16, ~300 tokens a row), also T = 3 with a row at
    position 0: bf16 queries on every pool code, the SYMOG ones with the
    wide exponent spread (queries scaled to O(1) logits), at the bf16 bar,
    through both kernels (forced: the tensor-core ``mla_decode_tc`` and
    ``mla_partial``), each bit-identical over two calls; the rule sends
    every bf16 case to the tensor cores, which must be faster there.  fp32
    queries on float / KV_F pools and on the words a paged write makes at
    the fp32 bar (as phase 3e), on ``mla_partial`` (the rule's choice).
    Then the conditioning check of the wide int8 spread at unit queries
    against fp64."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import (dequant_logical, gather_logical,
                                                         paged_attention_mla_ref)

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    sh = MLA_SHAPE
    B, H, r, rope, block = sh["B"], sh["H"], sh["r"], sh["rope"], sh["block"]
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(1, bf, "float", False), (1, bf, "q4", False), (1, bf, "q8", False),
             (1, bf, "kv_f", False), (3, bf, "q4", True), (3, bf, "float", True),
             (3, bf, "q8", True), (3, bf, "kv_f", True),
             (1, f32, "float", False), (1, f32, "kv_f", False), (1, f32, "q8w", False),
             (1, f32, "q4w", False), (3, f32, "q4w", True), (3, f32, "float", True)]
    rows, main = [], {}
    worst = dict.fromkeys(("partial_float", "partial_quant", "tc_float", "tc_quant"), 0.0)
    for T, dt, pool, pos_zero in cases:
        dname = str(dt).split(".")[-1]
        qe, qr, cp, kp, bt, pos0, kw, q_mult = _mla_case(torch, gen, dev, T=T, dt=dt, pool=pool,
                                                         pos_zero=pos_zero, **sh)
        quant = "kv_bits" in kw
        kind = "quant" if quant else "float"
        rule = aops._mla_route(dt, cp.dtype, kw.get("kv_bits", 0), kw.get("kv_scale", 1.0), r,
                               rope)
        ref = paged_attention_mla_ref(qe, qr, cp, kp, bt, pos0, **kw)
        tol = ATTN_TOL[dname]
        # bytes this run's data needs: q in, out, and each visible block's
        # c_kv and k_rope words (and exponents) once; operations: every query
        # row against every visible key, logits over r + rope and p . c_kv over r
        vis_blocks = ((pos0.long() + T - 1) // block + 1).sum().item()
        blk_bytes = block * (cp.shape[-1] + kp.shape[-1]) * cp.element_size() + (8 if quant else 0)
        io = (2 * qe.numel() + qr.numel()) * qe.element_size() + vis_blocks * blk_bytes \
            + bt.numel() * 4 + B * 4
        keys = (pos0.long()[:, None] + torch.arange(T, device=dev)[None] + 1).sum().item()
        flops = keys * H * 2 * (2 * r + rope)
        b_ms, b_by = bound(io, flops, dname)
        n = copies_for(cp.numel() * cp.element_size() + kp.numel() * kp.element_size())
        qk = ("ckv_scale_exp", "kr_scale_exp")
        args = [(cp.clone(), kp.clone()) + tuple(kw[k].clone() for k in qk if k in kw)
                for _ in range(n)]
        rest = {k: v for k, v in kw.items() if k not in qk}

        def call(fn, **extra):
            return lambda c, k, *e: fn(qe, qr, c, k, bt, pos0, **rest, **dict(zip(qk, e)),
                                       **extra)

        row = {"phase": "kernel", "kernel": "paged_attention_mla" + ("_quant" if quant else ""),
               "B": B, "T": T, "H": H, "r": r, "rope": rope, "block": block, "pool": pool,
               "pool_dtype": str(cp.dtype).split(".")[-1], "q_dtype": dname,
               "row_at_position_0": pos_zero, "q_mult": q_mult, "route": rule, "tol": tol}
        if quant:
            e_all = torch.cat([kw["ckv_scale_exp"], kw["kr_scale_exp"]])
            row["exp_range"] = [int(e_all.min()), int(e_all.max())]
        # each route that takes the call: launched once, counted under its
        # route, within the bar, the same bits on a second call
        ok = True
        for route in (["tc", "partial"] if rule == "tc" else ["partial"]):
            zero_counts()
            out = aops.paged_attention_mla(qe, qr, cp, kp, bt, pos0, **kw, _route=route)
            again = aops.paged_attention_mla(qe, qr, cp, kp, bt, pos0, **kw, _route=route)
            torch.cuda.synchronize()
            got = {k: v for k, v in read_counts().items() if k in MLA_COUNTS and v}
            fam = "paged_attention_mla" + ("_quant" if quant else "")
            want = {fam: 2}
            if route == "tc":
                want["paged_attention_mla_tc" + ("_quant" if quant else "")] = 2
            err = (out.float() - ref.float()).abs().max().item()
            same = bool(torch.equal(out, again))
            r_ok = (bool(torch.allclose(out.float(), ref.float(), **tol)) and got == want
                    and same and out.dtype == dt)
            ok = ok and r_ok
            row[f"{route}_max_abs_err"] = err
            row[f"{route}_bit_identical"] = same
            row[f"{route}_ms"] = timed(call(aops.paged_attention_mla, _route=route), args, torch)
            worst[f"{route}_{kind}"] = max(worst[f"{route}_{kind}"], err)
            if not r_ok:
                row["launches"] = got
        row["max_abs_err"] = row[f"{rule}_max_abs_err"]
        row["ms"] = row[f"{rule}_ms"]
        if rule == "tc":  # the rule's ranks beside 4 and 8 (one cluster each)
            auto = aops._mla_tc_split(B, -(-T * H // aops.MLA_TC_ROWS), bt.shape[1], block,
                                      build.sm_count(dev))
            row["tc_split"] = auto
            row["tc_ms_by_split"] = {s: timed(call(aops.paged_attention_mla, _route="tc",
                                                   _split=s), args, torch)
                                     for s in sorted({4, 8} - {auto})}
            row["tc_faster_than_partial"] = row["tc_ms"] < row["partial_ms"]
            ok = ok and row["tc_faster_than_partial"]
        row["pass"] = ok
        row["plain_ms"] = timed(call(paged_attention_mla_ref), args, torch)
        # library yardstick: SDPA over the gathered (dequantized) cache, one
        # shared key / value head against the H query heads; timed only
        if quant:
            cl = dequant_logical(cp, kw["ckv_scale_exp"], bt, kv_bits=kw["kv_bits"]).to(dt)
            kl = dequant_logical(kp, kw["kr_scale_exp"], bt, kv_bits=kw["kv_bits"]).to(dt)
        else:
            scl = kw.get("kv_scale", 1.0)
            cl = (gather_logical(cp, bt).float() * scl).to(dt)
            kl = (gather_logical(kp, bt).float() * scl).to(dt)
        S = cl.shape[1]
        q_pos = pos0.long()[:, None] + torch.arange(T, device=dev)[None]
        mask = (torch.arange(S, device=dev)[None, None] <= q_pos[:, :, None])[:, None]
        qs = torch.cat([qe, qr], dim=-1).transpose(1, 2)  # (B, H, T, r + rope)
        ks = torch.cat([cl, kl], dim=-1)[:, None]  # (B, 1, S, r + rope)
        vs = cl[:, None]  # (B, 1, S, r)
        nl = copies_for(ks.numel() * ks.element_size() * 2)
        largs = [(qs, ks.clone(), vs.clone()) for _ in range(nl)]
        row["library_ms"] = timed(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, scale=kw["scale"], enable_gqa=True), largs, torch)
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["achieved_GFLOPs"] = flops / (row["ms"] * 1e-3) / 1e9
        del args, largs
        emit(row)
        rows.append(row)
        if T == 1 and dt == bf and pool in ("float", "q4") and kind not in main:
            main[kind] = row
        if not ok:
            raise Failed(f"{row['kernel']} case T={T} {dname} {pool}: {row}")
    # conditioning: the wide int8 spread with unit queries (logits ~1e3): the
    # kernel and the fp32 plain version each against fp64; the kernel's error
    # may not exceed twice the plain version's
    qe, qr, cp, kp, bt, pos0, kw, _ = _mla_case(torch, gen, dev, T=1, dt=f32, pool="q8",
                                                pos_zero=False, q_mult=1.0, **sh)
    r64 = _mla_ref64(qe, qr, cp, kp, bt, pos0, **kw)
    k_err = (aops.paged_attention_mla(qe, qr, cp, kp, bt, pos0, **kw).double() - r64).abs().max()
    p_err = (paged_attention_mla_ref(qe, qr, cp, kp, bt, pos0, **kw).double() - r64).abs().max()
    row = {"phase": "kernel", "kernel": "paged_attention_mla_quant", "check": "conditioning",
           "pool": "q8", "q_dtype": "float32", "q_mult": 1.0,
           "kernel_max_abs_err_vs_fp64": k_err.item(), "plain_max_abs_err_vs_fp64": p_err.item(),
           "out_max_abs": r64.abs().max().item(), "pass": bool(k_err <= 2 * p_err)}
    emit(row)
    rows.append(row)
    if not row["pass"]:
        raise Failed(f"paged_attention_mla_quant conditioning check: {row}")
    return rows, worst, main


# ---------------------------------------------------------------------------
# phase 9: deepseek-v3 at full width, 7 layers (3 dense + 4 MoE), 2-bit
# packed with one Δ per (layer, expert), served from an int4 MLA pool
# ---------------------------------------------------------------------------
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_LAYERS = 7  # the 3 leading dense layers and 4 MoE layers: one card's worth


def build_layerwise(torch, dev, cfg, seed: int):
    """The 2-bit SYMOG artifact of ``cfg`` built one layer at a time: each
    layer is drawn on the card (``block_init``), gets its own Δ per leaf
    (per expert on the routed stacks) from ``symog_init``, is packed by
    ``pack_tree`` and freed, and its packed leaves are copied into the
    group's stacked leaves.  Peak: one layer's fp32 weights (46 GB for a
    deepseek-v3 MoE layer) beside what is packed so far; the whole fp32
    tree (198.5 GB at 7 layers) never exists.  The embedding, final norm
    and head come from ``init_lm`` at zero layers; the MTP module, which
    serving does not read, is left out.  Returns (artifact, parameter
    count, seconds by step)."""
    from repro_torch.core import Packed, SymogConfig, pack_tree, symog_init
    from repro_torch.models import init_lm, scan_groups
    from repro_torch.models.blocks import block_init
    from repro_torch.nn.tree import tree_leaves, tree_map

    scfg = SymogConfig(n_bits=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    secs = {"init_s": 0.0, "symog_init_s": 0.0, "pack_s": 0.0}
    n_params = 0

    def pack_part(make):
        nonlocal n_params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part = make()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_params += sum(t.numel() for t in tree_leaves(part))
        st = symog_init(part, scfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        packed = pack_tree(part, st, scfg)
        del part, st
        torch.cuda.synchronize()
        secs["init_s"] += t1 - t0
        secs["symog_init_s"] += t2 - t1
        secs["pack_s"] += time.perf_counter() - t2
        return packed

    top = dataclasses.replace(cfg, n_layers=0, use_mtp=False)
    tree = pack_part(lambda: init_lm(gen, top, device=dev))
    for g in scan_groups(cfg):
        stacked = None
        for i in range(g.count):
            layer = pack_part(lambda: block_init(gen, cfg, g.unit[0]))
            if not g.stacked:
                stacked = layer
                break
            if stacked is None:  # the group's leaves, filled layer by layer
                stacked = tree_map(
                    lambda x: Packed(x.data.new_empty((g.count,) + tuple(x.data.shape)),
                                     x.n_bits, x.f.new_empty((g.count,) + tuple(x.f.shape)))
                    if isinstance(x, Packed) else x.new_empty((g.count,) + tuple(x.shape)),
                    layer)

            def put(dst, src, i=i):
                if isinstance(src, Packed):
                    dst.data[i] = src.data
                    dst.f[i] = src.f
                else:
                    dst[i] = src

            tree_map(put, stacked, layer)
            del layer
        tree[g.name] = {"sub0": stacked}
        torch.cuda.empty_cache()
    return tree, n_params, secs


def _probe_first_decode(torch, eng):
    """Have the engine's first decode step keep what it reads: the logits of
    every active row and, per layer, the cached c_kv / k_rope as its pool
    holds them before the step writes (dequantized to fp32, the rows'
    valid positions only).  The step runs ``decode_lm`` once, as the
    engine's own step does.  Returns (box, restore)."""
    from repro_torch.kernels.paged_attention.ref import dequant_logical, gather_logical
    from repro_torch.models import decode_lm
    from repro_torch.serve.engine import _greedy

    fns = eng.scheduler_fns(greedy=True, top_k=0)
    inner = fns.decode_step
    box = {"c_kv": [], "k_rope": []}

    def step(params, caches, tokens, pos, active, seed0, bt, *sample):
        if "logits" in box:
            return inner(params, caches, tokens, pos, active, seed0, bt, *sample)
        rows = active.nonzero()[:, 0]
        S = int(pos[rows].max())
        valid = torch.arange(S, device=pos.device)[None] < pos[rows, None]
        for g in sorted(caches):
            sub = caches[g]["sub0"]
            for n in box:
                pool = sub[n]
                stacked = pool.dim() == 4
                for i in range(pool.shape[0] if stacked else 1):
                    p = pool[i] if stacked else pool
                    if n + "_scale" in sub:
                        e = sub[n + "_scale"][i] if stacked else sub[n + "_scale"]
                        v = dequant_logical(p, e, bt[rows], kv_bits=eng.kv_quant_bits)
                    else:
                        v = gather_logical(p, bt[rows]).float()
                    box[n].append(v[:, :S][valid])
        logits, caches = decode_lm(params, caches, tokens[:, None], pos, eng.cfg,
                                   compute_dtype=eng.compute_dtype, active=active,
                                   block_tables=bt)
        box["logits"] = logits[rows, -1].float()
        return _greedy(logits[:, -1, :]), pos + active.to(torch.int32), caches

    fns.decode_step = step
    return box, lambda: setattr(fns, "decode_step", inner)


def _first_step_gap(torch, box4, box16):
    """The int4 and bf16 pools at the first decode step, where both serves
    hold the same prompts and feed the same tokens: per active row the
    bf16 pool's top-1 - top-2 logit margin beside the largest logit gap
    between the pools (a greedy token flips only where the gap reaches the
    margin), the logit spread, and the int4 pool's error against the bf16
    pool's values (RMS error over RMS value, and the largest error)."""
    a, b = box16["logits"], box4["logits"]
    top2 = a.topk(2, dim=-1).values
    out = {"rows": int(a.shape[0]),
           "top1_minus_top2_bf16_pool": (top2[:, 0] - top2[:, 1]).tolist(),
           "max_abs_logit_gap": (a - b).abs().max(-1).values.tolist(),
           "argmax_differs": (a.argmax(-1) != b.argmax(-1)).tolist(),
           "logit_std_bf16_pool": a.std(-1).tolist()}
    for n in ("c_kv", "k_rope"):
        ref, q = torch.cat(box16[n]), torch.cat(box4[n])
        d = q - ref
        out[f"{n}_int4_rel_rms_err"] = (d.square().mean().sqrt()
                                        / ref.square().mean().sqrt()).item()
        out[f"{n}_int4_max_abs_err"] = d.abs().max().item()
        out[f"{n}_max_abs_value"] = ref.abs().max().item()
    return out


def phase_serve_deepseek(torch, dev):
    from repro_torch.serve import ServeEngine

    def expected(cfg, st, buckets):
        # per MLA layer: q_a, q_b, kv_a, k_rope, kv_b_k, kv_b_v and o at prefill;
        # at decode kv_b_k / kv_b_v are absorbed through as_dense (no kernel);
        # per layer also the dense MLP's or the shared expert's 3; + the head
        # (M = 4 slots at decode, M = 1 at prefill)
        L, n_moe = cfg.n_layers, cfg.n_layers - cfg.n_dense_layers
        return {**_matmul_counts(10 * L, 3 * n_moe, st["decode_steps"], buckets, cfg,
                                 head=True, decode_2d=8 * L),
                "paged_attention": 0, "paged_attention_quant": 0,
                # the pool is int4: every decode read is quantized, each on the
                # tensor-core kernel (bf16 queries), one launch a call
                "paged_attention_mla": 0, "paged_attention_mla_tc": 0,
                "paged_attention_mla_quant": L * st["decode_steps"],
                "paged_attention_mla_tc_quant": L * st["decode_steps"], "symog_update": 0}

    row, eng, reqs, sc, tokens = phase_serve(
        torch, dev, DEEPSEEK, "int4_fp", 23, expected, layers=DEEPSEEK_LAYERS,
        build=lambda cfg, seed: build_layerwise(torch, dev, cfg, seed))
    cfg = eng.cfg
    moe = eng.params["layers1"]["sub0"]["moe"]
    f_gate = moe["experts"]["gate_proj"]["kernel"].f
    n_moe = cfg.n_layers - cfg.n_dense_layers
    per_expert = (tuple(f_gate.shape) == (n_moe, cfg.n_experts)
                  and tuple(moe["shared"]["gate_proj"]["kernel"].f.shape) == (n_moe,))
    box4, restore = _probe_first_decode(torch, eng)
    again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]
    restore()
    # the same requests from a bf16 MLA pool of the same artifact: the float
    # kernel on every decode read (counts gated), greedy agreement printed
    eng16 = ServeEngine(dataclasses.replace(cfg, kv_cache_dtype="bf16"), eng.params, max_len=512,
                        compute_dtype=torch.bfloat16, device=dev)
    box16, restore16 = _probe_first_decode(torch, eng16)
    adm16, restore_adm16 = _record_admissions(torch, eng16.scheduler_fns(greedy=True, top_k=0))
    zero_counts()
    comps16, sched16 = eng16.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    counts16 = read_counts()
    restore16()
    restore_adm16()
    first_step = _first_step_gap(torch, box4, box16)
    del box4, box16
    steps16 = sched16.stats["decode_steps"]
    want16 = dict(expected(cfg, sched16.stats, adm16["buckets"]),
                  paged_attention_mla=cfg.n_layers * steps16,
                  paged_attention_mla_tc=cfg.n_layers * steps16,
                  paged_attention_mla_quant=0, paged_attention_mla_tc_quant=0)
    same = total = 0
    for a, c in zip(tokens, comps16):
        same += sum(int(x == y) for x, y in zip(a, c.tokens))
        total += max(len(a), len(c.tokens))
    row.update({"per_expert_f": per_expert,
                "expert_f_range": [int(f_gate.min()), int(f_gate.max())],
                "kv_pool_bytes_bf16": sched16.cache_bytes(),
                "kv_bytes_per_token_layer": {"bf16": 2 * (cfg.kv_lora_rank + cfg.qk_rope_dim),
                                             "int4": (cfg.kv_lora_rank + cfg.qk_rope_dim) // 2},
                "repeat_tokens_identical": again == tokens,
                "greedy_agreement_vs_bf16_pool": same / max(total, 1),
                "first_decode_step_vs_bf16_pool": first_step,
                "bf16_pool_launches": counts16, "bf16_pool_expected_launches": want16})
    row["pass"] = row["pass"] and per_expert and again == tokens and counts16 == want16
    del eng16, sched16
    torch.cuda.empty_cache()
    return report(row), eng


# ---------------------------------------------------------------------------
# phase 10: gemma3-4b at full width and depth, 2-bit packed, served from an
# int4 SYMOG KV pool through the tail-prefill admission, greedy and sampled
# ---------------------------------------------------------------------------
# prompt lengths: buckets 32..2048, and the 1,024-token window of the local
# layers binds in admission and in decode for the two longest
GEMMA3_LENS = [400, 24, 1800, 100, 900, 1300, 50, 200]
GEMMA3_MAX_LEN = 2048
GEMMA3_SAMPLING = dict(temperature=0.7, top_k=50, seed=123)


def phase_serve_gemma3(torch, dev):
    from repro_torch.models.layers import embed_logits
    from repro_torch.serve import ServeConfig, ServeEngine

    def expected(cfg, st, buckets):
        # every packed projection of every layer once per decode step and once
        # per admission (the tied head dequantizes the table: no kernel); the
        # int4 pool's kernel once per layer and decode step and once per
        # layer and admission (the tail prefill attends the pool)
        L = cfg.n_layers
        return {**_matmul_counts(7 * L, 0, st["decode_steps"], buckets),
                "paged_attention": 0,
                "paged_attention_quant": L * (st["decode_steps"] + len(buckets)),
                **dict.fromkeys(MLA_COUNTS, 0), "symog_update": 0}

    row, eng, reqs, sc, tokens = phase_serve(torch, dev, "gemma3-4b", "int4_fp", 29, expected,
                                             max_len=GEMMA3_MAX_LEN, lens=GEMMA3_LENS)
    cfg = eng.cfg
    L = cfg.n_layers
    row["tail_prefill_launches"] = L * row["prefills"]
    again = [list(map(int, c.tokens)) for c in eng.serve(reqs, sc)]

    def streams(rs, n_slots):
        return [list(map(int, c.tokens)) for c in eng.serve(
            rs, ServeConfig(n_slots=n_slots, block_size=16, **GEMMA3_SAMPLING))]

    t0 = time.perf_counter()
    sampled = {"4_slots": streams(reqs, 4), "4_slots_again": streams(reqs, 4),
               "3_slots": streams(reqs, 3),
               "staggered": streams([dataclasses.replace(r, arrival=4 * i)
                                     for i, r in enumerate(reqs)], 4)}
    sampled_s = time.perf_counter() - t0
    base = sampled["4_slots"]
    sampled_same = all(v == base for v in sampled.values())
    # the same requests from a bf16 pool of the same artifact: bucketed
    # admissions, the float kernel on every decode read (counts gated)
    eng16 = ServeEngine(dataclasses.replace(cfg, kv_cache_dtype="bf16"), eng.params,
                        max_len=GEMMA3_MAX_LEN, compute_dtype=torch.bfloat16, device=dev)
    adm16, restore_adm16 = _record_admissions(torch, eng16.scheduler_fns(greedy=True, top_k=0))
    zero_counts()
    comps16, sched16 = eng16.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    counts16 = read_counts()
    restore_adm16()
    steps16 = sched16.stats["decode_steps"]
    want16 = dict(expected(cfg, sched16.stats, adm16["buckets"]),
                  paged_attention=L * steps16, paged_attention_quant=0)
    same = total = 0
    for a, c in zip(tokens, comps16):
        same += sum(int(x == y) for x, y in zip(a, c.tokens))
        total += max(len(a), len(c.tokens))
    h = torch.randn((4, 1, cfg.d_model), device=dev, dtype=torch.bfloat16)
    row.update({"windows_binding": sum(int(n) > cfg.window for n in GEMMA3_LENS),
                "repeat_tokens_identical": again == tokens,
                "sampling": GEMMA3_SAMPLING, "sampled_runs_s": sampled_s,
                "sampled_streams_identical": {k: v == base for k, v in sampled.items()},
                "sampled_differs_from_greedy": base != tokens,
                "kv_pool_bytes_bf16": sched16.cache_bytes(),
                "bf16_pool_prefill_ms": [[b, ms] for b, ms in zip(adm16["buckets"],
                                                                  adm16["ms"])],
                "greedy_agreement_vs_bf16_pool": same / max(total, 1),
                "bf16_pool_launches": counts16, "bf16_pool_expected_launches": want16,
                # the tied 262,144-row read-out as the serve runs it: the
                # packed table dequantized to fp32, then torch.matmul
                "head_dequant_matmul_ms": events_ms(lambda: embed_logits(eng.params["embed"], h),
                                                    5, torch)})
    row["pass"] = (row["pass"] and again == tokens and sampled_same and base != tokens
                   and counts16 == want16)
    del eng16, sched16
    torch.cuda.empty_cache()
    return report(row), eng


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch import configs
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    build.library()
    regs = [ln.strip() for ln in build.build_log.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "hash": build.source_hash(),
          "ptxas": regs[:40]})

    seconds = {}

    def run(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    try:
        fp_rows, fp_decode, fp_prefill = run("3a fixedpoint_matmul", phase_fpmm, torch, dev)
        attn_rows, at_err, at_main = run("3b paged_attention", phase_attn, torch, dev)
        sy_rows, sy_err, sy_full = run("3c symog_update", phase_symog, torch, dev,
                                       configs.get_config("internlm2-1.8b"))
        fe_rows, fe_decode, fe_prefill = run("3d fixedpoint_matmul_experts",
                                             phase_fpmm_experts, torch, dev)
        head = run("3d fixedpoint_matmul_experts", phase_fpmm_head, torch, dev)
        fpd_rows, fpd_layer = run("3a fixedpoint_matmul deepseek", phase_fpmm_deepseek,
                                  torch, dev)
        fed_rows, fed_decode, fed_prefill = run("3d fixedpoint_matmul_experts deepseek",
                                                phase_fpmm_experts_deepseek, torch, dev)
        fpg_rows, fpg_layer, fpg_head = run("3a fixedpoint_matmul gemma3", phase_fpmm_gemma3,
                                            torch, dev)
        cx_rows, cross = run("3g crossover", phase_crossover, torch, dev)
        aq_rows, aq_err, aq_main = run("3e paged_attention_quant", phase_attn_quant, torch, dev)
        mla_rows, mla_err, mla_main = run("3f paged_attention_mla", phase_attn_mla, torch, dev)
        run("4 parity internlm2", phase_parity, torch, dev, PARITY_LAYERS)
        for arch in ("gemma2-27b", "granite-34b"):
            run("4 parity " + arch, phase_parity, torch, dev, PARITY_LAYERS, arch=arch)
        # gemma3 admitted through the tail prefill, from a bf16 pool and from
        # an int4 pool (its writes held to the CPU's, the plain route reading
        # the kernel route's words), logits held to the plain path both
        # times; 6 layers so that its global layer (rope base 1e6, no window)
        # is among them
        run("4 parity gemma3-4b", phase_parity, torch, dev, 6, arch="gemma3-4b", tail=True)
        par_g3 = run("4 parity gemma3-4b", phase_parity, torch, dev, 6, arch="gemma3-4b",
                     kv_cache_dtype="int4_fp")
        par_olmoe = run("4 parity olmoe", phase_parity, torch, dev, PARITY_LAYERS,
                        arch="olmoe-1b-7b")
        run("4 parity olmoe", phase_parity, torch, dev, PARITY_LAYERS, arch="olmoe-1b-7b",
            kv_cache_dtype="int4_fp")
        # deepseek-v3, 3 dense + 1 MoE layer: one layer-by-layer artifact, served
        # from a bf16 and from an int4 MLA pool
        art = {}

        def ds_build(cfg):
            if "tree" not in art:
                art["tree"] = build_layerwise(torch, dev, cfg, 11)[0]
            return art["tree"]

        par_ds = {kv: run("4 parity deepseek", phase_parity, torch, dev, PARITY_LAYERS,
                          arch=DEEPSEEK, kv_cache_dtype=kv, build=ds_build, plain_packed="kernel")
                  for kv in ("bf16", "int4_fp")}
        del art
        torch.cuda.empty_cache()
        serve, eng = run("5 serve internlm2", phase_serve_internlm2, torch, dev)
        run("6 profile internlm2", phase_profile, torch, dev, eng)
        del eng
        torch.cuda.empty_cache()
        train = run("7 train internlm2", phase_train, torch, dev)
        olmoe, eng = run("8 serve olmoe", phase_serve_olmoe, torch, dev)
        run("8 profile olmoe", phase_profile, torch, dev, eng)
        del eng
        torch.cuda.empty_cache()
        deepseek, eng = run("9 serve deepseek", phase_serve_deepseek, torch, dev)
        # the decode step under the parent's MLA route rule and under this
        # one, in turns (parent, this, this, parent): host time spreads widely
        for rule in (_parent_mla_route, None, None, _parent_mla_route):
            run("9 profile deepseek", phase_profile, torch, dev, eng, mla_rule=rule)
        del eng
        torch.cuda.empty_cache()
        gemma3, eng = run("10 serve gemma3", phase_serve_gemma3, torch, dev)
        run("10 profile gemma3", phase_profile, torch, dev, eng)
        del eng
        torch.cuda.empty_cache()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "seconds", "by_phase": seconds,
          "total_s": time.perf_counter() - t_start})
    mm_rows = fp_rows + fpd_rows + fpg_rows + [head] + [r for r in cx_rows if "M" in r]
    ex_rows = fe_rows + fed_rows + [r for r in cx_rows if "C" in r]
    # at every case the rule sends to the tensor cores, they must be faster
    tc_cases = [r for r in mm_rows + ex_rows if r["route"] == "tensor_core" and "stream_ms" in r]
    tc_faster = all(r["tc_ms"] < r["stream_ms"] for r in tc_cases)
    # and at every timed case the rule sends to the decode kernel, it must
    # beat the streaming kernel it replaces there
    dec_cases = [r for r in mm_rows + ex_rows if r["route"] == "decode" and "stream_ms" in r]
    dec_faster = all(r["dec_ms"] < r["stream_ms"] for r in dec_cases)
    # the streaming kernels now serve fp32 calls only: the MoE serves' fp32
    # head, and (experts form) the fp32 parity phases
    fe_fp32 = {k: sum(r[k] for r in fe_rows if r["dtype"] == "float32" and r["C"] == 4
                      and r["n_bits"] == 2) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    par_ex = par_olmoe["matmul_launches"]["kernels"]["fixedpoint_matmul_experts"]
    summary = [
        {"name": "fixedpoint_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/kernel.py:30",
         "launches": olmoe["launches"]["fixedpoint_matmul"],
         "max_abs_err": _route_err(mm_rows, "streaming"),
         "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "library_ms": head["library_ms"],
         "work": "olmoe's packed head (the MoE serves' fp32 head) at M=4, K 2048, N 50304, "
                 "2-bit, fp32 x",
         "launches_from": "olmoe-1b-7b serve: the fp32 head, once a decode step and admission",
         "internlm2_decode_layer_streaming_ms": fp_decode["stream_ms"],
         "pass": all(r["pass"] for r in fp_rows + fpd_rows)},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:89",
         "launches": serve["launches"]["paged_attention"],
         "max_abs_err": at_err, "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
         "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
         "library_ms": at_main["library_ms"],
         "work": "B=4 K=8 G=2 hd=128 block=16 T=1 bf16, ~300 cached tokens a row",
         "length_sweep": [_sweep_entry(r) for r in at_main["length_sweep"]],
         "dense_decode_cases": [_case_entry(r) for r in attn_rows if r.get("arch")],
         "launches_gemma3_bf16_pool_serve": gemma3["bf16_pool_launches"]["paged_attention"],
         "pass": all(r["pass"] for r in attn_rows)},
        {"name": "symog_update", "route": "cuda",
         "source": "src/repro_torch/csrc/symog_update.cu",
         "replaces": "src/repro/kernels/symog_update/kernel.py:25",
         "launches": train["symog_update_launches"],
         "max_abs_err": sy_err, "ms": sy_full["ms"], "plain_ms": sy_full["plain_ms"],
         "bound_ms": sy_full["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "library_note": "no single PyTorch call computes the SYMOG step (quantize, "
                         "regularizer gradient, Nesterov momentum and clip)",
         "work": f"one full-width internlm2-1.8b update: the 8 quantizable leaves, "
                 f"{sy_full['elements']} fp32 elements, 20 B each",
         "pass": all(r["pass"] for r in sy_rows)},
        {"name": "fixedpoint_matmul_experts", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/ops.py:81",
         "launches": par_ex, "max_abs_err": _route_err(ex_rows, "streaming"),
         "ms": fe_fp32["ms"], "plain_ms": fe_fp32["plain_ms"], "bound_ms": fe_fp32["bound_ms"],
         "bound_by": "bytes", "library_ms": fe_fp32["library_ms"],
         "work": "one olmoe layer's 3 expert stacks (64 experts, one f each) at C=4, 2-bit, "
                 "fp32 x",
         "launches_from": "olmoe-1b-7b fp32 parity (phase 4, kernels path): every bf16 call "
                          "of the serves takes the decode or tensor-core kernel",
         "pass": par_ex > 0 and all(r["pass"] for r in fe_rows + fed_rows)},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:131",
         "launches": olmoe["launches"]["paged_attention_quant"],
         "max_abs_err": aq_err, "ms": aq_main["ms"], "plain_ms": aq_main["plain_ms"],
         "bound_ms": aq_main["bound_ms"], "bound_by": aq_main["bound_by"],
         "library_ms": aq_main["library_ms"],
         "work": "int4 pool, B=4 K=16 G=1 hd=128 block=16 T=1 bf16, ~300 cached tokens a row",
         "length_sweep": [_sweep_entry(r) for r in aq_main["length_sweep"]],
         "tail_prefill_cases": [_case_entry(r) for r in aq_rows if r["tail_prefill"]],
         "launches_gemma3_serve": gemma3["launches"]["paged_attention_quant"],
         "tail_prefill_launches_gemma3_serve": gemma3["tail_prefill_launches"],
         "launches_gemma3_parity": par_g3["attention_launches"]["kernels"][
             "paged_attention_quant"],
         "pass": all(r["pass"] for r in aq_rows)},
    ]
    # rows 4 and 5: the tensor-core kernel takes every bf16 call of the
    # serves; mla_partial the fp32 ones (the 4-layer parities)
    for quant in (False, True):
        sfx = "_quant" if quant else ""
        m = mla_main["quant" if quant else "float"]
        kind = "quant" if quant else "float"
        par = par_ds["int4_fp" if quant else "bf16"]["attention_launches"]["kernels"]
        serve16 = deepseek["bf16_pool_launches"] if not quant else deepseek["launches"]
        work = (f"{'int4' if quant else 'bf16'} pool, B=4 T=1 H=128 r=512 rope=64 block=16 "
                "bf16 q, ~300 cached tokens a row")
        mla_rows_k = [r for r in mla_rows if r["kernel"] == "paged_attention_mla" + sfx]
        summary.append(
            {"name": "paged_attention_mla_tc" + sfx, "route": "cuda",
             "source": "src/repro_torch/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:" + ("273" if quant
                                                                          else "234"),
             "launches": serve16["paged_attention_mla_tc" + sfx],
             "max_abs_err": mla_err["tc_" + kind], "ms": m["tc_ms"], "plain_ms": m["plain_ms"],
             "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
             "library_ms": m["library_ms"], "partial_kernel_ms": m["partial_ms"],
             "split": m["tc_split"], "ms_by_split": m["tc_ms_by_split"], "work": work,
             "launches_from": f"deepseek-v3 serve from a{' bf16' if not quant else 'n int4'} MLA "
                              "pool (7 layers x decode steps): every MLA launch",
             "pass": all(r["pass"] for r in mla_rows_k)})
        summary.append(
            {"name": "paged_attention_mla" + sfx, "route": "cuda",
             "source": "src/repro_torch/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:" + ("273" if quant
                                                                          else "234"),
             "launches": par["paged_attention_mla" + sfx],
             "max_abs_err": mla_err["partial_" + kind], "ms": m["partial_ms"],
             "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
             "library_ms": m["library_ms"],
             "serve_launches": serve16["paged_attention_mla" + sfx]
             - serve16["paged_attention_mla_tc" + sfx],
             "work": work + " (mla_partial + attn_combine, forced)",
             "launches_from": f"deepseek-v3 4-layer fp32 parity from a "
                              f"{'int4' if quant else 'bf16'} MLA pool (phase 4, kernels path): "
                              "fp32 queries; no bf16 call of the serves takes it",
             "pass": par["paged_attention_mla" + sfx] > 0 and all(r["pass"] for r in mla_rows_k)})
    for name, serve_row, rows, pre, work, pre2, work2 in (
            ("fixedpoint_matmul_tc", serve, mm_rows, fp_prefill,
             "one internlm2 layer's 7 projections at M=512 (a 512-token prefill), 2-bit, bf16",
             None, None),
            ("fixedpoint_matmul_experts_tc", olmoe, ex_rows, fed_prefill,
             "one deepseek-v3 MoE layer's 3 expert stacks (256 experts) at C=20 (a 512-token "
             "prefill), 2-bit, bf16", fe_prefill,
             "one olmoe layer's 3 expert stacks (64 experts) at C=80 (a 512-token prefill)")):
        base = name[: -len("_tc")]
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
                 "replaces": "src/repro/kernels/fixedpoint_matmul/kernel.py:30"
                 if base == "fixedpoint_matmul"
                 else "src/repro/kernels/fixedpoint_matmul/ops.py:81",
                 "launches": serve_row["launches"][name],
                 "max_abs_err": _route_err(rows, "tensor_core"), "ms": pre["ms"],
                 "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
                 "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
                 "streaming_kernel_ms": pre["stream_ms"], "work": work,
                 "launches_deepseek_serve": deepseek["launches"][name],
                 "tc_min_rows": cross["tc_min_rows"],
                 "crossover_rows": cross["2d" if base == "fixedpoint_matmul"
                                         else "experts"]["crossover_rows"],
                 "tc_faster_at_every_routed_case": tc_faster,
                 "pass": tc_faster and all(r["pass"] for r in rows)}
        entry["launches_olmoe_serve"] = olmoe["launches"][name]
        entry["launches_gemma3_serve"] = gemma3["launches"][name]
        if pre2 is not None:
            entry["olmoe_prefill_layer"] = dict(pre2, work=work2)
        summary.append(entry)
    summary[0]["launches_deepseek_serve"] = deepseek["launches"]["fixedpoint_matmul"]
    dec_rows = [r for r in mm_rows if r["route"] == "decode" or "dec_max_abs_err" in r]
    dex_rows = [r for r in ex_rows if r["route"] == "decode" or "dec_max_abs_err" in r]
    summary.append(
        {"name": "fixedpoint_matmul_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/kernel.py:30",
         "launches": serve["launches"]["fixedpoint_matmul_decode"],
         "max_abs_err": _route_err(mm_rows, "decode"),
         "ms": fp_decode["ms"], "plain_ms": fp_decode["plain_ms"],
         "bound_ms": fp_decode["bound_ms"], "bound_by": "bytes",
         "library_ms": fp_decode["library_ms"], "streaming_kernel_ms": fp_decode["stream_ms"],
         "work": "one internlm2 layer's 7 projections at M=4, 2-bit, bf16",
         "deepseek_decode_layer": dict(
             fpd_layer, work="one deepseek-v3 MoE layer's 2-D matmuls at decode (q_a, q_b, "
                             "kv_a, k_rope, o, the shared expert's 3) at M=4, 2-bit, bf16"),
         "launches_olmoe_serve": olmoe["launches"]["fixedpoint_matmul_decode"],
         "launches_deepseek_serve": deepseek["launches"]["fixedpoint_matmul_decode"],
         "launches_gemma3_serve": gemma3["launches"]["fixedpoint_matmul_decode"],
         "gemma3_decode_layer": dict(
             fpg_layer, work="one gemma3-4b layer's 7 projections at M=4, 2-bit, bf16"),
         "gemma3_head": dict(_case_entry(fpg_head), stream_ms=fpg_head["stream_ms"],
                             work="gemma3-4b's 262,144-row head as a packed (2560, 262144) "
                                  "matrix at M=4, 2-bit, bf16 (the serve's tied head "
                                  "dequantizes the table instead: no launch)",
                             serve_head_dequant_matmul_ms=gemma3["head_dequant_matmul_ms"]),
         "decode_max_rows": cross["decode_max_rows"],
         "decode_crossover_rows": cross["2d"]["decode_crossover_rows"],
         "dec_faster_than_streaming_at_every_routed_case": dec_faster,
         "pass": dec_faster and all(r["pass"] and r.get("dec_bit_identical", True)
                                    for r in dec_rows)})
    summary.append(
        {"name": "fixedpoint_matmul_experts_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/ops.py:81",
         "launches": deepseek["launches"]["fixedpoint_matmul_experts_decode"],
         "max_abs_err": _route_err(ex_rows, "decode"),
         "ms": fed_decode["ms"], "plain_ms": fed_decode["plain_ms"],
         "bound_ms": fed_decode["bound_ms"], "bound_by": "bytes",
         "library_ms": fed_decode["library_ms"],
         "bound_all_experts_ms": fed_decode["bound_all_ms"],
         "occupied_experts": fed_decode["occupied"],
         "every_expert_ms": fed_decode["dec_all_ms"],
         "streaming_kernel_ms": fed_decode["stream_ms"],
         "work": "one deepseek-v3 MoE layer's 3 expert stacks (256 experts, one f each) at "
                 "C=4, 2-bit, bf16, rows from a top-8 routing of 4 tokens (occupied_experts "
                 "summed over the 3 stacks); bound_ms counts the occupied experts' bytes",
         "olmoe_decode_layer": dict(
             fe_decode, work="one olmoe layer's 3 stacks (64 experts) at C=4, rows from a "
                             "top-8 routing of 4 tokens"),
         "launches_olmoe_serve": olmoe["launches"]["fixedpoint_matmul_experts_decode"],
         "decode_crossover_rows": cross["experts"]["decode_crossover_rows"],
         "dec_faster_than_streaming_at_every_routed_case": dec_faster,
         "pass": dec_faster and all(r["pass"] and r.get("dec_bit_identical", True)
                     and r.get("equal_to_every_expert", True) for r in dex_rows)})
    if not all(k["pass"] for k in summary):
        print("chip_smoke: FAILED: a kernel row did not pass", file=sys.stderr)
        return 1
    emit({"kernels": summary})
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.") for m in sys.modules):
        print("chip_smoke: jax or the JAX package was imported", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
