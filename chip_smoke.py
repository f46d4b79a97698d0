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
               bound from bytes and operations: 3a fixedpoint_matmul, 3b
               paged_attention, 3c symog_update on every quantizable leaf
               shape of internlm2-1.8b plus an odd n, half-step ties, the
               clip and a misaligned operand, 3d fixedpoint_matmul_experts
               on olmoe-1b-7b's expert stacks (64 experts, one f each, C = 4
               and 80, 2 and 4 bits, bf16 and fp32) and fixedpoint_matmul
               at olmoe's packed head (M 4, K 2048, N 50304, fp32); both
               again at deepseek-v3's shapes, 2-bit: every 2-D projection of
               its path (the MLA layer's, the dense MLP, the shared expert,
               the 129,280-row head; M 4 and 128, bf16 and fp32) and one MoE
               layer's three 256-expert stacks (C 4 in bf16 and fp32, C 20
               in bf16); 3e
               paged attention over int8 and int4 SYMOG pools (olmoe's and
               internlm2's decode shapes, exponents over [-8, 4], a window
               + softcap case, an fp32 case), 3f the absorbed MLA decode
               (``paged_attention_mla``) at deepseek-v3's shape (128 heads,
               rank 512, rope 64) over bf16 / fp32, KV_F int8 and SYMOG
               int8 / int4 pools (one exponent per block over [-8, 4]), T 1
               and 3, a row at position 0, and an fp64 conditioning check;
  4. parity  — internlm2-1.8b and olmoe-1b-7b at full width, 4 layers, fp32
               compute, 2-bit packed: prefill + 4 teacher-forced paged decode
               steps through the kernels vs through the plain paths; logits
               must agree; olmoe a second time from an int4 SYMOG pool
               (quantizing admission held array_equal to the same writes on
               the CPU, quantized decode writes, the quantized kernel vs
               ``_paged_read``, packed matmuls through the kernels on both
               routes so that both write the same words); deepseek-v3 (3
               dense + 1 MoE layer, 256 experts, built layer by layer) from a
               bf16 and from an int4 MLA pool, the matmuls through the
               kernels on both routes, argmax agreement 1.0; the two pools'
               logits compared row by row (top-1 - top-2 margin beside the
               largest logit gap, the int4 pool's c_kv / k_rope error);
  5. serve   — internlm2-1.8b at full width, all 24 layers, 2-bit
               ``ServeEngine.from_symog``, bf16, 4 slots, 8 requests of
               24..400 prompt tokens and 32 new tokens each through the
               continuous-batching scheduler; every kernel's launch count
               must equal the count the path implies;
  6. profile — a few decode steps of that engine under cProfile (host
               functions) and torch.profiler (device busy time, top kernels);
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
               launches; then its decode profile.
Each serving and training path zeroes every kernel's launch count just
before it runs and reads them just after.
Then each phase's seconds and the total, the ``kernels`` summary line (all
seven kernels), the nvidia-smi line, and the last line
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
def _fpmm_case(torch, gen, dev, name, K, N, M, dt, n_bits, *, with_bias, timing):
    """One 2-D case: Gaussian weights packed with their optimal f, x (M, K)
    of ``dt``, the kernel held to its plain version; timed (kernel, plain,
    ``torch.matmul`` on the dequantized weight) when ``timing``.  A plain
    version whose fp32 unpacked weight exceeds 1 GB is timed with CUDA
    events over single calls (a graph of 16 would hold 16 sets of its
    temporaries)."""
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
    del y, ref
    wbytes = pw.numel()
    io = x.numel() * x.element_size() + wbytes + 4 + M * N * x.element_size()
    io += 0 if bias is None else N * 4
    b_ms, b_by = bound(io, 2 * M * K * N, dname)
    row = {"phase": "kernel", "kernel": "fixedpoint_matmul", "proj": name, "M": M, "K": K,
           "N": N, "n_bits": n_bits, "dtype": dname, "bias": bias is not None,
           "max_abs_err": err, "tol": tol, "pass": ok}
    if timing:
        n = copies_for(wbytes)
        pws = [pw.clone() for _ in range(n)]
        xs = [x.clone() for _ in range(n)]
        wd = (unpack_int(pw, n_bits, N).float() * torch.exp2(-f.float())).to(dt)
        nl = copies_for(wd.numel() * wd.element_size())
        wds = [wd] + [wd.clone() for _ in range(nl - 1)]
        del wd
        row["ms"] = timed(lambda a, b: fops.fixedpoint_matmul(a, b, f, bias, n_bits=n_bits,
                                                               n_out=N),
                          list(zip(xs, pws)), torch)
        if K * N * 4 > 1e9:
            row["plain_ms"] = events_ms(lambda: fixedpoint_matmul_ref(
                xs[0], pws[0], f, bias, n_bits=n_bits, n_out=N), 5, torch)
            row["plain_timing"] = "CUDA events, single calls"
        else:
            row["plain_ms"] = timed(lambda a, b: fixedpoint_matmul_ref(a, b, f, bias,
                                                                       n_bits=n_bits, n_out=N),
                                    list(zip(xs, pws)), torch)
        row["library_ms"] = timed(lambda a, b: torch.matmul(a, b),
                                  [(xs[i % n], wds[i]) for i in range(nl)], torch)
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        del pws, xs, wds
    return row


def phase_fpmm(torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, worst = [], 0.0
    decode = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    cases = []
    for n_bits in (2, 4):
        for M in (4, 128):
            for dt in (torch.bfloat16, torch.float32):
                for name, K, N in FPMM_SHAPES:
                    cases.append((n_bits, M, dt, name, K, N))
    for n_bits, M, dt, name, K, N in cases:
        # time every 2-bit case and the 4-bit decode cases
        row = _fpmm_case(torch, gen, dev, name, K, N, M, dt, n_bits, with_bias=M == 128,
                         timing=n_bits == 2 or M == 4)
        worst = max(worst, row["max_abs_err"])
        if n_bits == 2 and M == 4 and dt == torch.bfloat16:
            for k in decode:
                decode[k] += row[k]
        emit(row)
        rows.append(row)
        if not row["pass"]:
            raise Failed(f"fixedpoint_matmul {name} M={M} bits={n_bits} {row['dtype']}: "
                         f"err {row['max_abs_err']}")
    return rows, worst, decode


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
    M = 4 (decode) and 128, bf16 (serve) and fp32 (parity), every case
    timed.  Returns the rows, the largest error and the sums over one MoE
    layer's decode matmuls at M = 4 bf16."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows, worst = [], 0.0
    layer = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, K, N in DEEPSEEK_FPMM_SHAPES:
        for M in (4, 128):
            for dt in (torch.bfloat16, torch.float32):
                row = _fpmm_case(torch, gen, dev, name, K, N, M, dt, 2, with_bias=False,
                                 timing=True)
                row["arch"] = DEEPSEEK
                worst = max(worst, row["max_abs_err"])
                if M == 4 and dt == torch.bfloat16 and name in DEEPSEEK_DECODE_LAYER:
                    for k in layer:
                        layer[k] += DEEPSEEK_DECODE_LAYER[name] * row[k]
                emit(row)
                rows.append(row)
                if not row["pass"]:
                    raise Failed(f"fixedpoint_matmul deepseek {name} M={M} {row['dtype']}: "
                                 f"err {row['max_abs_err']}")
        torch.cuda.empty_cache()
    return rows, worst, layer


# ---------------------------------------------------------------------------
# phase 3b: paged attention
# ---------------------------------------------------------------------------
def _attn_case(torch, gen, dev, *, B, K, G, hd, block, max_blocks, T, dt, int8, q_mult):
    n_phys = B * max_blocks + 1
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    pos_last = torch.randint(280, 320, (B,), generator=gen, device=dev)
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


def phase_attn(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import gather_logical, paged_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    B, K, G, hd, block, max_blocks = 4, 8, 2, 128, 16, 32
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
    rows, worst, main = [], 0.0, None
    for c in cases:
        T, dt, int8 = c["T"], c["dt"], c["int8"]
        dname = str(dt).split(".")[-1]
        q, kp, vp, bt, pos0 = _attn_case(torch, gen, dev, B=B, K=K, G=G, hd=hd, block=block,
                                         max_blocks=max_blocks, T=T, dt=dt, int8=int8,
                                         q_mult=c["q_mult"])
        kv_scale = 2.0**-5 if int8 else 1.0
        kw = dict(scale=hd**-0.5, cap=c["cap"], window=c["window"], kv_scale=kv_scale)
        out = aops.paged_attention(q, kp, vp, bt, pos0, **kw)
        ref = paged_attention_ref(q, kp, vp, bt, pos0, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL[dname]
        ok = bool(torch.allclose(out.float(), ref.float(), **tol))
        worst = max(worst, err)
        # bytes this run's data needs: the blocks each row can see, once
        vis_blocks = ((pos0.long() + T - 1) // block + 1).sum().item()
        if c["window"] is not None:
            lo = torch.clamp(pos0.long() - c["window"] + 1, min=0) // block
            vis_blocks -= lo.sum().item()
        kv_bytes = 2 * vis_blocks * block * K * hd * kp.element_size()
        io = 2 * q.numel() * q.element_size() + kv_bytes + bt.numel() * 4 + B * 4
        s_vis = (pos0.long() + T).sum().item()  # causal keys per row (upper bound per token)
        flops = 4 * s_vis * T * K * G * hd
        b_ms, b_by = bound(io, flops, dname)
        n = copies_for(kp.numel() * kp.element_size() * 2)
        pools = [(kp.clone(), vp.clone()) for _ in range(n)]
        args = [(q, a, b) for a, b in pools]
        row = {"phase": "kernel", "kernel": "paged_attention", "B": B, "K": K, "G": G, "hd": hd,
               "block": block, "T": T, "kv_dtype": str(kp.dtype).split(".")[-1], "q_dtype": dname,
               "window": c["window"], "cap": c["cap"], "q_mult": c["q_mult"], "max_abs_err": err,
               "tol": tol, "pass": ok}
        row["ms"] = timed(lambda a, b, cc: aops.paged_attention(a, b, cc, bt, pos0, **kw),
                          args, torch)
        row["plain_ms"] = timed(lambda a, b, cc: paged_attention_ref(a, b, cc, bt, pos0, **kw),
                                args, torch)
        # library yardstick: SDPA over the gathered (logical) cache; timed only
        kl = gather_logical(kp, bt).to(dt) * kv_scale
        vl = gather_logical(vp, bt).to(dt) * kv_scale
        S = kl.shape[1]
        kv_pos = torch.arange(S, device=dev)
        q_pos = pos0.long()[:, None] + torch.arange(T, device=dev)[None]
        mask = kv_pos[None, None] <= q_pos[:, :, None]
        if c["window"] is not None:
            mask = mask & (q_pos[:, :, None] - kv_pos[None, None] < c["window"])
        qs = q.reshape(B, T, K * G, hd).transpose(1, 2)
        ks = kl.transpose(1, 2).repeat_interleave(G, dim=1)
        vs = vl.transpose(1, 2).repeat_interleave(G, dim=1)
        nl = copies_for(ks.numel() * ks.element_size() * 2)
        largs = [(qs, ks.clone(), vs.clone()) for _ in range(nl)]
        row["library_ms"] = (
            None if c["cap"] else
            timed(lambda a, b, cc: F.scaled_dot_product_attention(a, b, cc,
                                                                  attn_mask=mask[:, None]),
                  largs, torch)
        )
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        del pools, args, largs
        emit(row)
        rows.append(row)
        if main is None:
            main = row
        if not ok:
            raise Failed(f"paged_attention case {c}: err {err}")
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


def _experts_case(torch, gen, dev, name, words, f, sc, C, dt, n_bits, N, *, timing):
    """One experts case: x (E, C, K) of ``dt`` with expert e's rows scaled
    by 2^-s_e, the kernel held to its plain version; timed (kernel, plain,
    ``torch.bmm`` on the dequantized stack) when ``timing``.  A stack whose
    fp32 unpacking exceeds 1 GB is timed with CUDA events over single calls
    of the plain version and ``torch.bmm`` (a graph of 16 plain calls would
    hold 16 sets of its temporaries)."""
    from repro_torch.core import unpack_int
    from repro_torch.kernels.fixedpoint_matmul import ops as fops
    from repro_torch.kernels.fixedpoint_matmul.ref import fixedpoint_matmul_experts_ref

    E, K = words.shape[0], words.shape[1]
    dname = str(dt).split(".")[-1]
    x = (torch.randn((E, C, K), generator=gen, device=dev) / sc).to(dt)
    y = fops.fixedpoint_matmul_experts(x, words, f, n_bits=n_bits, n_out=N)
    ref = fixedpoint_matmul_experts_ref(x, words, f, n_bits=n_bits, n_out=N).to(dt)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    tol = TOL[dname]
    ok = bool(torch.allclose(y.float(), ref.float(), **tol))
    del y, ref
    wbytes = words.numel()
    io = x.numel() * x.element_size() + wbytes + 4 * E + E * C * N * x.element_size()
    b_ms, b_by = bound(io, 2 * E * C * K * N, dname)
    row = {"phase": "kernel", "kernel": "fixedpoint_matmul_experts", "proj": name,
           "E": E, "C": C, "K": K, "N": N, "n_bits": n_bits, "dtype": dname,
           "f_range": [int(f.min()), int(f.max())], "max_abs_err": err,
           "tol": tol, "pass": ok, "bound_ms": b_ms, "bound_by": b_by}
    if timing:
        n = copies_for(wbytes)
        args = [(x.clone(), words.clone()) for _ in range(n)]
        row["ms"] = timed(lambda a, b: fops.fixedpoint_matmul_experts(
            a, b, f, n_bits=n_bits, n_out=N), args, torch)
        big = wbytes * (8 // n_bits) * 4 > 1e9
        if big:
            row["plain_ms"] = events_ms(lambda: fixedpoint_matmul_experts_ref(
                x, words, f, n_bits=n_bits, n_out=N), 3, torch)
        else:
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
    return row


def phase_fpmm_experts(torch, dev):
    """Stacks as SYMOG makes them: Gaussian weights, expert e scaled by 2^s_e
    (s_e in [-2, 2]) so that its own optimal f differs, packed with one f
    per expert; the expert's rows of x scaled by 2^-s_e keep every output
    at unit scale, where the fp32 bar of the 2-D phase applies."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    E = N_EXPERTS
    rows, worst = [], 0.0
    decode = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for n_bits in (2, 4):
        for name, K, N in OLMOE_EXPERT_SHAPES:
            words, f, sc = _experts_stack(torch, gen, dev, E, K, N, n_bits)
            for C in (4, 80):  # decode (dropless, 4 slots) and prefill (ceil(1.25*512*8/64))
                for dt in (torch.bfloat16, torch.float32):
                    # every 2-bit case and the 4-bit decode cases
                    row = _experts_case(torch, gen, dev, name, words, f, sc, C, dt, n_bits, N,
                                        timing=n_bits == 2 or C == 4)
                    worst = max(worst, row["max_abs_err"])
                    if n_bits == 2 and C == 4 and dt == torch.bfloat16:
                        for k in decode:
                            decode[k] += row[k]
                    emit(row)
                    rows.append(row)
                    if not row["pass"]:
                        raise Failed(f"fixedpoint_matmul_experts {name} C={C} bits={n_bits} "
                                     f"{row['dtype']}: err {row['max_abs_err']}")
            del words
    torch.cuda.empty_cache()
    return rows, worst, decode


DEEPSEEK_EXPERT_SHAPES = [  # deepseek-v3 per-MoE-layer expert stacks, E x K x N
    ("gate_proj", 7168, 2048), ("up_proj", 7168, 2048), ("down_proj", 2048, 7168),
]
DEEPSEEK_EXPERTS = 256


def phase_fpmm_experts_deepseek(torch, dev):
    """Row 1b at one deepseek-v3 MoE layer's three 2-bit stacks (256
    experts, one f each, 940 MB of words a stack): C = 4 (decode, 4 slots)
    in bf16 (serve) and fp32 (parity), and C = 20 (a 512-token prefill
    bucket, ceil(1.25*512*8/256)) in bf16, every case timed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rows, worst = [], 0.0
    decode = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, K, N in DEEPSEEK_EXPERT_SHAPES:
        words, f, sc = _experts_stack(torch, gen, dev, DEEPSEEK_EXPERTS, K, N, 2)
        for C, dt in ((4, torch.bfloat16), (4, torch.float32), (20, torch.bfloat16)):
            row = _experts_case(torch, gen, dev, name, words, f, sc, C, dt, 2, N, timing=True)
            row["arch"] = DEEPSEEK
            worst = max(worst, row["max_abs_err"])
            if C == 4 and dt == torch.bfloat16:
                for k in decode:
                    decode[k] += row[k]
            emit(row)
            rows.append(row)
            if not row["pass"]:
                raise Failed(f"fixedpoint_matmul_experts deepseek {name} C={C} "
                             f"{row['dtype']}: err {row['max_abs_err']}")
        del words, f, sc
        torch.cuda.empty_cache()
    return rows, worst, decode


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
           "K": K, "N": N, "n_bits": n_bits, "dtype": "float32", "max_abs_err": err, "tol": tol,
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
                     wide):
    """Quantized pools over ~300 cached tokens a row.  ``wide``: random
    mantissas under per-(block, head) exponents spread over [-8, 4];
    otherwise the pools a paged write makes of unit-scale k/v (values
    N(0,1)·2^s, s in [-3, 1] per (block, head), exponents from each block's
    first token)."""
    from repro_torch.models.attention import KV_QMAX, block_scale_exp, pack_int4, quantize_fixed

    n_phys = B * max_blocks + 1
    perm = torch.randperm(n_phys - 1, generator=gen, device=dev)[: B * max_blocks] + 1
    bt = perm.reshape(B, max_blocks).to(torch.int32)
    pos_last = torch.randint(280, 320, (B,), generator=gen, device=dev)
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


def phase_attn_quant(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.paged_attention.ref import dequant_logical, paged_attention_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    hd, block, max_blocks, B = 128, 16, 32, 4
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
    rows, worst, main = [], 0.0, None
    for c in cases:
        K, G, bits, dt, T = c["K"], c["G"], c["bits"], c["dt"], 1
        dname = str(dt).split(".")[-1]
        q, kp, vp, ke, ve, bt, pos0 = _attn_quant_case(
            torch, gen, dev, B=B, K=K, G=G, hd=hd, block=block, max_blocks=max_blocks, T=T,
            dt=dt, bits=bits, q_mult=1.0, wide=c["wide"])
        kw = dict(scale=hd**-0.5, cap=c["cap"], window=c["window"], kv_bits=bits)
        out = aops.paged_attention(q, kp, vp, bt, pos0, k_scale_exp=ke, v_scale_exp=ve, **kw)
        ref = paged_attention_ref(q, kp, vp, bt, pos0, k_scale_exp=ke, v_scale_exp=ve, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL[dname]
        ok = bool(torch.allclose(out.float(), ref.float(), **tol))
        worst = max(worst, err)
        # bytes this run's data needs: the words and exponents of the blocks each row sees
        vis_blocks = ((pos0.long() + T - 1) // block + 1).sum().item()
        if c["window"] is not None:
            lo = torch.clamp(pos0.long() - c["window"] + 1, min=0) // block
            vis_blocks -= lo.sum().item()
        kv_bytes = 2 * vis_blocks * (block * K * kp.shape[-1] + 4 * K)
        io = 2 * q.numel() * q.element_size() + kv_bytes + bt.numel() * 4 + B * 4
        s_vis = (pos0.long() + T).sum().item()
        b_ms, b_by = bound(io, 4 * s_vis * T * K * G * hd, dname)
        n = copies_for((kp.numel() + ke.numel() * 4) * 2)
        args = [(q, kp.clone(), vp.clone(), ke.clone(), ve.clone()) for _ in range(n)]
        row = {"phase": "kernel", "kernel": "paged_attention_quant", "B": B, "K": K, "G": G,
               "hd": hd, "block": block, "T": T, "kv_bits": bits, "q_dtype": dname,
               "window": c["window"], "cap": c["cap"], "wide_exponents": c["wide"],
               "exp_range": [int(min(ke.min(), ve.min())), int(max(ke.max(), ve.max()))],
               "max_abs_err": err, "tol": tol, "pass": ok}
        row["ms"] = timed(lambda a, b, cc, d, e: aops.paged_attention(
            a, b, cc, bt, pos0, k_scale_exp=d, v_scale_exp=e, **kw), args, torch)
        row["plain_ms"] = timed(lambda a, b, cc, d, e: paged_attention_ref(
            a, b, cc, bt, pos0, k_scale_exp=d, v_scale_exp=e, **kw), args, torch)
        # library yardstick: SDPA over the gathered, dequantized cache; timed only
        kl = dequant_logical(kp, ke, bt, kv_bits=bits).to(dt)
        vl = dequant_logical(vp, ve, bt, kv_bits=bits).to(dt)
        S = kl.shape[1]
        kv_pos = torch.arange(S, device=dev)
        q_pos = pos0.long()[:, None] + torch.arange(T, device=dev)[None]
        mask = kv_pos[None, None] <= q_pos[:, :, None]
        if c["window"] is not None:
            mask = mask & (q_pos[:, :, None] - kv_pos[None, None] < c["window"])
        qs = q.reshape(B, T, K * G, hd).transpose(1, 2)
        ks = kl.transpose(1, 2).repeat_interleave(G, dim=1)
        vs = vl.transpose(1, 2).repeat_interleave(G, dim=1)
        nl = copies_for(ks.numel() * ks.element_size() * 2)
        largs = [(qs, ks.clone(), vs.clone()) for _ in range(nl)]
        row["library_ms"] = (
            None if c["cap"] else
            timed(lambda a, b, cc: F.scaled_dot_product_attention(a, b, cc,
                                                                  attn_mask=mask[:, None]),
                  largs, torch)
        )
        row["bound_ms"], row["bound_by"] = b_ms, b_by
        row["achieved_GBps"] = io / (row["ms"] * 1e-3) / 1e9
        del args, largs
        emit(row)
        rows.append(row)
        if main is None:
            main = row
        if not ok:
            raise Failed(f"paged_attention_quant case {c}: err {err}")
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
def phase_parity(torch, dev, layers: int, arch: str = "internlm2-1.8b",
                 kv_cache_dtype: str = "bf16", build=None, plain_packed: str = "unpack"):
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
    ``init_lm`` + ``symog_init`` + ``pack_tree`` of the whole tree)."""
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
    names = (("paged_attention_mla", "paged_attention_mla_quant") if cfg.use_mla
             else ("paged_attention", "paged_attention_quant"))
    logits, attn_launches, admission_equal, final = {}, {}, {}, {}
    plain_pb = plain_packed if kv_cache_dtype == "bf16" else "kernel"
    for path, (pb, ab) in {"kernels": ("kernel", "fused"), "plain": (plain_pb, "composed")}.items():
        dispatch.set_packed_backend(pb)
        dispatch.set_attention_backend(ab)
        eng = ServeEngine(cfg, packed, max_len=max_len, compute_dtype=torch.float32, device=dev)
        dispatch.set_packed_backend("auto")
        dispatch.set_attention_backend("auto")
        nb = max_len // block
        # the scheduler's pool layout for two slots: (n_phys, block, ...) per
        # paged leaf (a leading layer axis per stacked group), exponent leaves
        # for a quantized pool
        caches = Scheduler(eng, ServeConfig(n_slots=len(lens), block_size=block)).caches
        groups = scan_groups(cfg)
        bt = (torch.arange(len(lens) * nb, device=dev, dtype=torch.int32) + 1).reshape(len(lens), nb)
        # the admission on the card (quantizing, for a quantized pool), held
        # array_equal to the same writes made on the CPU from the same caches
        host = {g.name: {n: t.new_zeros(t.shape, device="cpu")
                         for n, t in caches[g.name]["sub0"].items()} for g in groups}
        zero_counts()
        outs = []
        for b, pr in enumerate(prompts):
            lg, one = eng._with_backend(prefill_lm, eng.params, {"tokens": pr[None].to(dev)}, cfg,
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
        admission_equal[path] = all(torch.equal(t.cpu(), host[g][n])
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
        logits[path] = torch.stack(outs)
        final[path] = caches
        counts = read_counts()
        attn_launches[path] = {n: counts[n] for n in names}
        del eng, caches
    torch.cuda.synchronize()
    words_differing = {f"{g}/{n}": int((t != final["plain"][g]["sub0"][n]).sum().item())
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
    quant = kv_cache_dtype != "bf16"
    want = {"kernels": {names[0]: 0 if quant else layers * steps,
                        names[1]: layers * steps if quant else 0},
            "plain": {names[0]: 0, names[1]: 0}}
    row = {"phase": "parity", "arch": arch, "layers": layers, "n_bits": 2,
           "kv_cache_dtype": kv_cache_dtype, "compute": "float32", "prompts": lens,
           "decode_steps": steps, "logit_rows": int(a.shape[0]), "max_abs_logit_err": err,
           "atol": PARITY_ATOL, "logit_scale": a.abs().max().item(), "argmax_agreement": agree,
           "finite": finite, "attention_launches": attn_launches,
           "expected_attention_launches": want,
           "admission_pool_equal_cpu": admission_equal, "plain_packed_backend": plain_pb,
           "pool_words_differing_after_decode": words_differing,
           "pass": (finite and err <= PARITY_ATOL and agree == 1.0 and attn_launches == want
                    and all(admission_equal.values()))}
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
            "fixedpoint_matmul_experts": (fops, "experts_launches"),
            "paged_attention": (aops, "launches"),
            "paged_attention_quant": (aops, "quant_launches"),
            "paged_attention_mla": (aops, "mla_launches"),
            "paged_attention_mla_quant": (aops, "mla_quant_launches"),
            "symog_update": (sops, "launches")}


def zero_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


# ---------------------------------------------------------------------------
# phase 5: full-width serve through the scheduler
# ---------------------------------------------------------------------------
def phase_serve(torch, dev, arch: str, kv_cache_dtype: str, seed: int, expected,
                layers: int = 0, build=None):
    """Serve the seeded traffic (4 slots, block 16, max_len 512, 8 requests
    of 24..400 prompt tokens, 32 new tokens each) through the
    continuous-batching scheduler from a 2-bit packed artifact of ``arch``
    at full width and all its layers (``layers`` > 0 cuts the depth), made
    on the card from random weights (``seed``) by ``symog_init`` +
    ``pack_tree`` (``build(cfg, seed)`` -> (artifact, n_params, seconds by
    step) instead, for a model too large to hold in fp32).
    ``expected(cfg, stats)`` gives every kernel's launch count on this path:
    the counts are zeroed just before the serve and read just after.
    Returns the row (emitted by the caller, which may add to it), the
    engine, the requests, the serve config and the tokens."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.core import SymogConfig, symog_init
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
        eng = ServeEngine(cfg, tree, max_len=512, compute_dtype=torch.bfloat16, device=dev)
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
        eng = ServeEngine.from_symog(cfg, params, state, scfg, max_len=512,
                                     compute_dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        t_done = time.perf_counter()
        del params, state
        secs = {"init_s": t_symog - t_init, "symog_init_s": t_pack - t_symog,
                "pack_s": t_done - t_pack}
    build_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    lens = rng.integers(24, 401, size=8)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, size=int(L)), max_new_tokens=32)
            for L in lens]
    sc = ServeConfig(n_slots=4, block_size=16)
    fns = eng.scheduler_fns()
    inner = fns.decode_step
    dec = {"s": 0.0, "rows": 0, "steps": 0}

    def timed_decode(params, caches, tokens, pos, active, bt):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(params, caches, tokens, pos, active, bt)
        torch.cuda.synchronize()
        dec["s"] += time.perf_counter() - t
        dec["rows"] += int(active.sum().item())
        dec["steps"] += 1
        return out

    fns.decode_step = timed_decode
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    comps, sched = eng.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    fns.decode_step = inner
    peak = torch.cuda.max_memory_allocated(dev)
    st = sched.stats
    want = expected(cfg, st)
    tokens = [list(map(int, c.tokens)) for c in comps]
    reasons = sorted({c.finish_reason for c in comps})
    lengths_ok = all(len(c.tokens) == 32 or c.finish_reason == "eos" for c in comps)
    tokens_ok = all(0 <= t < cfg.vocab_size for a in tokens for t in a)
    row = {
        "phase": "serve", "arch": arch, "layers": cfg.n_layers, "params": n_params, "n_bits": 2,
        "kv_cache_dtype": kv_cache_dtype, "compute": "bfloat16", "n_slots": 4, "block_size": 16,
        "max_len": 512, "requests": len(reqs), "prompt_lens": [int(x) for x in lens],
        "new_tokens": 32, **secs, "build_peak_device_bytes": build_peak,
        "wall_s": wall, "decode_steps": st["decode_steps"],
        "prefills": st["prefills"], "preemptions": st["preemptions"],
        "admitted_mid_run": sum(1 for c in comps if c.admitted_step > 0),
        "finish_reasons": reasons, "tokens_emitted": st["tokens_emitted"],
        "decode_tokens_per_s": dec["rows"] / dec["s"] if dec["s"] else None,
        "decode_step_ms": dec["s"] / max(dec["steps"], 1) * 1e3,
        "end_to_end_tokens_per_s": st["tokens_emitted"] / wall,
        "kv_pool_bytes": sched.cache_bytes(), "weight_bytes": eng.weight_bytes(),
        "peak_device_bytes": peak, "launches": counts, "expected_launches": want,
    }
    # every kernel the path runs must have launched, each exactly as often
    # as the path implies
    row["pass"] = (set(reasons) <= {"length", "eos"} and lengths_ok and tokens_ok
                   and counts == want and all(counts[k] > 0 for k, n in want.items() if n))
    return row, eng, reqs, sc, tokens


def report(row):
    emit(row)
    if not row["pass"]:
        raise Failed(f"{row['phase']} {row['arch']} failed: {row}")
    return row


def phase_serve_internlm2(torch, dev):
    from repro_torch.models.layers import embed_logits

    def expected(cfg, st):
        # every packed projection of every layer, once per decode step and
        # once per admission prefill (the prefill cache reuses attention's k/v)
        return {"fixedpoint_matmul": 7 * cfg.n_layers * (st["decode_steps"] + st["prefills"]),
                "fixedpoint_matmul_experts": 0,
                "paged_attention": cfg.n_layers * st["decode_steps"],
                "paged_attention_quant": 0, "paged_attention_mla": 0,
                "paged_attention_mla_quant": 0, "symog_update": 0}

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
def phase_profile(torch, dev, eng, steps: int = 4):
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
           "decode_step_ms": step_ms}
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

    def expected(cfg, st):
        # every packed projection of every layer per decode step and per prefill
        passes = st["decode_steps"] + st["prefills"]
        return {"fixedpoint_matmul": (4 * cfg.n_layers + 1) * passes,  # q, k, v, o + the lm_head
                "fixedpoint_matmul_experts": 3 * cfg.n_layers * passes,  # gate, up, down
                "paged_attention": 0,  # the pool is int4: every decode read is quantized
                "paged_attention_quant": cfg.n_layers * st["decode_steps"],
                "paged_attention_mla": 0, "paged_attention_mla_quant": 0, "symog_update": 0}

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
    wide exponent spread (queries scaled to O(1) logits), at the bf16 bar;
    fp32 queries on float / KV_F pools and on the words a paged write makes
    at the fp32 bar (as phase 3e); then the conditioning check of the wide
    int8 spread at unit queries against fp64."""
    import torch.nn.functional as F
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
             (1, f32, "float", False), (1, f32, "kv_f", False), (1, f32, "q8w", False),
             (1, f32, "q4w", False), (3, f32, "q4w", True), (3, f32, "float", True)]
    rows, worst, main = [], {"float": 0.0, "quant": 0.0}, {}
    for T, dt, pool, pos_zero in cases:
        dname = str(dt).split(".")[-1]
        qe, qr, cp, kp, bt, pos0, kw, q_mult = _mla_case(torch, gen, dev, T=T, dt=dt, pool=pool,
                                                         pos_zero=pos_zero, **sh)
        quant = "kv_bits" in kw
        kind = "quant" if quant else "float"
        before = (aops.mla_launches, aops.mla_quant_launches)
        out = aops.paged_attention_mla(qe, qr, cp, kp, bt, pos0, **kw)
        ref = paged_attention_mla_ref(qe, qr, cp, kp, bt, pos0, **kw)
        torch.cuda.synchronize()
        launched = (aops.mla_launches - before[0], aops.mla_quant_launches - before[1])
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL[dname]
        ok = (bool(torch.allclose(out.float(), ref.float(), **tol))
              and launched == ((0, 1) if quant else (1, 0)) and out.dtype == dt)
        worst[kind] = max(worst[kind], err)
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

        def call(fn):
            return lambda c, k, *e: fn(qe, qr, c, k, bt, pos0, **rest,
                                       **dict(zip(qk, e)))

        row = {"phase": "kernel", "kernel": "paged_attention_mla" + ("_quant" if quant else ""),
               "B": B, "T": T, "H": H, "r": r, "rope": rope, "block": block, "pool": pool,
               "pool_dtype": str(cp.dtype).split(".")[-1], "q_dtype": dname,
               "row_at_position_0": pos_zero, "q_mult": q_mult, "max_abs_err": err, "tol": tol,
               "pass": ok}
        if quant:
            e_all = torch.cat([kw["ckv_scale_exp"], kw["kr_scale_exp"]])
            row["exp_range"] = [int(e_all.min()), int(e_all.max())]
        row["ms"] = timed(call(aops.paged_attention_mla), args, torch)
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
        if T == 1 and dt == bf and kind not in main:
            main[kind] = row
        if not ok:
            raise Failed(f"{row['kernel']} case T={T} {dname} {pool}: err {err}, "
                         f"launches {launched}")
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

    fns = eng.scheduler_fns()
    inner = fns.decode_step
    box = {"c_kv": [], "k_rope": []}

    def step(params, caches, tokens, pos, active, bt):
        if "logits" in box:
            return inner(params, caches, tokens, pos, active, bt)
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

    def expected(cfg, st):
        # per MLA layer: q_a, q_b, kv_a, k_rope, kv_b_k, kv_b_v and o at prefill;
        # at decode kv_b_k / kv_b_v are absorbed through as_dense (no kernel);
        # per layer also the dense MLP's or the shared expert's 3; + the head
        L, n_moe = cfg.n_layers, cfg.n_layers - cfg.n_dense_layers
        return {"fixedpoint_matmul": (10 * L + 1) * st["prefills"]
                + (8 * L + 1) * st["decode_steps"],
                "fixedpoint_matmul_experts": 3 * n_moe * (st["prefills"] + st["decode_steps"]),
                "paged_attention": 0, "paged_attention_quant": 0,
                "paged_attention_mla": 0,  # the pool is int4: every decode read is quantized
                "paged_attention_mla_quant": L * st["decode_steps"], "symog_update": 0}

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
    zero_counts()
    comps16, sched16 = eng16.serve(reqs, sc, return_scheduler=True)
    torch.cuda.synchronize()
    counts16 = read_counts()
    restore16()
    first_step = _first_step_gap(torch, box4, box16)
    del box4, box16
    steps16 = sched16.stats["decode_steps"]
    want16 = dict(expected(cfg, sched16.stats), paged_attention_mla=cfg.n_layers * steps16,
                  paged_attention_mla_quant=0)
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
        fp_rows, fp_err, fp_decode = run("3a fixedpoint_matmul", phase_fpmm, torch, dev)
        attn_rows, at_err, at_main = run("3b paged_attention", phase_attn, torch, dev)
        sy_rows, sy_err, sy_full = run("3c symog_update", phase_symog, torch, dev,
                                       configs.get_config("internlm2-1.8b"))
        fe_rows, fe_err, fe_decode = run("3d fixedpoint_matmul_experts", phase_fpmm_experts,
                                         torch, dev)
        head = run("3d fixedpoint_matmul_experts", phase_fpmm_head, torch, dev)
        fpd_rows, fpd_err, fpd_layer = run("3a fixedpoint_matmul deepseek", phase_fpmm_deepseek,
                                           torch, dev)
        fed_rows, fed_err, fed_decode = run("3d fixedpoint_matmul_experts deepseek",
                                            phase_fpmm_experts_deepseek, torch, dev)
        aq_rows, aq_err, aq_main = run("3e paged_attention_quant", phase_attn_quant, torch, dev)
        mla_rows, mla_err, mla_main = run("3f paged_attention_mla", phase_attn_mla, torch, dev)
        run("4 parity internlm2", phase_parity, torch, dev, PARITY_LAYERS)
        run("4 parity olmoe", phase_parity, torch, dev, PARITY_LAYERS, arch="olmoe-1b-7b")
        run("4 parity olmoe", phase_parity, torch, dev, PARITY_LAYERS, arch="olmoe-1b-7b",
            kv_cache_dtype="int4_fp")
        # deepseek-v3, 3 dense + 1 MoE layer: one layer-by-layer artifact, served
        # from a bf16 and from an int4 MLA pool
        art = {}

        def ds_build(cfg):
            if "tree" not in art:
                art["tree"] = build_layerwise(torch, dev, cfg, 11)[0]
            return art["tree"]

        for kv in ("bf16", "int4_fp"):
            run("4 parity deepseek", phase_parity, torch, dev, PARITY_LAYERS, arch=DEEPSEEK,
                kv_cache_dtype=kv, build=ds_build, plain_packed="kernel")
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
        run("9 profile deepseek", phase_profile, torch, dev, eng)
        del eng
        torch.cuda.empty_cache()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "seconds", "by_phase": seconds,
          "total_s": time.perf_counter() - t_start})
    summary = [
        {"name": "fixedpoint_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/fixedpoint_matmul.cu",
         "replaces": "src/repro/kernels/fixedpoint_matmul/kernel.py:30",
         "launches": serve["launches"]["fixedpoint_matmul"],
         "max_abs_err": max(fp_err, fpd_err),
         "ms": fp_decode["ms"], "plain_ms": fp_decode["plain_ms"],
         "bound_ms": fp_decode["bound_ms"], "bound_by": "bytes",
         "library_ms": fp_decode["library_ms"],
         "work": "one decoder layer's 7 projections at M=4, 2-bit, bf16",
         "pass": all(r["pass"] for r in fp_rows + fpd_rows)},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:89",
         "launches": serve["launches"]["paged_attention"],
         "max_abs_err": at_err, "ms": at_main["ms"], "plain_ms": at_main["plain_ms"],
         "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
         "library_ms": at_main["library_ms"],
         "work": "B=4 K=8 G=2 hd=128 block=16 T=1 bf16, ~300 cached tokens a row",
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
         "launches": olmoe["launches"]["fixedpoint_matmul_experts"],
         "max_abs_err": max(fe_err, fed_err), "ms": fe_decode["ms"],
         "plain_ms": fe_decode["plain_ms"],
         "bound_ms": fe_decode["bound_ms"], "bound_by": "bytes",
         "library_ms": fe_decode["library_ms"],
         "work": "one olmoe layer's 3 expert stacks (64 experts, one f each) at C=4, 2-bit, bf16",
         "pass": all(r["pass"] for r in fe_rows + fed_rows)},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:131",
         "launches": olmoe["launches"]["paged_attention_quant"],
         "max_abs_err": aq_err, "ms": aq_main["ms"], "plain_ms": aq_main["plain_ms"],
         "bound_ms": aq_main["bound_ms"], "bound_by": aq_main["bound_by"],
         "library_ms": aq_main["library_ms"],
         "work": "int4 pool, B=4 K=16 G=1 hd=128 block=16 T=1 bf16, ~300 cached tokens a row",
         "pass": all(r["pass"] for r in aq_rows)},
        {"name": "paged_attention_mla", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:234",
         "launches": deepseek["bf16_pool_launches"]["paged_attention_mla"],
         "max_abs_err": mla_err["float"], "ms": mla_main["float"]["ms"],
         "plain_ms": mla_main["float"]["plain_ms"], "bound_ms": mla_main["float"]["bound_ms"],
         "bound_by": mla_main["float"]["bound_by"],
         "library_ms": mla_main["float"]["library_ms"],
         "work": "bf16 pool, B=4 T=1 H=128 r=512 rope=64 block=16 bf16, ~300 cached tokens a row",
         "launches_from": "deepseek-v3 serve from a bf16 MLA pool (7 x decode steps)",
         "pass": all(r["pass"] for r in mla_rows if r["kernel"] == "paged_attention_mla")},
        {"name": "paged_attention_mla_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:273",
         "launches": deepseek["launches"]["paged_attention_mla_quant"],
         "max_abs_err": mla_err["quant"], "ms": mla_main["quant"]["ms"],
         "plain_ms": mla_main["quant"]["plain_ms"], "bound_ms": mla_main["quant"]["bound_ms"],
         "bound_by": mla_main["quant"]["bound_by"],
         "library_ms": mla_main["quant"]["library_ms"],
         "work": "int4 pool, B=4 T=1 H=128 r=512 rope=64 block=16 bf16, ~300 cached tokens a row",
         "pass": all(r["pass"] for r in mla_rows if r["kernel"] == "paged_attention_mla_quant")},
    ]
    summary[0]["head_shape"] = {k: head[k] for k in ("M", "K", "N", "dtype", "max_abs_err", "ms",
                                                      "plain_ms", "bound_ms", "library_ms")}
    summary[0]["launches_olmoe_serve"] = olmoe["launches"]["fixedpoint_matmul"]
    summary[0]["launches_deepseek_serve"] = deepseek["launches"]["fixedpoint_matmul"]
    summary[0]["deepseek_decode_layer"] = dict(
        fpd_layer, work="one deepseek-v3 MoE layer's 2-D matmuls at decode (q_a, q_b, kv_a, "
                        "k_rope, o, the shared expert's 3) at M=4, 2-bit, bf16")
    summary[3]["launches_deepseek_serve"] = deepseek["launches"]["fixedpoint_matmul_experts"]
    summary[3]["deepseek_decode_layer"] = dict(
        fed_decode, work="one deepseek-v3 MoE layer's 3 expert stacks (256 experts, one f "
                         "each) at C=4, 2-bit, bf16")
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
