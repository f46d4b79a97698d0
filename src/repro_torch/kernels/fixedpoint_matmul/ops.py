"""Public wrapper: packed fixed-point matmul for arbitrary (M, K, N).

``fixedpoint_matmul`` launches a CUDA kernel (``csrc/fixedpoint_matmul.cu``)
for CUDA tensors and runs its plain version (``ref.py``) for CPU tensors.
``fixedpoint_matmul_experts`` is the MoE-stack form: one launch over all E
experts of a stack, each with its own exponent f[e] read on the device.
Both return x's dtype (the JAX call sites pass ``out_dtype=x.dtype``).

On the card each call takes one of three kernels by a fixed rule,
``_pick_route(dtype, rows, aligned)``: bf16 x with 16-byte aligned rows
and at most ``DECODE_MAX_ROWS`` rows (M, or C per expert: decode) goes to
the decode kernel ``fpmm_decode``, with more rows (prefill) to the
tensor-core kernel ``fpmm_tc``; fp32 x and unaligned rows go to the
streaming kernel ``fpmm_partial`` + ``fpmm_finish``.  Each kernel has its
own launch count.  The experts form takes an optional device vector
``rows`` (E,) int32, the rows of x[e] that hold a token: the decode kernel
reads only the words of experts with rows[e] > 0 and writes +0 for the
others (what their all-zero rows of x give); the other routes and the
plain version compute every expert.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.packing import pack_int, values_per_byte
from repro_torch.core.quantizer import delta_from_f, quantize_int
from repro_torch.kernels import build
from repro_torch.kernels.fixedpoint_matmul.ref import (
    fixedpoint_matmul_experts_ref,
    fixedpoint_matmul_ref,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("streaming", "tensor_core", "decode")
# Most rows (M, or C per expert) that take the decode kernel (one n8 MMA
# tile of tokens); every aligned bf16 call past it takes the tensor cores.
# chip_smoke.py phase 3g times the three kernels at 2..16 rows and fails
# if the rule sits on the wrong side of a measured crossover.
DECODE_MAX_ROWS = 8
TC_MIN_ROWS = DECODE_MAX_ROWS + 1
# the decode kernel's shape (csrc/fixedpoint_matmul.cu fpmm_decode): weight
# rows per ring stage, blocks a cluster may split K over, experts a `rows`
# vector may name; and the word bytes its grid gives each block
DECODE_BK, DECODE_MAX_SPLIT, DECODE_MAX_EXPERTS = 128, 8, 256
DECODE_BLOCK_BYTES = 64 * 1024
# kernel launches of each wrapper and route (plain-version calls on the CPU
# do not count): the streaming kernel, the tensor-core kernel, the decode kernel
launches = 0
experts_launches = 0
tc_launches = 0
tc_experts_launches = 0
decode_launches = 0
decode_experts_launches = 0


def pack_weight(w: torch.Tensor, f, n_bits: int = 2) -> torch.Tensor:
    """(K, N) float weight -> (K, N·n_bits/8) int8 packed mantissas."""
    return pack_int(quantize_int(w, delta_from_f(f, device=w.device), n_bits), n_bits)


def _as_compute(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _grid_shape(M: int, K: int, nbytes: int, n_sm: int, E: int = 1):
    """(m_tile, split): rows of x per block, and K splits so that the grid
    holds ~4 blocks per SM when the column groups x row tiles (x experts)
    are few, with at least 64 weight rows (one step of the block's 8 warps)
    per split."""
    m_tile = 1 if M == 1 else 2 if M == 2 else 4
    base = math.ceil(nbytes / 128) * math.ceil(M / m_tile) * E
    split = max(1, min(math.ceil(4 * n_sm / base), math.ceil(K / 64)))
    rows = math.ceil(K / split)
    return m_tile, math.ceil(K / rows)


def _pick_route(dtype, rows: int, aligned: bool) -> str:
    """The route rule, for bf16 x whose rows are 16-byte aligned (K % 8 ==
    0, aligned base): 'decode' up to DECODE_MAX_ROWS rows, 'tensor_core'
    above; everything else 'streaming'.  fp32 x stays on the streaming
    kernel: tensor cores would round it to bf16 or TF32, outside the fp32
    bar."""
    if dtype == torch.bfloat16 and aligned:
        return "decode" if rows <= DECODE_MAX_ROWS else "tensor_core"
    return "streaming"


def _decode_tile(experts: int, K: int, nbytes: int, n_sm: int):
    """(wn, split): the decode kernel's block width (wn warps side by side,
    32·wn word bytes of each row) and the blocks of a cluster that split K.
    The grid aims at one block per DECODE_BLOCK_BYTES of the words of
    ``experts`` experts, between half a block and two blocks an SM: below
    that the call is a few round trips long whatever its grid, and a block's
    fixed cost (its cluster's two barriers and sums) is paid more often.
    The widest block whose tiles, split up to 8 ways, reach that count (or
    one block an SM); then the largest power of two up to 8 (and up to the
    K steps) that stays within it.  ``experts`` is the bound the caller
    gives, never the device's count, so one shape always sums in one
    order."""
    want = min(2 * n_sm, max(n_sm // 2, math.ceil(experts * K * nbytes / DECODE_BLOCK_BYTES)))
    for wn in (4, 2, 1):
        tiles = experts * math.ceil(nbytes / (32 * wn))
        if tiles * DECODE_MAX_SPLIT >= min(want, n_sm):
            break
    cap = min(DECODE_MAX_SPLIT, math.ceil(K / DECODE_BK), math.ceil(want / tiles))
    split = 1
    while 2 * split <= cap:
        split *= 2
    return wn, split


def active_experts(rows, max_active: int, col_tiles: int = 1):
    """The decode kernel's walk, mirrored for the tests: the grid holds
    min(max_active, E)·col_tiles clusters (at least one); the items are
    (expert, column tile) for each expert with rows[e] > 0, expert-major;
    cluster c computes items c, c + n_clusters, ... in that order."""
    rows = [int(r) for r in rows]
    items = [(e, c) for e, r in enumerate(rows) if r > 0 for c in range(col_tiles)]
    n = _decode_clusters(len(rows), max_active, col_tiles)
    return [items[i::n] for i in range(n)]


def _decode_clusters(E: int, max_active: int, col_tiles: int) -> int:
    """Clusters of the decode kernel's grid: one per column tile of each of
    the min(max_active, E) experts it expects to compute."""
    return max(1, min(max_active, E)) * col_tiles


def _tc_tile(rows: int, K: int, nbytes: int, n_sm: int, E: int = 1):
    """(tile, split): the tensor-core kernel's block shape (``launch_tc``;
    32 tokens a block) and the blocks of a cluster that split K.  0
    (lines: 4 warps side by side on 128 word bytes, each weight row read as
    whole 128-byte lines) when its grid fills half the card or more, as
    every expert stack's does; else 1 (narrow: 32 word bytes, 4 warps
    splitting K) when that grid fills the card; else 2 (deep: the narrow
    tile, 8 warps splitting K), with clusters of up to 4 blocks splitting
    K (at least 2 steps of 256 rows each) so that the few tiles of a small
    call reach more SMs."""
    tok = E * math.ceil(rows / 32)
    if math.ceil(nbytes / 128) * tok >= n_sm / 2:
        return 0, 1
    tiles = math.ceil(nbytes / 32) * tok
    if tiles >= n_sm:
        return 1, 1
    return 2, max(1, min(4, n_sm // tiles, math.ceil(K / 256) // 2))


def _route_for(x, rows: int, K: int, route) -> str:
    aligned = K % 8 == 0 and x.data_ptr() % 16 == 0
    if route is None:
        return _pick_route(x.dtype, rows, aligned)
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route != "streaming" and not (x.dtype == torch.bfloat16 and aligned):
        raise ValueError(f"the {route} kernel takes bf16 x with K % 8 == 0 on a 16-byte "
                         f"aligned base, got {x.dtype}, K={K}")
    if route == "decode" and not 1 <= rows <= DECODE_MAX_ROWS:
        raise ValueError(f"the decode kernel takes 1..{DECODE_MAX_ROWS} rows, got {rows}")
    return route


def _check_operands(x, n_bits: int) -> int:
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"fixedpoint_matmul kernel takes f32/bf16 x, got {x.dtype}")
    if n_bits not in (2, 4):
        raise ValueError(f"fixedpoint_matmul kernel takes n_bits 2 or 4, got {n_bits}")
    return code


def _launch_decode(x, packed_w, f, bias, rows, y, E: int, M: int, K: int, n_out: int,
                   nbytes: int, n_bits: int, experts: int, experts_form: bool) -> None:
    """One decode-kernel launch over E experts (the 2-D form: E = 1), its
    grid sized for ``experts`` of them (the block shape too: see
    _decode_tile)."""
    dev = x.device
    wn, split = _decode_tile(experts, K, nbytes, build.sm_count(dev))
    n_clusters = _decode_clusters(E, experts, math.ceil(nbytes / (32 * wn)))
    err = build.library().fixedpoint_matmul_decode_launch(
        x.data_ptr(), packed_w.data_ptr(), f.data_ptr(),
        None if bias is None else bias.data_ptr(), None if rows is None else rows.data_ptr(),
        y.data_ptr(), E, M, K, n_out, nbytes, n_bits, wn, split, n_clusters, int(experts_form),
        build.current_stream(dev),
    )
    build.check(err, "fixedpoint_matmul (decode)")


def _launch(x2, packed_w, f, bias, n_bits: int, n_out: int, route) -> torch.Tensor:
    global launches, tc_launches, decode_launches
    dev = x2.device
    M, K = x2.shape
    nbytes = n_out * n_bits // 8
    code = _check_operands(x2, n_bits)
    if packed_w.dtype != torch.int8 or packed_w.shape != (K, nbytes):
        raise ValueError(f"packed_w must be int8 ({K}, {nbytes}), got "
                         f"{packed_w.dtype} {tuple(packed_w.shape)}")
    if not isinstance(f, torch.Tensor):
        f = torch.tensor(f, dtype=torch.int32, device=dev)
    if f.dtype != torch.int32 or f.numel() != 1:
        raise ValueError(f"f must be one int32 exponent, got {f.dtype} {tuple(f.shape)}")
    if packed_w.device != dev or f.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"operands must all lie on {dev}")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous()):
        bias = bias.to(torch.float32).contiguous()
    x2, packed_w = x2.contiguous(), packed_w.contiguous()
    route = _route_for(x2, M, K, route)
    y = torch.empty((M, n_out), dtype=x2.dtype, device=dev)
    bias_ptr = bias.data_ptr() if bias is not None else None
    if route == "decode":
        _launch_decode(x2, packed_w, f, bias, None, y, 1, M, K, n_out, nbytes, n_bits, 1, False)
        decode_launches += 1
        return y
    if route == "tensor_core":
        tile, split = _tc_tile(M, K, nbytes, build.sm_count(dev))
        err = build.library().fixedpoint_matmul_tc_launch(
            x2.data_ptr(), packed_w.data_ptr(), f.data_ptr(), bias_ptr, y.data_ptr(),
            M, K, n_out, nbytes, n_bits, tile, split, build.current_stream(dev),
        )
        build.check(err, "fixedpoint_matmul (tensor cores)")
        tc_launches += 1
        return y
    m_tile, split = _grid_shape(M, K, nbytes, build.sm_count(dev))
    ws = torch.empty((split, M, n_out), dtype=torch.float32, device=dev)
    err = build.library().fixedpoint_matmul_launch(
        x2.data_ptr(), packed_w.data_ptr(), f.data_ptr(), bias_ptr, y.data_ptr(), ws.data_ptr(),
        M, K, n_out, nbytes, n_bits, code, split, m_tile, build.current_stream(dev),
    )
    build.check(err, "fixedpoint_matmul")
    launches += 1
    return y


def fixedpoint_matmul(x, packed_w, f, bias=None, *, n_bits: int = 2, n_out: int,
                      _route=None) -> torch.Tensor:
    """y = x @ (unpack(packed_w)·2^{-f}) [+ bias] in x's dtype.  x: (..., K).
    ``_route`` ('streaming' | 'tensor_core' | 'decode') overrides the route
    rule on the card; it exists so that the kernels can be timed at one
    shape."""
    values_per_byte(n_bits)
    x = _as_compute(x)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.is_cuda:
        y = _launch(x2, packed_w, f, bias, n_bits, n_out, _route)
    else:
        y = fixedpoint_matmul_ref(x2, packed_w, f, bias, n_bits=n_bits, n_out=n_out).to(x.dtype)
    return y.reshape(*lead, n_out)


def _launch_experts(x, packed_w, f, rows, max_active, n_bits: int, n_out: int,
                    route) -> torch.Tensor:
    global experts_launches, tc_experts_launches, decode_experts_launches
    dev = x.device
    E, C, K = x.shape
    nbytes = n_out * n_bits // 8
    code = _check_operands(x, n_bits)
    if packed_w.dtype != torch.int8 or packed_w.shape != (E, K, nbytes):
        raise ValueError(f"packed_w must be int8 ({E}, {K}, {nbytes}), got "
                         f"{packed_w.dtype} {tuple(packed_w.shape)}")
    if not isinstance(f, torch.Tensor) or f.dtype != torch.int32 or f.shape != (E,):
        raise ValueError(f"f must be an int32 ({E},) tensor of per-expert exponents, got "
                         f"{getattr(f, 'dtype', type(f))} {tuple(getattr(f, 'shape', ()))}")
    if packed_w.device != dev or f.device != dev:
        raise ValueError(f"operands must all lie on {dev}")
    x, packed_w, f = x.contiguous(), packed_w.contiguous(), f.contiguous()
    route = _route_for(x, C, K, route)
    y = torch.empty((E, C, n_out), dtype=x.dtype, device=dev)
    if route == "decode":
        if rows is not None and E > DECODE_MAX_EXPERTS:
            raise ValueError(f"the decode kernel takes rows for at most {DECODE_MAX_EXPERTS} "
                             f"experts, got {E}")
        _launch_decode(x, packed_w, f, None, rows, y, E, C, K, n_out, nbytes, n_bits,
                       max(1, min(E if max_active is None else max_active, E)), True)
        decode_experts_launches += 1
        return y
    if route == "tensor_core":
        tile, split = _tc_tile(C, K, nbytes, build.sm_count(dev), E)
        err = build.library().fixedpoint_matmul_experts_tc_launch(
            x.data_ptr(), packed_w.data_ptr(), f.data_ptr(), y.data_ptr(),
            E, C, K, n_out, nbytes, n_bits, tile, split, build.current_stream(dev),
        )
        build.check(err, "fixedpoint_matmul_experts (tensor cores)")
        tc_experts_launches += 1
        return y
    m_tile, split = _grid_shape(C, K, nbytes, build.sm_count(dev), E)
    ws = torch.empty((split, E, C, n_out), dtype=torch.float32, device=dev)
    err = build.library().fixedpoint_matmul_experts_launch(
        x.data_ptr(), packed_w.data_ptr(), f.data_ptr(), y.data_ptr(), ws.data_ptr(),
        E, C, K, n_out, nbytes, n_bits, code, split, m_tile, build.current_stream(dev),
    )
    build.check(err, "fixedpoint_matmul_experts")
    experts_launches += 1
    return y


def _check_rows(rows, E: int, dev):
    if rows is None:
        return None
    if not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32 or rows.shape != (E,):
        got = f"{getattr(rows, 'dtype', type(rows))} {tuple(getattr(rows, 'shape', ()))}"
        raise ValueError(f"rows must be an int32 ({E},) tensor, got {got}")
    if rows.device != dev:
        raise ValueError(f"rows on {rows.device}, x on {dev}")
    return rows.contiguous()


def fixedpoint_matmul_experts(x, packed_w, f, *, n_bits: int = 2, n_out: int, rows=None,
                              max_active: int = None, _route=None) -> torch.Tensor:
    """Per-expert packed matmul in x's dtype: y[e] = x[e] @ (unpack(w[e])·2^{-f[e]}).
    x (E, C, K) float; packed_w (E, K, n_out·n_bits/8) int8; f (E,) int32.
    ``rows`` (E,) int32 on x's device, optional: the rows of x[e] that hold
    a token (the rest of x[e] is zero); y[e] is +0 where rows[e] == 0 (the
    decode kernel and the plain version write it without x[e]'s words;
    the other kernels compute it from the zero rows).
    ``max_active``: a host bound on the experts with rows[e] > 0 (default
    E); it sizes the decode kernel's grid only, so a wrong bound costs
    time, never a result.  ``_route`` as in ``fixedpoint_matmul``."""
    values_per_byte(n_bits)
    x = _as_compute(x)
    if x.ndim != 3:
        raise ValueError(f"x must be (E, C, K), got {tuple(x.shape)}")
    rows = _check_rows(rows, x.shape[0], x.device)
    if x.is_cuda:
        return _launch_experts(x, packed_w, f, rows, max_active, n_bits, n_out, _route)
    return fixedpoint_matmul_experts_ref(x, packed_w, f, n_bits=n_bits, n_out=n_out,
                                         rows=rows).to(x.dtype)
