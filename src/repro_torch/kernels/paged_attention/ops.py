"""Public wrappers: fused paged GQA/MQA attention for decode / verify /
tail prefill, and the absorbed multi-head-latent-attention (MLA) decode.

``paged_attention`` and ``paged_attention_mla`` launch their CUDA kernels
(``csrc/paged_attention.cu``, ``csrc/gqa_prefill.cu``) for CUDA tensors and
run their plain versions (``ref.py``) for CPU tensors.  Each has two kernels
behind one rule: GQA (``_gqa_route``) the tensor-core ``gqa_prefill`` for
bf16 queries with many rows a KV head over pools exact in bf16,
``gqa_decode`` otherwise; MLA (``_mla_route``) the tensor-core
``mla_decode_tc`` for bf16 queries over pools exact in bf16,
``mla_partial`` + ``attn_combine`` otherwise.
Queries must be contiguous per row: q_pos[b, t] = pos0[b] + t.
``window=None`` maps onto the 2^30 sentinel; ``kv_scale`` is 2^-KV_F for
int8 fixed-point (KV_F) pools and 1.0 for float pools.  SYMOG-quantized
pools pass ``k_scale_exp``/``v_scale_exp`` (n_blocks, K) int32 exponents
and ``kv_bits`` 8 (int8 words) or 4 (split-halves int4 words, last dim
hd/2); each (block, KV head) is dequantized as word · 2^e.  The MLA pools
(c_kv and k_rope) have no head axis: a quantized one carries one exponent
per physical block, (n_blocks,) int32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_mla_ref, paged_attention_ref

_NO_WINDOW = 2**30  # models.config.GLOBAL_WINDOW
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_QUANT_CODE = {8: 3, 4: 4}  # int8 words / int4 split-halves words, with exponents
# kernel launches (plain-version calls on the CPU do not count): float / KV_F
# pools, and SYMOG-quantized pools (the `_attn_kernel_quant` variant), on
# either GQA route, and again for the prefill route alone (`gqa_prefill`);
# the same for the MLA kernels (`_mla_kernel`, `_mla_kernel_quant`) on either
# route, and again for the tensor-core route alone (`mla_decode_tc`)
launches = 0
quant_launches = 0
prefill_launches = 0
prefill_quant_launches = 0
mla_launches = 0
mla_quant_launches = 0
mla_tc_launches = 0
mla_tc_quant_launches = 0


# csrc/paged_attention.cu's GQA kernel: each warp takes tiles of TILE tokens
# (a block, or TILE tokens of a longer one), WARPS warps a thread block, and
# the splits of one (b, kv_head, row tile) form one cluster of at most
# MAX_SPLIT thread blocks
TILE, WARPS, MAX_SPLIT = 16, 4, 8
HD_MAX = 256  # head dims a lane can hold: 8 of them, 32 lanes


def _row_tile(TG: int) -> int:
    """Query rows (T·G) a thread block holds in registers: 1, 2 or 4."""
    return 1 if TG == 1 else 2 if TG == 2 else 4


def _n_split(B: int, K: int, row_tiles: int, max_blocks: int, block: int, n_sm: int) -> int:
    """Thread blocks per (b, kv_head, row tile), one cluster: the largest
    power of two up to MAX_SPLIT that puts no more than ~4 thread blocks on
    each SM, gives no warp an empty share of the longest possible row
    (``max_blocks`` is only that upper bound: the kernel cuts each row's
    own visible range on the device) and never exceeds ``max_blocks``."""
    tiles = max_blocks * math.ceil(block / TILE)
    want = min(MAX_SPLIT, max_blocks, math.ceil(tiles / WARPS),
               max(1, (4 * n_sm) // (B * K * row_tiles)))
    s = 1
    while 2 * s <= want:
        s *= 2
    return s


def visible_tiles(pos0: int, G: int, row0: int, rows: int, window: int, block: int,
                  max_blocks: int):
    """The tiles [u_lo, u_hi) that query rows row0.. row0 + rows - 1 of one
    (b, kv_head) can see, as the kernel derives them from pos0 on the device:
    tile u is block u // tpb, tokens (u % tpb)·TILE.. of it (tpb = ceil(block
    / TILE)); tiles past the last row's position, or wholly outside the
    first row's window, are skipped.  A Python mirror for the tests."""
    tpb = math.ceil(block / TILE)
    hi_tok = min(pos0 + (row0 + rows - 1) // G, max_blocks * block - 1)
    lo_tok = max(0, pos0 + row0 // G - window + 1)
    if lo_tok > hi_tok:
        return 0, 0
    u_lo = (lo_tok // block) * tpb + (lo_tok % block) // TILE
    return u_lo, (hi_tok // block) * tpb + (hi_tok % block) // TILE + 1


def worker_tiles(u_lo: int, u_hi: int, n_split: int):
    """The kernel's cut of [u_lo, u_hi) over n_split·WARPS warps, in rank
    order (split-major): contiguous, balanced to one tile, possibly empty."""
    n, nw = u_hi - u_lo, n_split * WARPS
    return [(u_lo + w * n // nw, u_lo + (w + 1) * n // nw) for w in range(nw)]


# csrc/gqa_prefill.cu: a thread block takes PREFILL_ROWS query rows of one
# (b, kv_head)'s T·G row axis and key tiles of PREFILL_KEYS tokens; a
# cluster of at most PREFILL_MAX_SPLIT thread blocks splits a query tile's
# key range
PREFILL_ROWS, PREFILL_KEYS, PREFILL_MAX_SPLIT = 64, 64, 4
# T·G from which the rule takes the prefill kernel: chip_smoke.py 3e's
# crossover sweep of the two kernels on the card (H100, 8 .. 512 rows): the
# prefill kernel wins from 64 rows at gemma3's shape (B 1, K 4, hd 256, int4
# pool, ~1,000 cached tokens) and from 10 at internlm2's (B 4, K 8, hd 128,
# bf16 pool, ~300); 64 is the least count where it wins at both
PREFILL_MIN_ROWS = 64
GQA_ROUTES = ("decode", "prefill")  # gqa_decode; gqa_prefill


def _pow2(x: float) -> bool:
    return x > 0 and math.frexp(x)[0] == 0.5


def _pool_code(pool_dtype, kv_bits: int):
    """The kernels' pool code: 0 fp32, 1 bf16, 2 int8 (KV_F), 3 / 4 SYMOG
    int8 / int4 words (None: a dtype no kernel takes)."""
    return _QUANT_CODE.get(kv_bits) if kv_bits else _KV_CODE.get(pool_dtype)


def _gqa_route(q_dtype, pool_code, kv_scale: float, hd: int, block: int, TG: int,
               aligned: bool = True) -> str:
    """Which GQA kernel takes a call.  'prefill' (``gqa_prefill``, the
    tensor cores) for bf16 queries over a pool whose values are exact in
    bf16 -- SYMOG int8 / int4 words (codes 3 / 4), KV_F int8 under a
    power-of-two ``kv_scale``, or bf16 under kv_scale 1 -- with hd a multiple
    of 16 up to 256 (its k-steps and column pairs), ``block`` a multiple of 16
    (a 16-key step never straddles two blocks), pools 8-byte aligned
    (``aligned``: its row copies) and at least PREFILL_MIN_ROWS query rows a
    KV head (T·G).  'decode' (``gqa_decode``, fp32 on the CUDA cores) for
    everything else: fp32 queries or pools, other scales and widths, the
    decode steps."""
    exact = (pool_code in (3, 4) or (pool_code == 1 and kv_scale == 1.0)
             or (pool_code == 2 and _pow2(kv_scale)))
    widths = hd % 16 == 0 and 16 <= hd <= HD_MAX and block % 16 == 0
    take = (q_dtype == torch.bfloat16 and exact and widths and aligned
            and TG >= PREFILL_MIN_ROWS)
    return "prefill" if take else "decode"


def _prefill_split(B: int, K: int, q_tiles: int, max_blocks: int, block: int, n_sm: int) -> int:
    """gqa_prefill's thread blocks per (query tile, b, kv_head), one
    cluster: doubled up to PREFILL_MAX_SPLIT while the grid stays within
    the SM count (a 256-row chunk of gemma3: 8 tiles x 4 heads, 4 ranks) and
    the longest possible row has a key tile a rank (``max_blocks`` is only
    that bound: the kernel cuts each query tile's own range on the device)."""
    tiles = math.ceil(max_blocks * block / PREFILL_KEYS)
    s = 1
    while 2 * s <= min(PREFILL_MAX_SPLIT, tiles) and 2 * s * q_tiles * B * K <= n_sm:
        s *= 2
    return s


def prefill_key_tiles(pos0: int, G: int, row0: int, rows: int, window: int, block: int,
                      max_blocks: int):
    """The key tiles [v_lo, v_hi) that query rows row0.. row0 + rows - 1 of
    one (b, kv_head) can see, as gqa_prefill derives them from pos0 on the
    device: tile v holds logical tokens PREFILL_KEYS·v..; tiles past the
    last row's position (or the table), or wholly before the first row's
    window, are skipped.  A Python mirror for the tests."""
    hi_tok = min(pos0 + (row0 + rows - 1) // G, max_blocks * block - 1)
    lo_tok = max(0, pos0 + row0 // G - window + 1)
    if lo_tok > hi_tok:
        return 0, 0
    return lo_tok // PREFILL_KEYS, hi_tok // PREFILL_KEYS + 1


def prefill_read_tokens(pos0: int, G: int, row0: int, rows: int, window: int, block: int,
                        max_blocks: int, v: int):
    """The tokens [t_lo, t_hi) of key tile v that gqa_prefill reads for that
    query tile: its 16-token sub-tiles holding a key in [first row's window
    start, last row's position]; the others it zero-fills.  A Python mirror
    for the tests."""
    hi_tok = min(pos0 + (row0 + rows - 1) // G, max_blocks * block - 1)
    lo_tok = max(0, pos0 + row0 // G - window + 1)
    kv0 = v * PREFILL_KEYS
    return max(0, lo_tok - kv0) // 16 * 16, min(PREFILL_KEYS, (hi_tok - kv0) // 16 * 16 + 16)


def prefill_rank_tiles(v_lo: int, v_hi: int, n_split: int):
    """gqa_prefill's cut of [v_lo, v_hi) over a cluster's ranks, in rank
    order: contiguous, balanced to one tile, possibly empty."""
    n = v_hi - v_lo
    return [(v_lo + c * n // n_split, v_lo + (c + 1) * n // n_split) for c in range(n_split)]


def _check_quant(k_pool, v_pool, k_exp, v_exp, kv_bits: int, nb: int, K: int) -> int:
    """The pool code of a SYMOG-quantized pool pair (3: int8, 4: int4)."""
    if kv_bits not in _QUANT_CODE:
        raise ValueError(f"kv_bits must be 8 or 4 with exponent leaves, got {kv_bits}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"quantized pools hold int8 words, got {k_pool.dtype}/{v_pool.dtype}")
    for name, e in (("k_scale_exp", k_exp), ("v_scale_exp", v_exp)):
        if e is None or e.dtype != torch.int32 or e.shape != (nb, K):
            raise ValueError(f"{name} must be int32 ({nb}, {K}), got "
                             f"{getattr(e, 'dtype', None)} {tuple(getattr(e, 'shape', ()))}")
        if not e.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return _QUANT_CODE[kv_bits]


def _launch(q, k_pool, v_pool, block_tables, pos0, *, scale, cap, window, kv_scale,
            k_exp=None, v_exp=None, kv_bits: int = 0, route: str = "decode"):
    global launches, quant_launches, prefill_launches, prefill_quant_launches
    dev = q.device
    B, T, K, G, hd = q.shape
    nb, block = k_pool.shape[:2]
    q_code, kv_code = _Q_CODE.get(q.dtype), _KV_CODE.get(k_pool.dtype)
    if q_code is None:
        raise TypeError(f"paged_attention kernel takes f32/bf16 q, got {q.dtype}")
    if kv_code is None or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share a f32/bf16/int8 dtype, got {k_pool.dtype}/{v_pool.dtype}")
    hdw = hd
    if hd % 8 or not 8 <= hd <= HD_MAX:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 in [8, {HD_MAX}], got {hd}")
    if window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if kv_bits:
        kv_code = _check_quant(k_pool, v_pool, k_exp, v_exp, kv_bits, nb, K)
        if kv_bits == 4:
            hdw = hd // 2  # two lanes per int8 word
    want = (nb, block, K, hdw)
    if k_pool.shape != want or v_pool.shape != want:
        raise ValueError(f"pools must be {want}, got {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (a layer's slice of a stacked pool is)")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be int32 ({B}, max_blocks)")
    if pos0.dtype != torch.int32 or pos0.shape != (B,):
        raise ValueError(f"pos0 must be int32 ({B},)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("block_tables", block_tables),
                    ("pos0", pos0), ("k_scale_exp", k_exp), ("v_scale_exp", v_exp)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    # the kernel reads q and writes out in the caller's (B, T, K, G, hd) layout
    q = q.contiguous()
    bt, pos0 = block_tables.contiguous(), pos0.contiguous()
    TG, max_blocks = T * G, bt.shape[1]
    exps = (None if k_exp is None else k_exp.data_ptr(),
            None if v_exp is None else v_exp.data_ptr())
    if route == "prefill":
        if q.data_ptr() % 16:
            q = q.clone()  # the kernel stages query rows by 16-byte copies
        n_split = _prefill_split(B, K, math.ceil(TG / PREFILL_ROWS), max_blocks, block,
                                 build.sm_count(dev))
        out = torch.empty_like(q)
        err = build.library().gqa_prefill_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(), pos0.data_ptr(),
            *exps, out.data_ptr(), B, K, T, G, hd, block, max_blocks, int(window), kv_code,
            n_split, float(scale), float(cap), float(kv_scale), build.current_stream(dev),
        )
        build.check(err, "paged_attention (gqa_prefill)")
        if kv_bits:
            prefill_quant_launches += 1
        else:
            prefill_launches += 1
    else:
        n_split = _n_split(B, K, math.ceil(TG / _row_tile(TG)), max_blocks, block,
                           build.sm_count(dev))
        out = torch.empty_like(q)
        err = build.library().paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(), pos0.data_ptr(),
            *exps, out.data_ptr(), B, K, T, G, hd, block, max_blocks, int(window), q_code,
            kv_code, n_split, float(scale), float(cap), float(kv_scale),
            build.current_stream(dev),
        )
        build.check(err, "paged_attention")
    if kv_bits:
        quant_launches += 1
    else:
        launches += 1
    return out


def paged_attention(q, k_pool, v_pool, block_tables, pos0, *, scale: float, cap: float = 0.0,
                    window=None, kv_scale: float = 1.0, k_scale_exp=None, v_scale_exp=None,
                    kv_bits: int = 0, out_dtype=None, _route=None):
    """q (B, T, K, G, hd); k/v pools (n_blocks, block, K, hd) float or int8
    (hd/2 int8 words for int4 pools); block_tables (B, max_blocks) int32
    (trash block 0 for unused entries); pos0 (B,) int32 first query position
    per row; ``k_scale_exp``/``v_scale_exp`` (n_blocks, K) int32 with
    ``kv_bits`` for SYMOG-quantized pools.  Returns (B, T, K, G, hd).  On
    the card ``_gqa_route`` picks the kernel; ``_route`` ('decode' or
    'prefill') forces one (card tests and chip_smoke.py), and a 'prefill'
    the rule refuses raises ValueError on either device."""
    quant = k_scale_exp is not None
    if quant != (v_scale_exp is not None) or quant != (kv_bits != 0) or kv_bits not in (0, 4, 8):
        raise ValueError("quantized pools take both exponent leaves and kv_bits 8 or 4; "
                         f"got k/v exponents {quant}/{v_scale_exp is not None}, kv_bits {kv_bits}")
    if _route not in (None,) + GQA_ROUTES:
        raise ValueError(f"route {_route!r} is not one of {GQA_ROUTES}")
    if q.is_cuda or _route == "prefill":
        B, T, K, G, hd = q.shape
        aligned = k_pool.data_ptr() % 8 == 0 and v_pool.data_ptr() % 8 == 0
        rule = _gqa_route(q.dtype, _pool_code(k_pool.dtype, kv_bits), kv_scale, hd,
                          k_pool.shape[1], T * G, aligned)
        if _route == "prefill" and rule != "prefill":
            raise ValueError(f"route 'prefill' does not take this call (the rule gives {rule!r})")
        _route = _route or rule
    if q.is_cuda:
        w = _NO_WINDOW if window is None else int(window)
        out = _launch(q, k_pool, v_pool, block_tables, pos0, scale=scale, cap=cap,
                      window=w, kv_scale=kv_scale, k_exp=k_scale_exp, v_exp=v_scale_exp,
                      kv_bits=kv_bits, route=_route)
    else:
        out = paged_attention_ref(q, k_pool, v_pool, block_tables, pos0, scale=scale,
                                  cap=cap, window=window, kv_scale=kv_scale,
                                  k_scale_exp=k_scale_exp, v_scale_exp=v_scale_exp,
                                  kv_bits=kv_bits)
    return out.to(out_dtype) if out_dtype is not None else out


# ---------------------------------------------------------------------------
# absorbed MLA decode: two kernels behind one rule
# ---------------------------------------------------------------------------
MLA_ROWS = 16  # query rows (T·H) per thread block of mla_partial: csrc kMlaRows
MLA_TC_ROWS = 32  # of mla_decode_tc: csrc kTcRows
MLA_TC_MAX_RANK, MLA_TC_MAX_DEPTH = 512, 576  # r, and r + rope, its registers hold
MLA_ROUTES = ("partial", "tc")  # mla_partial + attn_combine; mla_decode_tc


def _mla_route(q_dtype, pool_dtype, kv_bits: int, kv_scale: float, r: int, rope: int,
               aligned: bool = True) -> str:
    """Which MLA kernel takes a call.  'tc' (``mla_decode_tc``, the tensor
    cores) for bf16 queries over a pool whose values are exact in bf16 --
    SYMOG int8 / int4 words (word x 2^e), KV_F int8 under a power-of-two
    ``kv_scale``, or bf16 under kv_scale 1 -- with r and rope multiples of
    16 (its k-steps and column pairs; no zero padding), 16 <= r <= 512,
    rope >= 16 and r + rope <= 576 (the fragments it holds in registers),
    and 4-byte aligned operands (``aligned``).  'partial' (``mla_partial``
    + ``attn_combine``, fp32 on the CUDA cores) for everything else: fp32
    queries, fp32 pools, other scales and widths."""
    exact = (kv_bits in _QUANT_CODE
             or (pool_dtype == torch.bfloat16 and kv_scale == 1.0)
             or (pool_dtype == torch.int8 and not kv_bits and _pow2(kv_scale)))
    widths = (r % 16 == 0 and rope % 16 == 0 and 16 <= r <= MLA_TC_MAX_RANK and rope >= 16
              and r + rope <= MLA_TC_MAX_DEPTH)
    return "tc" if q_dtype == torch.bfloat16 and exact and widths and aligned else "partial"


def _mla_n_split(B: int, row_tiles: int, max_blocks: int, n_sm: int) -> int:
    """mla_partial's KV splits per (b, row tile): ~2 thread blocks per SM
    (each holds ~100 KB of shared memory at r = 512, so two fit on an SM)."""
    return max(1, min(max_blocks, math.ceil(2 * n_sm / (B * row_tiles))))


def _mla_tc_split(B: int, row_tiles: int, max_blocks: int, block: int, n_sm: int) -> int:
    """mla_decode_tc's ranks per (row tile, b), one cluster: at most
    MAX_SPLIT and no more than the longest possible row has tiles
    (``max_blocks`` is only that bound: the kernel cuts each row tile's own
    visible tiles on the device).  Within that, thread blocks for 3/4 of
    the SMs, so that every cluster is resident at once, one block an SM
    (deepseek-v3's decode, B 4 x 4 row tiles: 6 ranks; 8 put two blocks on
    some SMs and wait on them); but at least 4 ranks where two blocks an SM
    hold them (T 3: 12 row tiles, 4 ranks, each with a quarter of the
    tiles).  chip_smoke.py 3f times 4 and 8 ranks beside the rule's."""
    tiles = max_blocks * math.ceil(block / TILE)
    pairs = B * row_tiles
    want = max((3 * n_sm) // (4 * pairs), min(4, (2 * n_sm) // pairs))
    return max(1, min(MAX_SPLIT, tiles, want))


def mla_visible_tiles(pos0: int, H: int, row0: int, rows: int, block: int,
                      max_blocks: int) -> int:
    """The tiles [0, n) that query rows row0.. row0 + rows - 1 of a batch row
    can see, as mla_decode_tc derives them from pos0 on the device: tile u
    is block u // tpb, tokens (u % tpb)·TILE.. of it (tpb = ceil(block /
    TILE)); tiles past the last row's position are skipped.  A Python
    mirror for the tests."""
    tpb = math.ceil(block / TILE)
    hi_tok = min(pos0 + (row0 + rows - 1) // H, max_blocks * block - 1)
    return 0 if hi_tok < 0 else (hi_tok // block) * tpb + (hi_tok % block) // TILE + 1


def mla_rank_tiles(n: int, n_split: int):
    """mla_decode_tc's cut of [0, n) over the cluster's ranks, in rank order:
    contiguous, balanced to one tile, possibly empty."""
    return [(c * n // n_split, (c + 1) * n // n_split) for c in range(n_split)]


def _launch_mla(q_eff, q_rope, ckv_pool, krope_pool, block_tables, pos0, *, scale, kv_scale,
                c_exp=None, r_exp=None, kv_bits: int = 0, route=None, n_split=None):
    global mla_launches, mla_quant_launches, mla_tc_launches, mla_tc_quant_launches
    dev = q_eff.device
    B, T, H, r = q_eff.shape
    rope = q_rope.shape[-1]
    nb, block = ckv_pool.shape[:2]
    q_code, kv_code = _Q_CODE.get(q_eff.dtype), _KV_CODE.get(ckv_pool.dtype)
    if q_code is None or q_rope.dtype != q_eff.dtype:
        raise TypeError(f"paged_attention_mla takes f32/bf16 q_eff and q_rope of one dtype, got "
                        f"{q_eff.dtype}/{q_rope.dtype}")
    if kv_code is None or krope_pool.dtype != ckv_pool.dtype:
        raise TypeError(f"pools must share a f32/bf16/int8 dtype, got "
                        f"{ckv_pool.dtype}/{krope_pool.dtype}")
    if q_rope.shape[:3] != (B, T, H):
        raise ValueError(f"q_rope must be ({B}, {T}, {H}, rope), got {tuple(q_rope.shape)}")
    rw, ropew = r, rope
    if kv_bits:
        if kv_bits not in _QUANT_CODE:
            raise ValueError(f"kv_bits must be 8 or 4 with exponent leaves, got {kv_bits}")
        if ckv_pool.dtype != torch.int8:
            raise TypeError(f"quantized pools hold int8 words, got {ckv_pool.dtype}")
        for name, e in (("ckv_scale_exp", c_exp), ("kr_scale_exp", r_exp)):
            if e.dtype != torch.int32 or e.shape != (nb,) or not e.is_contiguous():
                raise ValueError(f"{name} must be contiguous int32 ({nb},), got {e.dtype} "
                                 f"{tuple(e.shape)}")
        kv_code = _QUANT_CODE[kv_bits]
        if kv_bits == 4:
            if r % 2 or rope % 2:
                raise ValueError(f"int4 pools need even widths, got r {r}, rope {rope}")
            rw, ropew = r // 2, rope // 2  # two lanes per int8 word
    if ckv_pool.shape != (nb, block, rw) or krope_pool.shape != (nb, block, ropew):
        raise ValueError(f"pools must be ({nb}, {block}, {rw}) and ({nb}, {block}, {ropew}), got "
                         f"{tuple(ckv_pool.shape)}/{tuple(krope_pool.shape)}")
    if not (ckv_pool.is_contiguous() and krope_pool.is_contiguous()):
        raise ValueError("pools must be contiguous (a layer's slice of a stacked pool is)")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be int32 ({B}, max_blocks)")
    if pos0.dtype != torch.int32 or pos0.shape != (B,):
        raise ValueError(f"pos0 must be int32 ({B},)")
    for name, t in (("q_rope", q_rope), ("ckv_pool", ckv_pool), ("krope_pool", krope_pool),
                    ("block_tables", block_tables), ("pos0", pos0), ("ckv_scale_exp", c_exp),
                    ("kr_scale_exp", r_exp)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, q_eff on {dev}")
    q_eff, q_rope = q_eff.contiguous(), q_rope.contiguous()
    bt, pos0 = block_tables.contiguous(), pos0.contiguous()
    TH, max_blocks = T * H, bt.shape[1]
    aligned = all(t.data_ptr() % 4 == 0 for t in (q_eff, q_rope, ckv_pool, krope_pool))
    rule = _mla_route(q_eff.dtype, ckv_pool.dtype, kv_bits, kv_scale, r, rope, aligned)
    if route is None:
        route = rule
    elif route not in MLA_ROUTES or (route == "tc" and rule != "tc"):
        raise ValueError(f"route {route!r} does not take this call (the rule gives {rule!r})")
    out = torch.empty_like(q_eff)
    exps = (None if c_exp is None else c_exp.data_ptr(),
            None if r_exp is None else r_exp.data_ptr())
    if route == "tc":
        row_tiles = math.ceil(TH / MLA_TC_ROWS)
        if n_split is None:
            n_split = _mla_tc_split(B, row_tiles, max_blocks, block, build.sm_count(dev))
        elif not 1 <= n_split <= MAX_SPLIT:
            raise ValueError(f"n_split must be 1..{MAX_SPLIT}, got {n_split}")
        err = build.library().paged_attention_mla_tc_launch(
            q_eff.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(), krope_pool.data_ptr(),
            bt.data_ptr(), pos0.data_ptr(), *exps, out.data_ptr(), B, T, H, r, rope, block,
            max_blocks, kv_code, n_split, float(scale), float(kv_scale),
            build.current_stream(dev),
        )
        build.check(err, "paged_attention_mla (tensor cores)")
        if kv_bits:
            mla_tc_quant_launches += 1
        else:
            mla_tc_launches += 1
    else:
        if n_split is not None:
            raise ValueError("n_split is mla_decode_tc's (route 'tc')")
        n_split = _mla_n_split(B, math.ceil(TH / MLA_ROWS), max_blocks, build.sm_count(dev))
        ptrs = (None, None, None)
        if n_split > 1:
            ws = torch.empty((B * n_split * TH * (r + 2),), dtype=torch.float32, device=dev)
            n_ml = B * n_split * TH
            ptrs = (ws.data_ptr(), ws.data_ptr() + 4 * n_ml, ws.data_ptr() + 8 * n_ml)
        err = build.library().paged_attention_mla_launch(
            q_eff.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(), krope_pool.data_ptr(),
            bt.data_ptr(), pos0.data_ptr(), *exps, out.data_ptr(), *ptrs,
            B, T, H, r, rope, block, max_blocks, q_code, kv_code, n_split, float(scale),
            float(kv_scale), build.current_stream(dev),
        )
        build.check(err, "paged_attention_mla")
    if kv_bits:
        mla_quant_launches += 1
    else:
        mla_launches += 1
    return out


def paged_attention_mla(q_eff, q_rope, ckv_pool, krope_pool, block_tables, pos0, *,
                        scale: float, kv_scale: float = 1.0, ckv_scale_exp=None,
                        kr_scale_exp=None, kv_bits: int = 0, out_dtype=None, _route=None,
                        _split=None):
    """Absorbed MLA decode over the paged compressed pools.

    q_eff (B, T, H, r) rank-space queries; q_rope (B, T, H, rope); pools
    (n_blocks, block, r) / (n_blocks, block, rope) float or int8 (KV_F, times
    ``kv_scale``), or SYMOG int8 words / int4 split-halves words (last dims
    r/2, rope/2) with ``ckv_scale_exp``/``kr_scale_exp`` (n_blocks,) int32
    and ``kv_bits`` 8 or 4; block_tables (B, max_blocks) int32; pos0 (B,)
    int32, query t of row b at position pos0[b] + t.  Logits are
    (q_eff·c_kv + q_rope·k_rope)·scale under the causal mask, the value is
    c_kv itself: returns the rank-space (B, T, H, r) output, which the
    caller expands with kv_b_v.  On the card ``_mla_route`` picks the
    kernel; ``_route`` ('partial' or 'tc') forces one and ``_split`` the
    tensor-core kernel's cluster size (card tests and chip_smoke.py)."""
    quant = ckv_scale_exp is not None
    if quant != (kr_scale_exp is not None) or quant != (kv_bits != 0) or kv_bits not in (0, 4, 8):
        raise ValueError("quantized pools take both exponent leaves and kv_bits 8 or 4; got "
                         f"c_kv/k_rope exponents {quant}/{kr_scale_exp is not None}, "
                         f"kv_bits {kv_bits}")
    if q_eff.is_cuda:
        out = _launch_mla(q_eff, q_rope, ckv_pool, krope_pool, block_tables, pos0, scale=scale,
                          kv_scale=kv_scale, c_exp=ckv_scale_exp, r_exp=kr_scale_exp,
                          kv_bits=kv_bits, route=_route, n_split=_split)
    else:
        out = paged_attention_mla_ref(q_eff, q_rope, ckv_pool, krope_pool, block_tables, pos0,
                                      scale=scale, kv_scale=kv_scale,
                                      ckv_scale_exp=ckv_scale_exp, kr_scale_exp=kr_scale_exp,
                                      kv_bits=kv_bits)
    return out.to(out_dtype) if out_dtype is not None else out
