"""Logical cost and peak live bytes of a step, counted as it runs (the
port's counterpart of ``repro/launch/jaxpr_cost.py``).

JAX walks a jaxpr and weights a ``scan`` body by its length, because
``compiled.cost_analysis()`` counts a loop body once.  The port runs
eagerly, so a ``TorchDispatchMode`` sees every aten op as it runs: a
Python loop's trips, remat's recompute and the backward are counted as
they happen, and nothing like scan weighting is needed.  ``OpCounter``
counts, as ``jaxpr_cost`` does:

  * ``flops``     — 2 x MACs of every matmul form (``mm``, ``bmm``,
                    ``addmm`` / ``baddbmm`` / ``addbmm`` / ``addmv``
                    without the bias operand, ``mv``, ``dot``; ``linear``
                    and ``einsum`` reach these), every convolution (``_conv_cost``:
                    2 x out elements x kernel taps x in-channels a group;
                    ``convolution_backward`` as its two convolutions) and
                    every fused scaled-dot-product attention (q·kᵀ and p·v
                    as two dots, its backward as four).
  * ``dot_bytes`` — the bytes of the two operands and the output of each
                    of those (a bias not counted): the matmul traffic term.
                    Elementwise traffic is left out, as in JAX.

It works on real tensors, ``FakeTensorMode``'s and ``meta`` tensors alike
(the counts read shapes and dtypes only).  Costs are this process's: under a mesh, one rank's.

``OpCounter(device_type)`` also tracks the storages on one device type:
each op's new output storage is live until its last tensor is freed (a
weak reference's callback), sizes rounded up to the caching allocator's
512 bytes; ``peak`` is the most live at once, counting what ``add``
registered before the step (its state).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Any, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten


def _nbytes(t) -> float:
    return float(t.numel() * t.element_size()) if isinstance(t, torch.Tensor) else 0.0


def _dot(flops: float, *tensors) -> Dict[str, float]:
    return {"flops": flops, "dot_bytes": sum(_nbytes(t) for t in tensors)}


def _conv_flops(inp, w, out, transposed: bool, groups: int) -> float:
    k_spatial = math.prod(w.shape[2:])
    if transposed:  # weight (Cin, Cout/groups, *k): each input element fans out
        return 2.0 * inp.numel() * k_spatial * w.shape[1]
    return 2.0 * out.numel() * k_spatial * w.shape[1]  # w.shape[1] = Cin/groups


def _sdpa_fwd(q, k, v, out) -> Dict[str, float]:
    """q·kᵀ then p·v, the scores at q's dtype (B, H, L, S)."""
    B, H, L, E = q.shape
    S, Ev = k.shape[-2], v.shape[-1]
    scores = float(B * H * L * S) * q.element_size()
    flops = 2.0 * B * H * L * S * E + 2.0 * B * H * L * S * Ev
    return {"flops": flops,
            "dot_bytes": _nbytes(q) + _nbytes(k) + 2 * scores + _nbytes(v) + _nbytes(out)}


_SDPA = {getattr(aten, n) for n in (
    "_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_flash_attention_for_cpu",
    "_scaled_dot_product_fused_attention_overrideable") if hasattr(aten, n)}
_SDPA_BWD = {getattr(aten, n) for n in (
    "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_efficient_attention_backward",
    "_scaled_dot_product_cudnn_attention_backward",
    "_scaled_dot_product_flash_attention_for_cpu_backward",
    "_scaled_dot_product_fused_attention_overrideable_backward") if hasattr(aten, n)}


def _cost(func, args, kwargs, out) -> Dict[str, float]:
    """The matmul-like cost of one aten op (empty for any other op)."""
    p = func.overloadpacket
    if p is aten.mm:
        a, b = args[0], args[1]
        return _dot(2.0 * a.shape[0] * a.shape[1] * b.shape[1], a, b, out)
    if p is aten.bmm:
        a, b = args[0], args[1]
        return _dot(2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], a, b, out)
    if p in (aten.addmm, aten.baddbmm, aten.addbmm):
        a, b = args[1], args[2]
        batch = a.shape[0] if a.ndim == 3 else 1
        return _dot(2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1], a, b, out)
    if p is aten.mv:
        a, v = args[0], args[1]
        return _dot(2.0 * a.shape[0] * a.shape[1], a, v, out)
    if p is aten.addmv:
        a, v = args[1], args[2]
        return _dot(2.0 * a.shape[0] * a.shape[1], a, v, out)
    if p is aten.dot:
        return _dot(2.0 * args[0].numel(), args[0], args[1], out)
    if p is aten.convolution:
        inp, w = args[0], args[1]
        return _dot(_conv_flops(inp, w, out, bool(args[6]), int(args[8])), inp, w, out)
    if p is aten.convolution_backward:
        grad_out, inp, w = args[0], args[1], args[2]
        transposed, groups, mask = bool(args[6]), int(args[9]), args[10]
        flops = _conv_flops(inp, w, grad_out, transposed, groups)
        tot = {"flops": 0.0, "dot_bytes": 0.0}
        if mask[0]:  # grad_input: a convolution of grad_out with w
            _add(tot, _dot(flops, grad_out, w, out[0]))
        if mask[1]:  # grad_weight: a convolution of the input with grad_out
            _add(tot, _dot(flops, inp, grad_out, out[1]))
        return tot
    if func in _SDPA:
        return _sdpa_fwd(args[0], args[1], args[2], out[0])
    if func in _SDPA_BWD:  # dq, dk, dv and dp: twice the forward's dots
        q, k, v = args[1], args[2], args[3]
        fwd = _sdpa_fwd(q, k, v, args[4])
        return {"flops": 2.0 * fwd["flops"], "dot_bytes": 2.0 * fwd["dot_bytes"]}
    return {}


def _add(tot: Dict[str, float], inc: Dict[str, float]) -> None:
    for k, v in inc.items():
        tot[k] = tot.get(k, 0.0) + v


class OpCounter(TorchDispatchMode):
    """Counts ``flops`` and ``dot_bytes`` of every op run inside (the
    module docstring); ``totals`` holds them.  With ``device_type`` it also
    tracks live bytes (the module docstring): ``add(tree)`` registers
    tensors made before the mode was entered; ``live`` and ``peak`` are in
    bytes.  One mode does both: each Python mode on the stack costs every
    op of a trace its own dispatch."""

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        self.totals: Dict[str, float] = {"flops": 0.0, "dot_bytes": 0.0}
        self.device_type = device_type
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, Any] = {}
        # re-entrant: a free (and its callback) can happen inside a tracked op
        self._lock = threading.RLock()

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = _rounded(st.nbytes())
        if not n:
            return

        def freed(_, key=key, n=n):
            with self._lock:
                self._refs.pop(key, None)
                self.live -= n

        with self._lock:
            self._refs[key] = weakref.ref(st, freed)
            self.live += n
            self.peak = max(self.peak, self.live)

    def add(self, tree) -> None:
        for t in tensors_of(tree):
            self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inc = _cost(func, args, kwargs or {}, out)
        if inc:
            with self._lock:
                _add(self.totals, inc)
        if self.device_type is not None:
            for t in tree_flatten(out)[0]:
                self._track(t)
        return out


def op_cost(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` and return its {'flops', 'dot_bytes'}
    (real, fake or meta tensors; the trips, recompute and backward it runs)."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return dict(c.totals)


ALLOC_ROUND = 512  # the CUDA caching allocator's block granularity


def tensors_of(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor in a tree of dicts, lists, tuples (``TrainState``) and
    dataclasses (``SymogState``, ``Packed``)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors_of(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors_of(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors_of(getattr(obj, f.name))


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND if n else 0
