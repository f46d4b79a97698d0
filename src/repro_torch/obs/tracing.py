"""Step-span tracing: ring-buffered span records with Chrome
``trace_event`` export (the port's own copy of ``repro/obs/tracing.py``;
host-only).

The scheduler wraps each phase of a serve step (admit, chunk, decode,
verify) in a span and marks point events (preempt, evict, COW, prefix
hit, cancel) as instants.  Records live in a ``deque(maxlen=capacity)``
ring — on a long-running serve the OLDEST spans are dropped first, so
the trace is always the most recent window of ``capacity`` records and
memory is bounded regardless of uptime (same drop semantics as the
scheduler's ``events`` / ``admit_times`` logs, which share this
capacity knob).

Tracing is OFF by default: the scheduler holds ``NULL_TRACER``, whose
methods are no-ops, so the untraced hot path pays one attribute call
per phase.  ``StepTracer.export_chrome()`` emits the Chrome
``trace_event`` JSON format — complete duration events (``ph="X"``,
microsecond ``ts``/``dur``) plus instants (``ph="i"``) in a
``{"traceEvents": [...]}`` document that chrome://tracing and Perfetto
load directly; span kinds map to tids so each phase gets its own track.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# Span/instant kinds -> stable Chrome-trace track ids (tid).  One track
# per kind keeps Perfetto rows readable; unknown kinds land on track 0.
TRACK_IDS: Dict[str, int] = {
    "step": 0,
    "admit": 1,
    "chunk": 2,
    "decode": 3,
    "verify": 4,
    "cow": 5,
    "preempt": 6,
    "evict": 7,
    "prefix_hit": 8,
    "cancel": 9,
}


class RingLog(list):
    """A list whose ``append`` drops the OLDEST entry once ``capacity`` is
    reached — the bound behind ``Scheduler.events`` and
    ``Scheduler.admit_times`` (same capacity knob as the span ring, same
    drop semantics: the log is always the most recent ``capacity`` records;
    ``dropped`` counts what aged out).  A list subclass, not a deque, so
    existing consumers keep slicing (``log[1:]``) and indexing."""

    def __init__(self, capacity: int):
        super().__init__()
        if capacity < 1:
            raise ValueError(f"RingLog capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dropped = 0

    def append(self, item) -> None:
        super().append(item)
        if len(self) > self.capacity:
            del self[0]
            self.dropped += 1


class _Span:
    """Context manager handed out by ``StepTracer.span``; records on exit."""

    __slots__ = ("_tracer", "kind", "args", "_t0")

    def __init__(self, tracer: "StepTracer", kind: str, args: Dict[str, object]):
        self._tracer = tracer
        self.kind = kind
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._tracer._n_spans += 1
        self._tracer._records.append((self.kind, self._t0, t1 - self._t0, self.args))


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    # Harmless to mutate on the null path: callers may attach extra args
    # after entering the span (e.g. decode batch composition known only
    # mid-phase).
    args: Dict[str, object] = {}


_NULL_SPAN = _NullSpan()


class StepTracer:
    """Ring buffer of ``(kind, start_s, dur_s, args)`` span records and
    ``(kind, t_s, args)`` instants.  ``enabled`` is True for real tracers;
    the ``NULL_TRACER`` singleton reports False and records nothing."""

    enabled = True

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.t0 = time.perf_counter()
        self._records: Deque[Tuple[str, float, float, Dict[str, object]]] = deque(
            maxlen=capacity
        )
        self._instants: Deque[Tuple[str, float, Dict[str, object]]] = deque(maxlen=capacity)
        self._n_spans = 0  # total ever recorded (rings keep the newest window)
        self._n_instants = 0

    def span(self, kind: str, **args: object) -> _Span:
        return _Span(self, kind, args)

    def instant(self, kind: str, **args: object) -> None:
        self._n_instants += 1
        self._instants.append((kind, time.perf_counter(), args))

    def __len__(self) -> int:
        return len(self._records) + len(self._instants)

    @property
    def dropped(self) -> int:
        """Records aged out of the rings (oldest-first, RingLog semantics)."""
        return (self._n_spans - len(self._records)) + (self._n_instants - len(self._instants))

    @property
    def spans(self) -> List[Tuple[str, float, float, Dict[str, object]]]:
        return list(self._records)

    @property
    def instants(self) -> List[Tuple[str, float, Dict[str, object]]]:
        return list(self._instants)

    def export_chrome(self, path: Optional[str] = None) -> Dict[str, object]:
        """The ring contents as a Chrome ``trace_event`` document.

        Timestamps are microseconds relative to tracer construction;
        span kinds map to per-kind ``tid`` tracks under one ``pid``.
        Writes JSON to ``path`` when given; always returns the dict.
        """
        events: List[Dict[str, object]] = [
            {
                "name": "serve",
                "ph": "M",  # metadata: names the process in the viewer
                "pid": 1,
                "tid": 0,
                "args": {"name": "process_name"},
            }
        ]
        for kind, start, dur, args in self._records:
            events.append(
                {
                    "name": kind,
                    "cat": "serve",
                    "ph": "X",
                    "ts": (start - self.t0) * 1e6,
                    "dur": dur * 1e6,
                    "pid": 1,
                    "tid": TRACK_IDS.get(kind, 0),
                    "args": args,
                }
            )
        for kind, t, args in self._instants:
            events.append(
                {
                    "name": kind,
                    "cat": "serve",
                    "ph": "i",
                    "s": "t",
                    "ts": (t - self.t0) * 1e6,
                    "pid": 1,
                    "tid": TRACK_IDS.get(kind, 0),
                    "args": args,
                }
            )
        doc: Dict[str, object] = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


class _NullTracer(StepTracer):
    """No-op tracer held by un-instrumented schedulers: every record path
    short-circuits, so tracing off costs one method call per phase."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=1)

    def span(self, kind: str, **args: object) -> _NullSpan:  # type: ignore[override]
        return _NULL_SPAN

    def instant(self, kind: str, **args: object) -> None:
        pass


NULL_TRACER = _NullTracer()
