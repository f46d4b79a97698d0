"""Serving metrics: a registry of counters, gauges and histograms (the
port's own copy of ``repro/obs/metrics.py``; host-only, so the two
packages' exports are the same text for the same operations).

Every serving subsystem (scheduler, speculative controller, prefix cache,
block pool, launcher) reports through ONE ``MetricsRegistry`` so "why is
TTFT high right now" has a single place to look.  The registry is
host-side and synchronous — instruments are plain Python numbers touched
from the scheduler loop (which is single-threaded by design; the async
engine serializes every scheduler touch behind its lock), so recording a
sample is a dict lookup plus an add: a few microseconds of host work a
decode step.

Instruments:

  * ``Counter``   — monotone-by-convention cumulative value (``inc``).
    ``set`` exists so the scheduler's legacy ``stats`` dict can remain a
    thin assignment-style view over the registry (``StatsView``);
  * ``Gauge``     — point-in-time value (``set``): pool occupancy, live
    slots, queue depth, EWMA step time;
  * ``Histogram`` — fixed log-spaced buckets (``log_buckets``): TTFT,
    inter-token latency, queue wait, accepted-per-step.  Log spacing keeps
    the bucket count O(log range) while resolving both the sub-millisecond
    and the multi-second tail; bounds are fixed at construction so two
    snapshots are always mergeable.

Exports: ``snapshot()`` (a point-in-time plain dict), ``to_json()``, and
``to_prometheus()`` — the Prometheus text exposition format (version
0.0.4: ``# TYPE`` lines, ``_bucket{le="..."}`` cumulative histogram
series, ``_sum``/``_count``), so a scrape endpoint or a file tail can
feed standard dashboards without any adapter.
"""
from __future__ import annotations

import json
import math
from collections.abc import MutableMapping
from typing import Dict, Iterator, List, Optional, Sequence, Union

Number = Union[int, float]


def log_buckets(lo: float, hi: float, factor: float = 2.0) -> List[float]:
    """Fixed log-spaced bucket upper bounds from ``lo`` up to at least
    ``hi`` (each bound = previous × ``factor``).  The implicit +Inf bucket
    is appended by the histogram itself."""
    if lo <= 0 or hi < lo or factor <= 1.0:
        raise ValueError(f"need 0 < lo <= hi and factor > 1, got {lo}/{hi}/{factor}")
    out = [float(lo)]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return out


class Counter:
    """Cumulative value.  ``inc`` is the metric operation; ``set`` backs
    the ``StatsView`` assignment path (the scheduler's legacy stats dict)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def set(self, v: Number) -> None:
        self.value = v


class Gauge:
    """Point-in-time value."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def inc(self, n: Number = 1) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram: counts per upper bound plus sum/count.
    Buckets are cumulative in the Prometheus exposition only — internally
    each slot counts its own interval, so ``observe`` is one bisect and
    two adds."""

    __slots__ = ("name", "help", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "", buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.bounds = [float(b) for b in (buckets if buckets is not None else log_buckets(1, 1024))]
        if sorted(self.bounds) != self.bounds or len(set(self.bounds)) != len(self.bounds):
            raise ValueError(f"histogram bounds must be strictly increasing: {self.bounds}")
        self.counts = [0] * (len(self.bounds) + 1)  # + the +Inf slot
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, v: Number) -> None:
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # first bound >= v (inclusive upper bounds, le semantics)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.sum += float(v)
        self.count += 1

    def percentile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-th percentile (0..100) —
        coarse by construction (log buckets), for rendering only."""
        if not self.count:
            return 0.0
        rank = math.ceil(self.count * q / 100.0)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bounds[i] if i < len(self.bounds) else math.inf
        return math.inf


class MetricsRegistry:
    """One namespace of instruments.  ``counter``/``gauge``/``histogram``
    create-or-return by name (idempotent, so call sites never coordinate);
    a name registered as one kind cannot be re-registered as another."""

    def __init__(self):
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Point-in-time plain-dict view: counters/gauges map to their
        value, histograms to ``{"count", "sum", "buckets": {le: n}}`` with
        CUMULATIVE bucket counts (the Prometheus convention, so the two
        exports can be cross-checked against each other)."""
        out: Dict[str, object] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                cum, buckets = 0, {}
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    buckets[repr(float(b))] = cum
                buckets["+Inf"] = m.count
                out[name] = {"count": m.count, "sum": m.sum, "buckets": buckets}
            else:
                out[name] = m.value
        return out

    def to_json(self, **extra) -> str:
        """The snapshot as a JSON document (``extra`` top-level fields ride
        along — the launcher adds workload metadata)."""
        return json.dumps({"metrics": self.snapshot(), **extra}, indent=2, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every instrument."""
        lines: List[str] = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(float(b))}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"

    def render_text(self) -> List[str]:
        """Human-readable snapshot lines for the launcher: non-zero
        counters and gauges grouped on a few lines, histograms as
        count/p50/p99 estimates."""
        counters, gauges, lines = [], [], []
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                if m.count:
                    lines.append(
                        f"{name}: n={m.count} mean={m.sum / m.count:.3g} "
                        f"p50<={_fmt(m.percentile(50))} p99<={_fmt(m.percentile(99))}"
                    )
            elif m.value:
                v = m.value
                disp = f"{v:.4g}" if isinstance(v, float) and v != int(v) else _fmt(v)
                (counters if isinstance(m, Counter) else gauges).append(f"{name}={disp}")
        head = [" ".join(counters)] if counters else []
        return head + ([" ".join(gauges)] if gauges else []) + lines


def _fmt(v: Number) -> str:
    if isinstance(v, float):
        if v == math.inf:
            return "+Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


class StatsView(MutableMapping):
    """The scheduler's legacy ``stats`` dict as a THIN VIEW over registry
    counters: ``stats["decode_steps"] += 1`` reads and writes the counter
    ``<prefix>decode_steps``, so every test and launcher consumer keeps
    its dict shape while the registry becomes the one source of truth.
    Keys iterate in first-touch order, like the dict this replaces."""

    def __init__(self, registry: MetricsRegistry, prefix: str = ""):
        self._reg = registry
        self._prefix = prefix
        self._keys: List[str] = []
        self._counters: Dict[str, Counter] = {}  # hot-path cache: one dict hit per touch

    def counter(self, key: str) -> Counter:
        c = self._counters.get(key)
        if c is None:
            c = self._reg.counter(self._prefix + key)
            self._counters[key] = c
            self._keys.append(key)
        return c

    def __getitem__(self, key: str) -> Number:
        c = self._counters.get(key)
        if c is None:
            raise KeyError(key)
        return c.value

    def __setitem__(self, key: str, value: Number) -> None:
        self.counter(key).set(value)

    def __delitem__(self, key: str) -> None:
        self._keys.remove(key)
        del self._counters[key]

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._keys))

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))
