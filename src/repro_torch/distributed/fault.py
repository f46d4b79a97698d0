"""Fault tolerance runtime pieces: straggler detection + transient retry
(the port's own copy of ``repro/distributed/fault.py``; host-only).

The serve scheduler feeds every decode step's wall time to a
``StepTimeMonitor`` (its EWMA and straggler fraction become gauges);
``retry_transient`` bounds retries of transient I/O failures.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class StepTimeMonitor:
    """EWMA step-time tracker; flags steps slower than ``threshold``× EWMA.

    In a multi-host deployment each host reports its step time; hosts whose
    times are persistently flagged are straggler candidates.  Here the
    monitor is exercised per-process and unit-tested directly.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.count = 0
        self.flagged: List[Tuple[int, float]] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        """Record one step time; True if it is a straggler step."""
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = self.count > self.warmup and dt > self.threshold * self.ewma
        if is_slow:
            self.flagged.append((self.count, dt))
        else:
            # only fold non-outlier steps into the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_slow

    def straggler_fraction(self) -> float:
        return len(self.flagged) / max(self.count, 1)


def retry_transient(fn: Callable[[], T], *, retries: int = 3, backoff: float = 0.5,
                    exceptions: Tuple = (OSError, IOError)) -> T:
    """Run ``fn`` retrying transient failures with exponential backoff."""
    delay = backoff
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions:
            if attempt == retries:
                raise
            time.sleep(delay)
            delay *= 2
    raise AssertionError("unreachable")
