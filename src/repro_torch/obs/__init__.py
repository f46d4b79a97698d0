"""Serving observability of the port: metrics registry, step-span tracing
and profiler capture windows (the exports of ``repro/obs``)."""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StatsView,
    log_buckets,
)
from .profiling import ProfileWindow, make_profile_window
from .tracing import NULL_TRACER, RingLog, StepTracer

__all__ = [
    "RingLog",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StatsView",
    "log_buckets",
    "NULL_TRACER",
    "StepTracer",
    "ProfileWindow",
    "make_profile_window",
]
