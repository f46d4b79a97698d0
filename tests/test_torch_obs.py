"""Port parity, the telemetry primitives (repro_torch.obs against
repro.obs): metrics registry, step-span tracer, ring logs, profile window
and the telemetry config, host-side only.

Each case of tests/test_obs.py runs on the port's copy, and every export
of the same sequence of operations is held equal to the JAX package's:
``snapshot()``, ``to_json()``, ``to_prometheus()`` and ``render_text()``
text.  The profile window is the port's own (``torch.profiler`` in place
of ``jax.profiler``): its arc is checked against a stand-in profiler, and
once against the real one on the CPU, which must write a Chrome trace."""
import dataclasses
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import TelemetryConfig as JTelemetryConfig  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    NULL_TRACER,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    ProfileWindow,
    RingLog,
    StatsView,
    StepTracer,
    log_buckets,
    make_profile_window,
)
from repro_torch.obs import profiling  # noqa: E402
from repro_torch.serve import ServeConfig, TelemetryConfig  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs six worker processes on
    the CPU, where torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------
def test_log_buckets_cover_range_geometrically():
    b = log_buckets(1, 1000, factor=10.0)
    assert b == [1.0, 10.0, 100.0, 1000.0]
    for args in [(1, 4096), (1e-5, 32.0, 4.0), (1, 16), (0.5, 3, 1.5)]:
        assert log_buckets(*args) == jobs.log_buckets(*args)
    for bad in [(0, 8), (8, 4)]:
        with pytest.raises(ValueError):
            log_buckets(*bad)
    with pytest.raises(ValueError):
        log_buckets(1, 8, factor=1.0)


def test_counter_gauge_basics():
    c, g = Counter("c"), Gauge("g")
    c.inc()
    c.inc(4)
    assert c.value == 5
    g.set(3.5)
    g.inc(-1.0)
    assert g.value == 2.5


def test_histogram_le_semantics_and_percentiles():
    for mod in (jobs, None):
        H = Histogram if mod is None else mod.Histogram
        h = H("h", buckets=[1, 2, 4, 8])
        for v in [0.5, 1.0, 3, 5, 100]:
            h.observe(v)
        assert h.counts == [2, 0, 1, 1, 1]
        assert h.count == 5 and h.sum == pytest.approx(109.5)
        assert h.percentile(50) == 4
        assert h.percentile(100) == math.inf
    assert Histogram("e", buckets=[1, 2]).percentile(50) == 0.0
    with pytest.raises(ValueError):
        Histogram("bad", buckets=[2, 1])
    with pytest.raises(ValueError):
        Histogram("dup", buckets=[1, 1, 2])


# ---------------------------------------------------------------------------
# registry exports: equal to the JAX package's for the same operations
# ---------------------------------------------------------------------------
def _populated(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve_tokens", "tokens emitted").inc(42)
    reg.gauge("serve_live", "live slots").set(3)
    reg.gauge("serve_ewma", "a float gauge").set(0.0123)
    h = reg.histogram("serve_ttft", "steps to first token", buckets=[1, 2, 4])
    for v in [1, 1, 3, 9]:
        h.observe(v)
    h2 = reg.histogram("serve_itl", "", buckets=mod.log_buckets(1e-5, 32.0, 4.0))
    for v in [3e-4, 0.02, 0.5]:
        h2.observe(v)
    reg.counter("serve_idle")
    return reg


def _both():
    import repro_torch.obs as tobs

    return _populated(tobs), _populated(jobs)


def test_registry_create_or_return_and_kind_conflict():
    reg, _ = _both()
    assert reg.counter("serve_tokens") is reg.counter("serve_tokens")
    assert "serve_live" in reg and "nope" not in reg
    with pytest.raises(ValueError):
        reg.gauge("serve_tokens")


def test_snapshot_and_json_equal_jax():
    reg, jreg = _both()
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert list(snap) == list(jreg.snapshot())
    assert snap["serve_ttft"]["buckets"] == {"1.0": 2, "2.0": 2, "4.0": 3, "+Inf": 4}
    assert reg.to_json(label="unit", extra_field=7) == jreg.to_json(label="unit", extra_field=7)
    doc = json.loads(reg.to_json(label="unit"))
    assert doc["metrics"] == json.loads(json.dumps(snap)) and doc["label"] == "unit"


def test_prometheus_exposition_equals_jax():
    reg, jreg = _both()
    text = reg.to_prometheus()
    assert text == jreg.to_prometheus()
    assert 'serve_ttft_bucket{le="4"} 3' in text and "serve_ttft_count 4" in text
    assert text.endswith("\n")


def test_render_text_equals_jax():
    reg, jreg = _both()
    lines = reg.render_text()
    assert lines == jreg.render_text()
    assert "serve_idle" not in "\n".join(lines)
    assert any(line.startswith("serve_ttft: n=4") for line in lines)


# ---------------------------------------------------------------------------
# StatsView
# ---------------------------------------------------------------------------
def test_stats_view_is_a_thin_counter_view():
    out = []
    for reg, view in ((MetricsRegistry(), StatsView), (jobs.MetricsRegistry(), jobs.StatsView)):
        stats = view(reg, "serve_")
        stats["decode_steps"] = 0
        stats["decode_steps"] += 3
        stats["preemptions"] = 2
        assert stats["decode_steps"] == 3
        assert list(stats) == ["decode_steps", "preemptions"]
        assert stats.get("missing") is None
        with pytest.raises(KeyError):
            stats["missing"]
        reg.counter("serve_decode_steps").inc()
        assert stats["decode_steps"] == 4
        out.append((dict(stats), reg.to_prometheus()))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# rings and the tracer
# ---------------------------------------------------------------------------
def test_ringlog_slices_like_a_list_and_drops_oldest():
    log = RingLog(3)
    for i in range(5):
        log.append(i)
    assert list(log) == [2, 3, 4] and log[1:] == [3, 4] and log.dropped == 2
    with pytest.raises(ValueError):
        RingLog(0)


def test_tracer_rings_bound_and_count_drops():
    tr = StepTracer(capacity=2)
    for i in range(4):
        with tr.span("decode", step=i):
            pass
        tr.instant("evict", req=i)
    assert [s[3]["step"] for s in tr.spans] == [2, 3]
    assert [i[2]["req"] for i in tr.instants] == [2, 3]
    assert tr.dropped == 4
    with pytest.raises(ValueError):
        StepTracer(capacity=0)


def test_chrome_trace_round_trip(tmp_path):
    tr = StepTracer(capacity=16)
    with tr.span("decode", step=0, n_live=2):
        pass
    tr.instant("preempt", req=1, slot=0)
    path = tmp_path / "trace.json"
    doc = tr.export_chrome(str(path))
    loaded = json.loads(path.read_text())
    assert loaded == json.loads(json.dumps(doc)) and loaded["displayTimeUnit"] == "ms"
    events = loaded["traceEvents"]
    assert events[0]["ph"] == "M"
    span = next(e for e in events if e["ph"] == "X")
    inst = next(e for e in events if e["ph"] == "i")
    assert span["name"] == "decode" and span["args"] == {"step": 0, "n_live": 2}
    assert span["ts"] >= 0 and span["dur"] >= 0 and inst["ts"] >= span["ts"]
    assert span["tid"] != inst["tid"]
    # one track per kind, as the JAX package assigns them
    from repro.obs.tracing import TRACK_IDS as JTRACKS
    from repro_torch.obs.tracing import TRACK_IDS

    assert TRACK_IDS == JTRACKS


def test_null_tracer_records_nothing():
    assert NULL_TRACER.enabled is False
    with NULL_TRACER.span("decode", step=1) as sp:
        sp.args["late"] = True
    NULL_TRACER.instant("evict", req=0)
    assert len(NULL_TRACER) == 0 and NULL_TRACER.spans == []


# ---------------------------------------------------------------------------
# profile window (torch.profiler)
# ---------------------------------------------------------------------------
class _FakeProfile:
    calls = []

    def __init__(self, activities):
        self.activities = activities

    def start(self):
        self.calls.append(("start", tuple(a.name for a in self.activities)))

    def stop(self):
        self.calls.append(("stop", None))

    def export_chrome_trace(self, path):
        self.calls.append(("export", os.path.dirname(path)))


def test_profile_window_arc(monkeypatch, tmp_path):
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    assert make_profile_window("") is None
    d = str(tmp_path / "prof")
    win = make_profile_window(d, n_steps=2, cuda=False)
    win.on_step()
    assert _FakeProfile.calls == [("start", ("CPU",))] and win.active
    win.on_step()  # window elapses -> stop and export
    assert _FakeProfile.calls[1:] == [("stop", None), ("export", d)]
    assert win.done and not win.active and win.trace_path.startswith(d)
    win.on_step()
    win.stop()  # idempotent
    assert len(_FakeProfile.calls) == 3
    _FakeProfile.calls = []
    make_profile_window(d, n_steps=1, cuda=True).on_step()
    assert _FakeProfile.calls[0] == ("start", ("CPU", "CUDA"))


def test_profile_window_disarms_on_start_failure(monkeypatch, tmp_path):
    def boom(activities):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(torch.profiler, "profile", boom)
    win = ProfileWindow(str(tmp_path), n_steps=2)
    win.on_step()
    assert win.done and not win.active
    with pytest.raises(ValueError):
        ProfileWindow(str(tmp_path), n_steps=0)


def test_profile_window_writes_a_chrome_trace_on_the_cpu(tmp_path):
    win = profiling.ProfileWindow(str(tmp_path), n_steps=2, cuda=False)
    for _ in range(2):
        win.on_step()
        torch.ones(8) @ torch.ones(8)
    doc = json.loads(open(win.trace_path).read())
    assert any("aten::" in e.get("name", "") for e in doc["traceEvents"])


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_telemetry_config_validation():
    tele = TelemetryConfig()
    assert dataclasses.asdict(tele) == dataclasses.asdict(JTelemetryConfig())
    assert [f.name for f in dataclasses.fields(ServeConfig)] == [
        f.name for f in dataclasses.fields(JServeConfig)]
    for bad in (dict(trace_capacity=0), dict(profile_steps=0), dict(straggler_warn=1.5)):
        with pytest.raises(ValueError):
            TelemetryConfig(**bad)
        with pytest.raises(ValueError):
            JTelemetryConfig(**bad)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tele.trace = True
    with pytest.raises(ValueError):
        ServeConfig(telemetry={"trace": True})
