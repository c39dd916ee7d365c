"""The port's observability modules beside the JAX package's: the
daemon-free cases of ``tests/test_obs.py``, ``test_obs_v2.py``,
``test_obs_v3.py`` and ``test_service.py`` that touch only ``obs/trace``,
``obs/context``, ``obs/metrics``, ``obs/introspect`` and
``service/stats``, each run over both packages (parametrised by package);
then what only the port has: the lazy ``g++`` / ``nvcc`` library builds
recorded in ``INTROSPECTOR`` in place of ``jax.jit`` compiles, and a
card-memory sampler that never creates a CUDA context.

Since the port has its daemon, the SLO-health, structured-logger, daemon
(with its ``/metrics`` scrape) and client/daemon trace-id cases of
``tests/test_obs.py`` and ``test_obs_v2.py`` run over both packages too,
as do the two cases of ``observe_jit`` in the port's form: the compile
tracker's cases drive ``record_call`` / ``record_compile`` directly, as
``observe_jit`` does (a decorator the port has no site for).

The durability and ops layer, over both packages: the flight recorder's
bounded ring and the doctor's post-mortem (``tests/test_doctor.py``, its
SIGKILLed daemons included, the telemetry one of ``test_obs_v4.py``
too), the ``/metrics``, ``/healthz``, ``/slo`` listener and the
``/dashboard`` (``test_obs.py``, ``test_obs_v2.py``, ``test_obs_v3.py``,
the port's kernel-launch family beside them; the ``dash`` frame waits for
the ``dash`` command, ROADMAP.md queue 1 item 7), the profiles CSV export,
and the telemetry store through a daemon (``test_obs_v4.py``: the
sentinel seeded at boot, the ``tsq`` op, its refusal without a store).
"""

from __future__ import annotations

import importlib
import io
import csv
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(params=PACKAGES)
def obs(request):
    p = request.param
    return SimpleNamespace(**{
        name: importlib.import_module(f"{p}.{path}")
        for name, path in (
            ("trace", "obs.trace"),
            ("context", "obs.context"),
            ("metrics", "obs.metrics"),
            ("introspect", "obs.introspect"),
            ("stats", "service.stats"),
            ("health", "obs.health"),
            ("log", "obs.log"),
            ("daemon", "service.daemon"),
            ("client", "service.client"),
            ("flight", "obs.flight"),
            ("httpd", "obs.httpd"),
            ("dashboard", "obs.dashboard"),
            ("tsdb", "obs.tsdb"),
            ("cli", "cli"),
        )
    })


# -- tracer (test_obs.py, test_obs_v2.py) --------------------------------------


def test_tracer_spans_nest_and_export_is_trace_event_json(obs):
    t = obs.trace.Tracer()
    with t.span("outer", tid=7, args={"k": "v"}):
        with t.span("inner", tid=7):
            pass
    out = t.export()
    json.loads(json.dumps(out))
    evs = {e["name"]: e for e in out["traceEvents"]}
    outer, inner = evs["outer"], evs["inner"]
    for e in (outer, inner):
        assert e["ph"] == "X"
        assert e["tid"] == 7
        assert e["dur"] >= 0
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["args"] == {"k": "v"}


def test_tracer_ring_is_bounded_and_counts_drops(obs):
    t = obs.trace.Tracer(capacity=4)
    for i in range(10):
        t0 = t.now()
        t.add_span(f"s{i}", t0, t.now())
    out = t.export()
    assert len(out["traceEvents"]) == 4
    assert [e["name"] for e in out["traceEvents"]] == ["s6", "s7", "s8", "s9"]
    assert out["otherData"]["spans_dropped"] == 6


def test_tracer_track_names_emit_metadata_once(obs):
    t = obs.trace.Tracer()
    t.name_track(3, "job 3")
    t.name_track(3, "job 3")
    meta = [e for e in t.export()["traceEvents"] if e["ph"] == "M"]
    assert len(meta) == 1
    assert meta[0]["name"] == "thread_name"
    assert meta[0]["args"]["name"] == "job 3"


def test_null_tracer_is_disabled_and_free(obs):
    null = obs.trace.NULL_TRACER
    assert not null.enabled
    with null.span("x"):
        pass
    assert len(null) == 0


def test_merge_child_rebases_onto_parent_clock(obs):
    Tracer = obs.trace.Tracer
    parent = Tracer()
    t0 = parent.now()
    child = Tracer()
    c0 = child.now()
    child.add_span("child_work", c0, c0 + 0.010)
    t1 = parent.now() + 0.050
    n = parent.merge_child(
        child.export()["traceEvents"],
        child_wall_base=child.wall_base,
        tid=9,
        clamp=(t0, t1),
        extra_args={"origin": "child"},
    )
    assert n == 1
    e = [e for e in parent.export()["traceEvents"] if e["name"] == "child_work"][0]
    assert e["tid"] == 9 and e["dur"] >= 0
    assert parent.us(t0) - 1 <= e["ts"]
    assert e["ts"] + e["dur"] <= parent.us(t1) + 1
    skewed = Tracer()
    s0 = skewed.now()
    skewed.add_span("skewed", s0, s0 + 0.010)
    parent.merge_child(
        skewed.export()["traceEvents"],
        child_wall_base=skewed.wall_base + 3600.0,
        tid=9,
        clamp=(t0, t1),
    )
    got = [e for e in parent.export()["traceEvents"] if e["name"] == "skewed"]
    assert got[0]["dur"] >= 0
    assert got[0]["ts"] + got[0]["dur"] <= parent.us(t1) + 1
    assert got[0]["args"]["clamped"] is True


def test_drop_hook_fires_and_export_carries_warning(obs):
    t = obs.trace.Tracer(capacity=2)
    seen = []
    t.drop_hook = seen.append
    for i in range(5):
        n = t.now()
        t.add_span(f"s{i}", n, n)
    assert seen == [1, 2, 3]
    out = t.export()
    assert out["otherData"]["spans_dropped"] == 3
    assert "saturated" in out["otherData"]["warning"]
    assert "wall_base" in out["otherData"]


def test_span_hook_sees_every_completed_span(obs):
    t = obs.trace.Tracer()
    seen = []
    t.span_hook = seen.append
    with t.span("a", tid=1):
        pass
    assert [e["name"] for e in seen] == ["a"]
    t.span_hook = lambda ev: 1 / 0
    with t.span("b", tid=1):
        pass
    assert len(t) == 2


# -- trace context (test_obs_v2.py) --------------------------------------------


def test_trace_ids_are_w3c_shaped_and_unique(obs):
    c = obs.context
    a, b = c.new_trace_id(), c.new_trace_id()
    assert a != b
    for tid in (a, b):
        assert c.valid_trace_id(tid)
        assert len(tid) == 32
    assert not c.valid_trace_id("0" * 32)
    assert not c.valid_trace_id("Z" * 32)
    assert not c.valid_trace_id(None)
    assert not c.valid_trace_id(123)


def test_trace_frame_round_trips_and_malformed_is_absent(obs):
    c = obs.context
    tid = c.new_trace_id()
    got_tid, got_wall = c.parse_trace_frame(c.trace_frame(tid))
    assert got_tid == tid
    assert isinstance(got_wall, float)
    assert c.parse_trace_frame(None) == (None, None)
    assert c.parse_trace_frame("nope") == (None, None)
    assert c.parse_trace_frame({"trace_id": "short"}) == (None, None)
    assert c.parse_trace_frame({"trace_id": tid, "sent_wall": "x"}) == (tid, None)
    assert c.TRACE_FIELD == "trace" and c.ENV_TRACE == "S2VTPU_TRACE"


def test_rebase_shifts_clamps_and_never_goes_negative(obs):
    spans = [
        {"name": "inside", "ph": "X", "ts": 100.0, "dur": 50.0},
        {"name": "drifted", "ph": "X", "ts": 900.0, "dur": 500.0},
        {"name": "meta", "ph": "M", "ts": 0},
    ]
    out = obs.context.rebase_spans(
        spans, offset_us=1000.0, tid=7, pid=42, clamp_us=(1000.0, 2000.0),
        extra_args={"origin": "child"},
    )
    assert [e["name"] for e in out] == ["inside", "drifted"]
    inside, drifted = out
    assert inside["ts"] == 1100.0 and inside["dur"] == 50.0
    assert "clamped" not in inside["args"]
    assert drifted["ts"] + drifted["dur"] <= 2000.0
    assert drifted["dur"] >= 0
    assert drifted["args"]["clamped"] is True
    for e in out:
        assert e["tid"] == 7 and e["pid"] == 42
        assert e["args"]["origin"] == "child"


# -- metrics registry (test_obs.py, test_obs_v3.py) ------------------------------


def test_counter_and_gauge_render_prometheus_text(obs):
    r = obs.metrics.MetricsRegistry()
    c = r.counter("jobs_total", "All jobs", labelnames=("verdict",))
    c.inc(verdict="ok")
    c.inc(2, verdict="illegal")
    g = r.gauge("active", "Active jobs")
    g.set(3)
    g.dec()
    text = r.render()
    assert "# TYPE jobs_total counter" in text
    assert 'jobs_total{verdict="ok"} 1' in text
    assert 'jobs_total{verdict="illegal"} 2' in text
    assert "# TYPE active gauge" in text
    assert "active 2" in text
    assert text.endswith("\n")
    with pytest.raises(ValueError):
        c.inc(-1, verdict="ok")
    with pytest.raises(ValueError):
        r.gauge("jobs_total", "kind clash")


def test_histogram_bucket_boundaries_are_inclusive_le(obs):
    r = obs.metrics.MetricsRegistry()
    h = r.histogram("lat", "Latency", buckets=(0.1, 1.0, 10.0))
    h.observe(0.1)
    h.observe(1.0)
    h.observe(10.0000001)
    cum, total, count = h.counts()
    assert cum == [1, 2, 2, 3]
    assert count == 3
    assert total == pytest.approx(11.1000001)
    text = r.render()
    assert 'lat_bucket{le="0.1"} 1' in text
    assert 'lat_bucket{le="1"} 2' in text
    assert 'lat_bucket{le="10"} 2' in text
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_count 3" in text


def test_histogram_labels_and_latency_defaults(obs):
    r = obs.metrics.MetricsRegistry()
    h = r.histogram("wall", "Wall", buckets=obs.metrics.LATENCY_BUCKETS, labelnames=("backend",))
    h.observe(0.002, backend="native")
    h.observe(50.0, backend="device")
    text = r.render()
    assert 'wall_bucket{backend="native",le="0.0025"} 1' in text
    assert 'wall_bucket{backend="device",le="+Inf"} 1' in text
    assert r.snapshot()["histograms"]['wall{backend="native"}']["count"] == 1


def test_label_values_are_escaped(obs):
    r = obs.metrics.MetricsRegistry()
    r.counter("x_total", "X", labelnames=("path",)).inc(path='a"b\\c\nd')
    assert 'path="a\\"b\\\\c\\nd"' in r.render()


def test_openmetrics_exemplars_render_and_classic_text_stays_clean(obs):
    reg = obs.metrics.MetricsRegistry()
    hist = reg.histogram("demo_seconds", buckets=(0.1, 1.0), labelnames=("backend",))
    tid = "deadbeef" * 4
    hist.observe(0.05, exemplar=tid, backend="native")
    hist.observe(0.5, backend="native")
    om = reg.render_openmetrics()
    assert om.rstrip().endswith("# EOF")
    ex_lines = [line for line in om.splitlines() if "# {" in line]
    assert len(ex_lines) == 1
    assert 'le="0.1"' in ex_lines[0]
    assert '# {trace_id="%s"} 0.05' % tid in ex_lines[0]
    reg.counter("demo_jobs_total").inc()
    om = reg.render_openmetrics()
    assert "# TYPE demo_jobs counter" in om
    assert "demo_jobs_total 1" in om
    classic = reg.render()
    assert "# {" not in classic
    assert "# EOF" not in classic
    assert "# TYPE demo_jobs_total counter" in classic
    assert obs.metrics.OPENMETRICS_CONTENT_TYPE.startswith("application/openmetrics-text")


def test_histogram_observe_without_exemplar_keeps_counts_consistent(obs):
    reg = obs.metrics.MetricsRegistry()
    hist = reg.histogram("h_seconds", buckets=(1.0,))
    hist.observe(0.5)
    hist.observe(2.0, exemplar="ab" * 16)
    cum, total, count = hist.counts()
    assert count == 2 and total == 2.5 and cum == [1, 2]
    snap = reg.snapshot()["histograms"]["h_seconds"]
    assert snap["count"] == 2
    assert snap["exemplars"]["+Inf"]["trace_id"] == "ab" * 16


def test_registry_render_is_safe_against_concurrent_registration(obs):
    reg = obs.metrics.MetricsRegistry()
    stop = threading.Event()
    errors = []

    def churn():
        i = 0
        while not stop.is_set():
            try:
                reg.counter("churn_%d_total" % (i % 50)).inc()
                reg.gauge("churn_g_%d" % (i % 50)).set(i)
            except Exception as e:  # pragma: no cover - the failure mode
                errors.append(e)
                return
            i += 1

    threads = [threading.Thread(target=churn) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(200):
            assert isinstance(reg.render(), str)
            reg.render_openmetrics()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors


# -- ServiceStats: sink resilience, metric hooks, retry hint ----------------------


class _FlakySink(io.StringIO):
    """Raises OSError on the first N write attempts, then behaves."""

    def __init__(self, failures: int):
        super().__init__()
        self.failures = failures
        self.attempts = 0

    def write(self, s: str) -> int:
        self.attempts += 1
        if self.attempts <= self.failures:
            raise OSError("transient")
        return super().write(s)


def test_stats_sink_survives_one_transient_oserror(obs):
    sink = _FlakySink(failures=1)
    s = obs.stats.ServiceStats(sink)
    s.emit("admit", job=1)
    assert '"ev":"admit"' in sink.getvalue()
    assert s.snapshot()["stats_sink_lost"] == 0
    s.emit("admit", job=2)
    assert sink.getvalue().count('"ev":"admit"') == 2


def test_stats_sink_dropped_after_two_failures_with_counter(obs):
    sink = _FlakySink(failures=100)
    s = obs.stats.ServiceStats(sink)
    s.emit("admit", job=1)
    assert s.snapshot()["stats_sink_lost"] == 1
    assert sink.attempts == 2
    s.emit("admit", job=2)
    assert sink.attempts == 2
    assert s.snapshot()["admitted"] == 2
    assert "verifyd_stats_sink_lost_total 1" in s.registry.render()


def test_stats_closed_sink_drops_without_retry(obs):
    sink = io.StringIO()
    sink.close()
    s = obs.stats.ServiceStats(sink)
    s.emit("admit", job=1)
    assert s.snapshot()["stats_sink_lost"] == 1


def test_cache_loaded_counter_accumulates(obs):
    s = obs.stats.ServiceStats(None)
    s.emit("cache_loaded", entries=4)
    s.emit("cache_loaded", entries=3)
    assert s.snapshot()["cache_loaded"] == 7
    assert "verifyd_cache_loaded_total 7" in s.registry.render()


def test_stats_events_drive_metrics_registry(obs):
    s = obs.stats.ServiceStats(None)
    s.emit("admit", job=1)
    s.emit("start", job=1, queue_wait_s=0.004)
    s.emit("done", job=1, wall_s=0.5, verdict=0, backend="native")
    s.emit("admit", job=2)
    s.emit("start", job=2)
    s.emit("job_error", job=2, reason="boom")
    text = s.registry.render()
    assert "verifyd_jobs_submitted_total 2" in text
    assert 'verifyd_jobs_completed_total{verdict="ok"} 1' in text
    assert 'verifyd_wall_seconds_bucket{backend="native",le="0.5"} 1' in text
    assert "verifyd_job_errors_total 1" in text
    assert "verifyd_active_jobs 0" in text
    snap = s.snapshot()
    assert snap["active"] == 0
    assert snap["metrics"]["counters"]["verifyd_jobs_submitted_total"] == 2


def test_stats_done_event_feeds_the_shard_families(obs):
    # A mesh child's stats.shards ride a done event into the per-shard
    # families (the parent's view of a sharded supervised search).
    s = obs.stats.ServiceStats(None)
    shards = [
        {"shard": 0, "device": "cuda:0", "peak_occupancy": 131072, "occupancy_sum": 200000,
         "segments": 3, "collective_wall_s": 0.004, "skew": 1.28},
        {"shard": 1, "device": "cuda:1", "peak_occupancy": 17755, "occupancy_sum": 20000,
         "segments": 3, "collective_wall_s": 0.004, "skew": 0.17},
    ]
    s.emit("done", job=1, wall_s=0.3, verdict=0, backend="device-mesh[2]", shards=shards)
    text = s.registry.render()
    assert 'verifyd_shard_frontier_occupancy{shard="0"} 131072' in text
    assert 'verifyd_shard_frontier_occupancy{shard="1"} 17755' in text
    assert 'verifyd_shard_skew{shard="1"} 0.17' in text
    assert 'verifyd_shard_collective_seconds_count{shard="0"} 1' in text
    assert 'verifyd_wall_seconds_count{backend="device-mesh"} 1' in text


def test_stats_retry_hint_is_clamped(obs):
    s = obs.stats.ServiceStats(None)
    assert s.retry_after_hint(0) == 0.5
    assert s.retry_after_hint(4) == 4.0
    s.emit("done", wall_s=20.0, verdict=0)
    assert s.retry_after_hint(100) == 30.0


def test_stats_retry_hint_counts_in_flight_jobs(obs):
    s = obs.stats.ServiceStats(None)
    s.emit("done", wall_s=2.0, verdict=0)
    assert s.retry_after_hint(1) == 2.0
    s.emit("start", job=1)
    s.emit("start", job=2)
    assert s.retry_after_hint(1) == 6.0
    s.emit("done", job=1, wall_s=2.0, verdict=0)
    assert s.retry_after_hint(1) == 4.0


def test_stats_retry_hint_folds_in_the_lease_backlog(obs):
    # Jobs parked on the device pool drain no faster than leases turn
    # over: waiters x EWMA lease hold joins the hint.
    s = obs.stats.ServiceStats(None)
    s.emit("lease_release", held_s=2.0, in_use=0)

    class Pool:
        def snapshot(self):
            return {"waiters": 3}

    assert s.retry_after_hint(0) == 0.5
    s.device_pool = Pool()
    assert s.retry_after_hint(0) == 6.0


# -- the compile / build tracker (test_obs_v3.py) ---------------------------------


def _site_call(tracker, sig, site="fake_site", wall_s=0.001):
    """What a tracked site does per call: a miss is a compile (or build)."""
    if not tracker.record_call(site, sig):
        tracker.record_compile(site, sig, wall_s)


def test_compile_tracker_counts_compiles_hits_and_retraces(obs):
    tr = obs.introspect.JitIntrospector()
    with obs.introspect.job_context(shape="64x5x8"):
        for sig in ("a", "a", "a", "b"):
            _site_call(tr, sig)
    snap = tr.snapshot()
    assert snap["compiles"] == {"fake_site\t64x5x8": 2}
    assert snap["retraces"] == {"fake_site\t64x5x8": 1}
    assert snap["hits"] == {"64x5x8": 2}
    assert snap["misses"] == {"64x5x8": 2}
    assert snap["signatures"] == {"fake_site": 2}
    assert snap["compile_wall_s"]["fake_site"] == pytest.approx(0.002)


def test_retrace_storm_is_latched_and_reaches_the_event_stream(obs):
    stats = obs.stats.ServiceStats(None)
    tr = obs.introspect.JitIntrospector()
    tr.attach(registry=stats.registry, stats=stats, storm_threshold=2)
    with obs.introspect.job_context(shape="stormy"):
        for n in (2, 3, 4, 5):
            _site_call(tr, f"sig{n}")
    assert tr.snapshot()["storms"] == [{"site": "fake_site", "shape": "stormy", "compiles": 3}]
    assert stats.snapshot()["retrace_storms"] == 1
    rendered = stats.registry.render()
    assert "verifyd_retrace_storms_total 1" in rendered
    assert 'verifyd_jit_retraces_total{site="fake_site",shape="stormy"} 3' in rendered


def test_fold_merges_child_snapshot_and_retrips_the_storm(obs):
    stats = obs.stats.ServiceStats(None)
    parent = obs.introspect.JitIntrospector()
    parent.attach(registry=stats.registry, stats=stats, storm_threshold=2)
    child = obs.introspect.JitIntrospector()
    with obs.introspect.job_context(shape="64x5x8"):
        for n in (2, 3, 4):
            _site_call(child, f"sig{n}", site="regrow")
    harvest = child.snapshot_and_reset()
    assert child.snapshot()["compiles"] == {}
    parent.fold(harvest)
    assert parent.snapshot()["compiles"] == {"regrow\t64x5x8": 3}
    assert parent.snapshot()["hits"] == {}
    assert stats.snapshot()["retrace_storms"] == 1
    parent.fold(harvest)
    assert parent.snapshot()["compiles"] == {"regrow\t64x5x8": 6}
    assert stats.snapshot()["retrace_storms"] == 1


def test_attach_replays_accumulated_counts_into_a_fresh_registry(obs):
    tr = obs.introspect.JitIntrospector()
    with obs.introspect.job_context(shape="pre"):
        _site_call(tr, "a")
        _site_call(tr, "a")
    reg = obs.metrics.MetricsRegistry()
    tr.attach(registry=reg)
    text = reg.render()
    assert 'verifyd_jit_compiles_total{site="fake_site",shape="pre"} 1' in text
    assert 'verifyd_jit_cache_hits_total{shape="pre"} 1' in text


def test_resource_sampler_ring_is_bounded_and_updates_gauges(obs):
    reg = obs.metrics.MetricsRegistry()
    s = obs.introspect.ResourceSampler(reg, interval_s=60.0, capacity=3)
    for _ in range(7):
        sample = s.sample_once()
    assert sample["rss_bytes"] > 0
    assert sample["threads"] >= 1
    assert sample["cpu_s"] >= 0.0
    assert len(s.ring()) == 3
    snap = s.snapshot()
    assert snap["samples"] == 7 and snap["retained"] == 3
    assert snap["last"]["rss_bytes"] == sample["rss_bytes"]
    text = reg.render()
    assert "verifyd_resource_rss_bytes %d" % sample["rss_bytes"] in text
    assert "verifyd_resource_threads" in text


def test_resource_sampler_thread_starts_and_stops(obs):
    s = obs.introspect.ResourceSampler(None, interval_s=0.05, capacity=8).start()
    try:
        assert s.snapshot()["samples"] >= 1
    finally:
        s.close()
    assert s._thread is None


# -- the SLO health engine (test_obs_v2.py) ------------------------------------


def _event(name, t, wall_s=0.1, **kw):
    return {"ev": name, "t": t, "wall_s": wall_s, "queue_wait_s": 0.0, **kw}


def test_slo_window_math_with_injected_clock(obs):
    now = [10_000.0]
    h = obs.health.SLOHealth(time_fn=lambda: now[0])
    # 20 good in the last minute; 10 bad 3 minutes ago (outside 1m,
    # inside 5m and 30m).
    for i in range(20):
        h.observe_event(_event("done", 10_000 - 30 + i, wall_s=0.2))
    for i in range(10):
        h.observe_event(_event("job_error", 10_000 - 180 + i))
    snap = h.snapshot()
    w1, w5 = snap["windows"]["1m"], snap["windows"]["5m"]
    assert w1["good"] == 20 and w1["bad"] == 0
    assert w1["availability"] == 1.0 and w1["burn_rate"] == 0.0
    assert w5["good"] == 20 and w5["bad"] == 10
    assert w5["availability"] == pytest.approx(20 / 30, abs=1e-6)
    # burn = error_rate / (1 - target) = (1/3) / 0.01
    assert w5["burn_rate"] == pytest.approx((10 / 30) / 0.01, abs=0.01)
    # Latency quantiles come from the fixed buckets; all goods took 0.2s,
    # so p95 lands in the bucket containing 0.2.
    assert 0.0 < w1["latency"]["p95"] <= 1.0
    # Fast burn (1m) is clean, but the 3-minute-old errors still burn the
    # 30m window at 33× — the slow-burn alert is exactly what catches a
    # burst that has aged out of the short window.
    assert not snap["healthy"]
    assert [r["kind"] for r in snap["reasons"]] == ["slow_burn"]
    assert snap["windows"]["30m"]["burn_rate"] == pytest.approx(
        (10 / 30) / 0.01, abs=0.01
    )


def test_slo_fast_burn_trips_only_past_min_events(obs):
    now = [5_000.0]
    h = obs.health.SLOHealth(time_fn=lambda: now[0])
    # 5 errors: under min_events → cold-start guard holds, still healthy.
    for i in range(5):
        h.observe_event(_event("job_error", 5_000 - 10 + i))
    assert h.snapshot()["healthy"]
    assert h.check_breach() is None
    # 10th error crosses the guard: burn 100 ≥ 14.4 → degraded.
    for i in range(5):
        h.observe_event(_event("job_error", 5_000 - 5 + i))
    snap = h.snapshot()
    assert not snap["healthy"]
    kinds = {r["kind"] for r in snap["reasons"]}
    assert "fast_burn" in kinds


def test_breach_is_edge_triggered_and_rearms_on_recovery(obs):
    now = [7_000.0]
    h = obs.health.SLOHealth(time_fn=lambda: now[0])
    for i in range(12):
        h.observe_event(_event("job_error", 7_000 - 12 + i))
    first = h.check_breach()
    assert first is not None and first["reasons"]
    assert h.check_breach() is None  # still breached: no re-fire
    # Recovery: the bad minute ages out of every window.
    now[0] += 2_000.0
    for i in range(12):
        h.observe_event(_event("done", now[0] - 12 + i))
    assert h.check_breach() is None  # healthy again: re-armed, no fire
    # A second burst fires a second edge.
    now[0] += 2_000.0
    for i in range(12):
        h.observe_event(_event("job_error", now[0] - 12 + i))
    assert h.check_breach() is not None
    assert h.snapshot()["breaches"] == 2


def test_latency_degradation_is_a_healthz_reason_not_a_breach(obs):
    now = [9_000.0]
    h = obs.health.SLOHealth(
        obs.health.SLOConfig(latency_target_s=0.5), time_fn=lambda: now[0]
    )
    for i in range(15):
        h.observe_event(_event("done", 9_000 - 15 + i, wall_s=30.0))
    healthy, body = h.healthz()
    assert not healthy and body["status"] == "degraded"
    assert any(r["kind"] == "latency" for r in body["reasons"])
    # Latency alone never fires the burn-rate breach event.
    assert h.check_breach() is None


def test_stats_emits_slo_breach_event_once_per_edge(tmp_path, obs):
    sink = io.StringIO()
    reg = obs.metrics.MetricsRegistry()
    health = obs.health.SLOHealth(registry=reg)
    stats = obs.stats.ServiceStats(sink, registry=reg, health=health)
    for i in range(12):
        stats.emit("job_error", job=i, reason="boom")
    lines = [json.loads(l) for l in sink.getvalue().splitlines()]
    breaches = [l for l in lines if l["ev"] == "slo_breach"]
    assert len(breaches) == 1
    assert breaches[0]["reasons"]
    assert stats.snapshot()["slo_breaches"] == 1
    assert not stats.snapshot()["slo"]["healthy"]
    # More errors while already breached: no second event.
    for i in range(5):
        stats.emit("job_error", job=100 + i, reason="boom")
    lines = [json.loads(l) for l in sink.getvalue().splitlines()]
    assert len([l for l in lines if l["ev"] == "slo_breach"]) == 1


# -- the structured logger (test_obs_v2.py) -----------------------------------


def test_logger_json_lines_carry_bound_and_call_fields(obs):
    buf = io.StringIO()
    log = obs.log.StructuredLogger(buf, fmt="json", component="verifyd")
    log.info("hello", trace_id="abc", job_id=7)
    rec = json.loads(buf.getvalue())
    assert rec["msg"] == "hello" and rec["level"] == "info"
    assert rec["component"] == "verifyd"
    assert rec["trace_id"] == "abc" and rec["job_id"] == 7
    assert "t" in rec


def test_logger_text_format_and_level_filter(obs):
    buf = io.StringIO()
    log = obs.log.StructuredLogger(buf, fmt="text", level="warning")
    log.debug("nope")
    log.info("nope")
    log.warning("careful", job_id=3)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    assert "WARNING" in lines[0] and "careful" in lines[0]
    assert "job_id=3" in lines[0]


def test_logger_bind_derives_correlated_child(obs):
    buf = io.StringIO()
    log = obs.log.StructuredLogger(buf, fmt="json")
    child = log.bind(trace_id="tid1")
    child.info("from-child")
    log.info("from-parent")
    recs = [json.loads(l) for l in buf.getvalue().splitlines()]
    assert recs[0]["trace_id"] == "tid1"
    assert "trace_id" not in recs[1]


def test_logger_survives_unserializable_fields_and_dead_streams(obs):
    buf = io.StringIO()
    log = obs.log.StructuredLogger(buf, fmt="json")
    log.info("weird", obj=object())  # default=str handles it
    rec = json.loads(buf.getvalue())
    assert rec["msg"] == "weird"
    closed = io.StringIO()
    closed.close()
    obs.log.StructuredLogger(closed, fmt="text").info("lost")  # must not raise
    assert obs.log.StructuredLogger(buf, fmt="text").fmt == "text"
    with pytest.raises(ValueError):
        obs.log.StructuredLogger(buf, fmt="yaml")


# -- the daemon's trace surface and trace ids (test_obs.py, test_obs_v2.py) ------


def _good() -> str:
    from test_torch_service import _h_text
    from helpers import H, fold

    h = H()
    h.append_ok(1, [111], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([111]))
    return _h_text(h)


def test_daemon_metrics_trace_and_profile_surface(tmp_path, obs):
    cfg = obs.daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"),
        out_dir=str(tmp_path / "viz"),
        no_viz=True,
        stats_log=None,
        device="off",
        metrics_port=0,
        profile=True,
    )
    with obs.daemon.Verifyd(cfg) as daemon:
        client = obs.client.VerifydClient(cfg.socket_path)
        rep = client.submit(_good(), client="obs-test")
        assert rep["verdict"] == 0
        # Per-job profile rides the reply and names the search shape.
        prof = rep["profile"]
        assert prof["steps"] >= 0
        assert "timeline" in prof or "phases" in prof

        # stats op: merged metrics section + advertised port.
        snap = client.stats()
        assert snap["metrics_port"] == daemon.metrics_port
        assert snap["metrics"]["counters"]["verifyd_jobs_submitted_total"] == 1

        # /metrics scrape agrees with the stats op.
        url = f"http://127.0.0.1:{daemon.metrics_port}/metrics"
        body = urllib.request.urlopen(url, timeout=5).read().decode()
        assert 'verifyd_jobs_completed_total{verdict="ok"} 1' in body
        assert "verifyd_queue_wait_seconds_bucket" in body
        assert 'verifyd_wall_seconds_bucket{backend="' in body

        # trace op: nested admit→prepare on the job track; search present.
        trace = client.trace()
        spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        names = {e["name"] for e in spans}
        assert {"admit", "prepare", "queue_wait", "search"} <= names
        admit = next(e for e in spans if e["name"] == "admit")
        prep = next(e for e in spans if e["name"] == "prepare")
        assert admit["tid"] == prep["tid"]
        assert admit["ts"] <= prep["ts"]
        assert prep["ts"] + prep["dur"] <= admit["ts"] + admit["dur"] + 1e-3
        json.dumps(trace)  # Perfetto-loadable = valid JSON end to end


def test_daemon_trace_disabled_with_zero_capacity(tmp_path, obs):
    cfg = obs.daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"),
        out_dir=str(tmp_path / "viz"),
        no_viz=True,
        stats_log=None,
        device="off",
        trace_capacity=0,
    )
    with obs.daemon.Verifyd(cfg):
        client = obs.client.VerifydClient(cfg.socket_path)
        client.submit(_good(), client="obs-test")
        trace = client.trace()
        assert trace["traceEvents"] == []


def test_old_client_against_new_daemon_gets_a_minted_trace_id(tmp_path, obs):
    """An old client never sends the trace field; the daemon mints an id
    (every job has exactly one) and the reply still decodes fine."""
    cfg = obs.daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"),
        out_dir=str(tmp_path / "viz"),
        no_viz=True,
        stats_log=None,
        device="off",
    )
    with obs.daemon.Verifyd(cfg) as daemon:
        client = obs.client.VerifydClient(cfg.socket_path)
        # Simulate the old wire format: strip the trace field client-side.
        real_call = client._call

        def old_call(req, timeout=None):
            req = {k: v for k, v in req.items() if k != obs.context.TRACE_FIELD}
            return real_call(req, timeout=timeout)

        client._call = old_call
        rep = client.submit(_good(), client="old")
        assert rep["verdict"] == 0
        # Daemon-minted id in the reply; the new-client setdefault did not
        # clobber it (the daemon's word wins when present).
        assert obs.context.valid_trace_id(rep["trace_id"])
        spans = [
            e for e in client.trace()["traceEvents"] if e["ph"] == "X"
        ]
        tids = {
            (e.get("args") or {}).get("trace_id")
            for e in spans
            if (e.get("args") or {}).get("trace_id")
        }
        assert rep["trace_id"] in tids


def test_new_client_against_old_daemon_fills_trace_id_client_side(tmp_path, obs):
    """An old daemon echoes no trace_id; the client back-fills its own so
    callers can correlate unconditionally."""
    client = obs.client.VerifydClient(str(tmp_path / "nowhere.sock"))
    sent = {}

    def old_daemon_call(req, timeout=None):
        sent.update(req)
        return {"verdict": 0, "outcome": "ok"}  # pre-trace reply shape

    client._call = old_daemon_call
    rep = client.submit(_good(), client="new")
    # The new client DID send the optional field (old daemons ignore it)…
    tid_sent, wall_sent = obs.context.parse_trace_frame(sent[obs.context.TRACE_FIELD])
    assert obs.context.valid_trace_id(tid_sent) and wall_sent is not None
    # …and back-fills the reply with the id it minted.
    assert rep["trace_id"] == tid_sent


def test_submit_with_retry_keeps_one_trace_id_across_attempts(tmp_path, obs):
    client = obs.client.VerifydClient(str(tmp_path / "nowhere.sock"))
    seen = []

    attempts = {"n": 0}

    def flaky_call(req, timeout=None):
        seen.append(obs.context.parse_trace_frame(req[obs.context.TRACE_FIELD])[0])
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise obs.client.VerifydRefused("ConnectionLost", "flaky")
        return {"verdict": 0}

    client._call = flaky_call
    rep = client.submit_with_retry(_good(), retries=3, backoff_s=0.0)
    assert rep["verdict"] == 0
    assert len(seen) == 3 and len(set(seen)) == 1  # one logical request
    assert rep["trace_id"] == seen[0]


# -- what only the port has: builds in place of jit compiles ------------------------


def test_native_build_lands_in_the_introspector(tmp_path, monkeypatch):
    """A cold ``g++`` build of ``csrc/s2check.cpp`` is one recorded compile
    at site ``g++:s2check.cpp`` under the job context's shape, keyed by the
    source hash that names the library; a build span lands on the context
    tracer; loading the built library again records nothing."""
    from s2_verification_tpu_torch.checker import native
    from s2_verification_tpu_torch.obs import introspect
    from s2_verification_tpu_torch.obs.trace import Tracer

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(introspect, "INTROSPECTOR", introspect.JitIntrospector())
    tracer = Tracer(16)
    with introspect.job_context(job=4, shape="16x2x2", tracer=tracer):
        so, seconds = native._compile()
        again = native._compile()
    assert seconds > 0 and again == (so, 0.0)
    tag = so.stem.split("-")[-1]
    snap = introspect.INTROSPECTOR.snapshot()
    assert snap["compiles"] == {"g++:s2check.cpp\t16x2x2": 1}
    assert snap["signatures"] == {"g++:s2check.cpp": 1}
    assert snap["compile_wall_s"]["g++:s2check.cpp"] == pytest.approx(seconds, abs=1e-6)
    spans = [e for e in tracer.export()["traceEvents"] if e.get("name") == "build"]
    assert len(spans) == 1 and spans[0]["tid"] == 4
    assert spans[0]["args"]["site"] == "g++:s2check.cpp" and spans[0]["args"]["sig"] == tag
    harvest = introspect.INTROSPECTOR.snapshot_and_reset()
    assert introspect.INTROSPECTOR.snapshot()["compiles"] == {}
    assert harvest["compiles"] == snap["compiles"]


def test_device_memory_never_creates_a_cuda_context():
    """The sampler reads card memory only where ``torch`` is imported and
    CUDA already initialised; importing the port's obs package (and
    sampling) leaves ``torch`` unimported."""
    code = (
        "import sys\n"
        "from s2_verification_tpu_torch.obs import introspect\n"
        "assert introspect._device_memory() == {}\n"
        "introspect.ResourceSampler(None).sample_once()\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "import torch\n"
        "assert introspect._device_memory() == {}\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- flight recorder, doctor, httpd, dashboard, tsq (test_doctor.py,
# -- test_obs.py, test_obs_v2.py, test_obs_v3.py, test_obs_v4.py) ------------


def test_flight_ring_is_bounded_and_replayable(tmp_path, obs):
    rec = obs.flight.FlightRecorder(
        os.path.join(str(tmp_path), obs.flight.FLIGHT_SUBDIR), max_segment_bytes=512, max_segments=2
    )
    for i in range(500):
        rec.record_event({"ev": "done", "t": 1000.0 + i, "job": i})
    rec.dump("shutdown")
    rec.close()
    records = obs.flight.read_flight(str(tmp_path))
    # Drop-oldest: the ring kept a bounded tail that ends with the dump.
    assert 0 < len(records) < 500
    assert records[-1] == {
        "k": "dump",
        "t": records[-1]["t"],
        "reason": "shutdown",
    }
    jobs = [r["job"] for r in records if r["k"] == "ev"]
    assert jobs == sorted(jobs) and jobs[-1] == 499  # newest survives


def test_recorder_ignores_non_x_spans_and_survives_close(tmp_path, obs):
    rec = obs.flight.FlightRecorder(os.path.join(str(tmp_path), obs.flight.FLIGHT_SUBDIR))
    rec.record_span({"ph": "M", "name": "thread_name"})  # metadata: skipped
    rec.record_span({"ph": "X", "name": "s", "ts": 1.0, "dur": 2.0, "tid": 3})
    rec.close()
    rec.record_event({"ev": "late"})  # after close: silently dropped
    records = obs.flight.read_flight(str(tmp_path))
    assert [r["k"] for r in records] == ["span"]
    assert records[0]["name"] == "s"


def test_read_flight_tolerates_missing_ring(tmp_path, obs):
    assert obs.flight.read_flight(str(tmp_path / "never-existed")) == []


def test_postmortem_reconstructs_breach_leases_and_unclean_death(tmp_path, obs):
    rec = obs.flight.FlightRecorder(os.path.join(str(tmp_path), obs.flight.FLIGHT_SUBDIR))
    # Timestamps must be wall-adjacent: dump/span records stamp real wall
    # time, and the replay evaluates windows at the LAST recorded instant.
    t = time.time() - 30.0
    rec.record_event({"ev": "lease_grant", "t": t, "job": 5, "devices": [0, 1]})
    rec.record_event({"ev": "lease_grant", "t": t + 1, "job": 6, "devices": [2]})
    rec.record_event({"ev": "lease_release", "t": t + 2, "job": 5})
    for i in range(12):
        rec.record_event({"ev": "job_error", "t": t + 3 + i, "job": 10 + i})
    rec.record_span(
        {"ph": "X", "name": "search", "ts": 0.0, "dur": 9e6, "tid": 5}
    )
    rec.dump(
        "slo_breach",
        breach={"reasons": [{"kind": "fast_burn", "burn_rate": 100.0,
                             "window": "1m"}]},
    )
    # No shutdown dump: the daemon died mid-flight.
    rec.close()

    pm = obs.flight.postmortem(str(tmp_path))
    assert not pm["clean_shutdown"]
    assert len(pm["breaches"]) == 1
    # job 6's grant was never released → open at death.
    assert [l["job"] for l in pm["open_leases"]] == [6]
    assert pm["slowest_spans"][0]["name"] == "search"
    # SLO replayed from the recorded events at the moment of death.
    assert not pm["slo_at_death"]["healthy"]

    report = obs.flight.render_postmortem(pm)
    assert "UNCLEAN DEATH" in report
    assert "SLO breaches recorded" in report
    assert "fast_burn" in report
    assert "leases open at death: 1" in report
    assert "flight tail" in report


def test_postmortem_on_clean_daemon_shutdown(tmp_path, obs):
    cfg = obs.daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"),
        out_dir=str(tmp_path / "viz"),
        no_viz=True,
        stats_log=None,
        device="off",
        state_dir=str(tmp_path / "state"),
    )
    with obs.daemon.Verifyd(cfg) as daemon:
        client = obs.client.VerifydClient(cfg.socket_path)
        assert client.submit(_good(), client="doc")["verdict"] == 0
    pm = obs.flight.postmortem(cfg.state_dir)
    assert pm["clean_shutdown"]
    assert pm["last_record"]["reason"] == "shutdown"
    # The shutdown dump carries the SLO snapshot at that instant.
    assert "slo" in pm["last_record"]
    assert pm["events"] > 0 and pm["spans"] > 0
    assert "clean shutdown" in obs.flight.render_postmortem(pm)


def test_doctor_on_missing_state_dir_is_a_usage_error(tmp_path, obs):
    rc = obs.cli.main(["doctor", "--state-dir", str(tmp_path / "nope")])
    assert rc == 64  # EX_USAGE


def test_metrics_server_serves_exposition_and_404(obs):
    r = obs.metrics.MetricsRegistry()
    r.counter("hits_total", "Hits").inc()
    srv = obs.httpd.MetricsServer(r, port=0)
    try:
        resp = urllib.request.urlopen(srv.url, timeout=5)  # …/metrics
        assert "version=0.0.4" in resp.headers["Content-Type"]
        assert "hits_total 1" in resp.read().decode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/nope", timeout=5
            )
        assert ei.value.code == 404
    finally:
        srv.close()


def test_healthz_flips_503_with_reasons_and_slo_serves_snapshot(obs):
    reg = obs.metrics.MetricsRegistry()
    health = obs.health.SLOHealth(registry=reg)
    srv = obs.httpd.MetricsServer(reg, port=0, health=health)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        resp = urllib.request.urlopen(base + "/healthz", timeout=5)
        assert resp.status == 200
        assert json.loads(resp.read())["status"] == "ok"

        slo = json.loads(
            urllib.request.urlopen(base + "/slo", timeout=5).read()
        )
        assert slo["healthy"] and set(slo["windows"]) == {"1m", "5m", "30m"}

        for i in range(12):
            health.observe_event({"ev": "job_error"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/healthz", timeout=5)
        assert exc.value.code == 503
        body = json.loads(exc.value.read())
        assert body["status"] == "degraded" and body["reasons"]

        # /metrics refresh pushed the degraded state into the gauges.
        scrape = (
            urllib.request.urlopen(base + "/metrics", timeout=5)
            .read()
            .decode()
        )
        assert "verifyd_slo_healthy 0" in scrape
        assert "verifyd_slo_burn_rate" in scrape
    finally:
        srv.close()


def test_metrics_server_without_health_keeps_legacy_healthz(obs):
    reg = obs.metrics.MetricsRegistry()
    srv = obs.httpd.MetricsServer(reg, port=0)
    try:
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/healthz", timeout=5
        )
        assert resp.status == 200
        assert resp.read() == b"ok\n"
    finally:
        srv.close()


def test_resource_sampler_feeds_the_flight_recorder(tmp_path, obs):
    rec = obs.flight.FlightRecorder(str(tmp_path / "flight"))
    s = obs.introspect.ResourceSampler(None, interval_s=60.0, recorder=rec)
    s.sample_once()
    s.sample_once()
    rec.close()
    pm = obs.flight.postmortem(str(tmp_path))
    assert pm["resource_samples"] == 2
    assert pm["resources"][-1]["rss_bytes"] > 0
    report = obs.flight.render_postmortem(pm)
    assert "resource timeline" in report
    assert "rss=" in report


def test_dashboard_and_introspection_over_a_live_daemon(tmp_path, obs):
    cfg = obs.daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"),
        out_dir=str(tmp_path / "viz"),
        no_viz=True,
        stats_log=None,
        device="off",
        metrics_port=0,
        resource_sample_s=0.1,
        dashboard_sample_s=0.1,
    )
    with obs.daemon.Verifyd(cfg) as daemon:
        client = obs.client.VerifydClient(cfg.socket_path)
        assert client.submit(_good(), client="v3")["verdict"] == 0
        # Let the dashboard thread take at least one post-job sample.
        for _ in range(100):
            if daemon.dashboard.payload()["retained"] >= 2:
                break
            threading.Event().wait(0.05)
        port = daemon.metrics_port

        html = (
            urllib.request.urlopen(
                "http://127.0.0.1:%d/dashboard" % port, timeout=5
            )
            .read()
            .decode()
        )
        assert html.startswith("<!DOCTYPE html>")
        assert "<svg" in html and "polyline" in html
        assert "throughput" in html and "host RSS" in html

        feed = json.loads(
            urllib.request.urlopen(
                "http://127.0.0.1:%d/dashboard.json" % port, timeout=5
            ).read()
        )
        assert feed["retained"] >= 2
        assert set(feed["series"]) >= {"throughput", "queue_depth", "rss_mb"}
        assert len(feed["series"]["rss_mb"]) == feed["retained"]
        assert any(v > 0 for v in feed["series"]["rss_mb"])

        # Content negotiation: the OpenMetrics variant ends with EOF, the
        # classic variant never contains it.
        req = urllib.request.Request(
            "http://127.0.0.1:%d/metrics" % port,
            headers={"Accept": "application/openmetrics-text"},
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert resp.headers["Content-Type"] == obs.metrics.OPENMETRICS_CONTENT_TYPE
            om = resp.read().decode()
        assert om.rstrip().endswith("# EOF")
        assert 'trace_id="' in om  # the served job left an exemplar
        classic = (
            urllib.request.urlopen(
                "http://127.0.0.1:%d/metrics" % port, timeout=5
            )
            .read()
            .decode()
        )
        assert "# EOF" not in classic

        # The stats op carries the introspection section.
        snap = client.stats()
        intro = snap["introspection"]
        assert "jit" in intro and "storm_threshold" in intro["jit"]
        assert intro["resources"]["last"]["rss_bytes"] > 0

        # The port's stats op adds the kernel launches, and /metrics
        # carries their family.
        if obs.daemon.__name__.startswith("s2_verification_tpu_torch."):
            assert set(intro["launches"]) == {"inline", "children"}
            assert "# TYPE verifyd_kernel_launches_total counter" in classic


def test_dashboard_routes_404_without_a_dashboard(tmp_path, obs):
    cfg = obs.daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"),
        out_dir=str(tmp_path / "viz"),
        no_viz=True,
        stats_log=None,
        device="off",
        metrics_port=0,
        dashboard_sample_s=0.0,  # explicit opt-out
    )
    with obs.daemon.Verifyd(cfg) as daemon:
        try:
            urllib.request.urlopen(
                "http://127.0.0.1:%d/dashboard" % daemon.metrics_port,
                timeout=5,
            )
        except urllib.error.HTTPError as e:
            assert e.code == 404
        else:  # pragma: no cover
            raise AssertionError("expected 404")


def test_dashboard_sampling_is_registry_driven(obs):
    reg = obs.metrics.MetricsRegistry()
    completed = reg.counter("verifyd_jobs_completed_total")
    ts = iter(float(i) for i in range(100))
    d = obs.dashboard.Dashboard(reg, interval_s=1.0, capacity=4, time_fn=lambda: next(ts))
    d.sample_once()
    completed.inc(5)
    d.sample_once()  # 5 completions over a 1s tick → 5 jobs/s
    assert d.payload()["series"]["throughput"][-1] == 5.0
    for _ in range(5):
        d.sample_once()
    p = d.payload()
    assert p["retained"] == 4  # bounded ring: oldest samples fell off
    assert len(p["t"]) == 4
    assert all(len(s) == 4 for s in p["series"].values())
    html = d.render_html()
    assert "<svg" in html
    assert json.loads(d.render_json())["retained"] == 4


def test_profiles_csv_export_quotes_commas_and_serializes_containers(obs):
    records = [
        {
            "t": 1.5,
            "job": 1,
            "client": 'ci,"weird" bot',
            "shape": "64x5x8,dense",
            "backend": "device-mesh[4]",
            "verdict": 0,
            "wall_s": 0.25,
            "queue_wait_s": 0.01,
            "lease_wait_s": 0.0,
            "ops": 64,
            "shards": {"n": 4, "note": 'a,b "c"'},
            "fp": "ff00",
        }
    ]
    buf = io.StringIO()
    obs.cli._export_profiles(records, buf, "csv")
    text = buf.getvalue()
    # RFC 4180: embedded quotes doubled inside a quoted cell.
    assert '"ci,""weird"" bot"' in text
    rows = list(csv.reader(io.StringIO(text)))
    assert rows[0] == list(obs.cli._PROFILE_COLUMNS)
    row = dict(zip(rows[0], rows[1]))
    assert row["client"] == 'ci,"weird" bot'
    assert row["shape"] == "64x5x8,dense"
    # Container cells come back as JSON, not a Python repr.
    assert json.loads(row["shards"]) == {"n": 4, "note": 'a,b "c"'}


def test_daemon_boots_seed_sentinel_and_serve_tsq(tmp_path, obs):
    state_dir = str(tmp_path / "state")
    # manufacture boot-1 history carrying a sentinel baseline
    reg = obs.metrics.MetricsRegistry()
    reg.gauge(
        "verifyd_perf_baseline_wall_seconds", "b", labelnames=("shape",)
    ).set(0.5, shape="99x9x9")
    reg.gauge(
        "verifyd_perf_regression_fired", "f", labelnames=("shape",)
    ).set(0.0, shape="99x9x9")
    store = obs.tsdb.TelemetryStore(obs.tsdb.default_dir(state_dir), reg, time_fn=lambda: 50.0)
    store.sample_once()
    store.close()

    cfg = obs.daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"),
        out_dir=str(tmp_path / "viz"),
        no_viz=True,
        stats_log=None,
        device="off",
        state_dir=state_dir,
        telemetry_sample_s=30.0,  # the op forces samples; no thread races
    )
    with obs.daemon.Verifyd(cfg) as daemon:
        assert daemon.telemetry is not None
        # boot 2 seeded the sentinel from boot 1's history
        shapes = daemon.sentinel.snapshot()["shapes"]
        assert shapes["99x9x9"]["baseline_wall_s"] == 0.5
        # build identity is a registry fact on every daemon
        assert "verifyd_build_info{" in daemon.registry.render()

        client = obs.client.VerifydClient(cfg.socket_path)
        assert client.submit(_good(), client="tsq")["verdict"] == 0
        # the stats op surfaces the store
        snap = client.stats()
        assert snap["telemetry"]["dir"] == obs.tsdb.default_dir(state_dir)
        # live tsq: the op samples first, so the reply always has points
        info = client.tsq(info=True)
        assert info["resolutions"]["raw"]["records"] >= 2  # boot-1 + live
        out = client.tsq(metric="verifyd_build_info")
        assert any(
            "verifyd_build_info" in key for key in out["series"]
        )
        # the seeded baseline flows into boot 2's own recorded history
        out = client.tsq(metric="verifyd_perf_baseline_wall_seconds")
        (key,) = [k for k in out["series"] if "99x9x9" in k]
        assert out["series"][key][-1][1] == 0.5
        with pytest.raises(obs.client.VerifydError):
            client.tsq(res="2h")


def test_tsq_without_state_dir_is_a_clean_error(tmp_path, obs):
    cfg = obs.daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"),
        out_dir=str(tmp_path / "viz"),
        no_viz=True,
        stats_log=None,
        device="off",
    )
    with obs.daemon.Verifyd(cfg):
        client = obs.client.VerifydClient(cfg.socket_path)
        assert client.submit(_good(), client="x")["verdict"] == 0
        with pytest.raises(obs.client.VerifydError, match="no telemetry store"):
            client.tsq(info=True)


#: a daemon of ``{pkg}`` whose first 12 jobs fail (tripping the SLO's fast
#: burn) and whose 13th hangs, accepted and never closed; the parent
#: SIGKILLs it
_CRASH_SCRIPT = """
import os, sys, threading, time
sys.path.insert(0, {repo!r})
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from {pkg}.service import scheduler as sched_mod
from {pkg}.service.daemon import Verifyd, VerifydConfig
from {pkg}.service.client import VerifydClient, VerifydError

state_dir, sock, hist_path = sys.argv[1], sys.argv[2], sys.argv[3]
hist = open(hist_path, encoding="utf-8").read()

calls = {{"n": 0}}
def stub(h, budget, profile=False):
    calls["n"] += 1
    if calls["n"] <= 12:
        raise RuntimeError("induced failure %d" % calls["n"])
    time.sleep(600)
sched_mod._cpu_check = stub

import logging; logging.disable(logging.CRITICAL)
cfg = VerifydConfig(socket_path=sock, state_dir=state_dir, device="off",
                    no_viz=True, stats_log=None, workers=1, telemetry_sample_s=0.1,
                    out_dir=os.path.join(state_dir, "viz"))
daemon = Verifyd(cfg).__enter__()
client = VerifydClient(sock, timeout=120)
for i in range(12):
    try:
        client.submit(hist, client="burst%d" % i)
    except VerifydError:
        pass
threading.Thread(target=lambda: client.submit(hist, client="hung"), daemon=True).start()
while calls["n"] < 13 or daemon.telemetry.registry.get(
    "verifyd_telemetry_points_total"
).value(res="raw") < 4:
    time.sleep(0.05)
print("READY", flush=True)
time.sleep(600)
"""


def test_doctor_reads_a_sigkilled_daemons_state_dir(tmp_path, capsys, obs):
    """A daemon of either package SIGKILLed after an SLO breach with one job
    hung: both packages' ``doctor`` read the state dir cold to the same
    post-mortem and the same report — unclean death, the breach, the hung
    orphan, the telemetry history — and cold ``tsq`` reads its rings."""
    pkg = obs.daemon.__name__.split(".")[0]
    state_dir, sock, hist_path = str(tmp_path / "state"), str(tmp_path / "v.sock"), tmp_path / "hist.jsonl"
    hist_path.write_text(_good())
    script = tmp_path / "crash.py"
    script.write_text(_CRASH_SCRIPT.format(repo=str(ROOT), pkg=pkg))
    proc = subprocess.Popen(
        [sys.executable, str(script), state_dir, sock, str(hist_path)],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.strip() == "READY", f"the crash script died early: {line!r}"
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    reports, pms = {}, {}
    for name in ("s2_verification_tpu", "s2_verification_tpu_torch"):
        capsys.readouterr()
        assert importlib.import_module(f"{name}.cli").main(["doctor", "--state-dir", state_dir]) == 1
        reports[name] = capsys.readouterr().out
        pm = pms[name] = importlib.import_module(f"{name}.obs.flight").postmortem(state_dir)
        assert not pm["clean_shutdown"] and pm["breaches"]
        assert [o.get("client") for o in pm["orphans"]] == ["hung"]
        assert pm["telemetry"]["resolutions"]["raw"]["records"] >= 4
        assert not pm["slo_at_death"]["healthy"]
    # Side by side, exact: the same post-mortem and the same report.
    assert pms["s2_verification_tpu"] == pms["s2_verification_tpu_torch"]
    assert reports["s2_verification_tpu"] == reports["s2_verification_tpu_torch"]
    for out in reports.values():
        for want in ("UNCLEAN DEATH", "SLO breaches recorded", "orphaned journal entries", "client=hung",
                     "telemetry history", "flight tail"):
            assert want in out, want
    assert obs.cli.main(["tsq", "--state-dir", state_dir, "--metric", "verifyd_queue_depth"]) == 0
    assert "verifyd_queue_depth" in capsys.readouterr().out
