"""The perf sentinel (obs/sentinel.py) beside the JAX package's: the
cases of ``tests/test_sentinel.py``, each run over both packages (EWMA fold
math, the consecutive filter, latch and re-arm, the floor, per-shape
independence, metrics), its routing case in two halves (``done`` events
through a ``ServiceStats`` re-emit ``perf_regression`` and count it, and
the alert engine pages on it), and the restart-surviving baselines of
``tests/test_obs_v4.py``: ``seed_from_telemetry`` over a telemetry store
fires a post-restart slowdown against the pre-restart baseline, keeps a
latched shape latched, and yields to live samples.
"""

import importlib
import io
import json
from types import SimpleNamespace

import pytest

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")


@pytest.fixture(params=PACKAGES)
def sen(request):
    return SimpleNamespace(**{
        name: importlib.import_module(f"{request.param}.{path}")
        for name, path in (("sentinel", "obs.sentinel"), ("metrics", "obs.metrics"), ("stats", "service.stats"),
                           ("alerts", "obs.alerts"), ("tsdb", "obs.tsdb"))
    })


def fast(sen):
    return sen.sentinel.SentinelConfig(min_samples=3, consecutive=2, floor_s=0.001)


def _warm(s, shape="4x2x8", n=5, wall=0.1):
    for _ in range(n):
        assert s.observe(shape, wall) is None


def test_ewma_drift_predicate(sen):
    assert sen.sentinel.ewma_drift(1.76, 1.0, 0.75)
    assert not sen.sentinel.ewma_drift(1.75, 1.0, 0.75)
    assert not sen.sentinel.ewma_drift(0.5, 1.0, 0.75)


def test_cold_start_never_fires(sen):
    s = sen.sentinel.PerfSentinel(sen.sentinel.SentinelConfig(min_samples=10, consecutive=1))
    for _ in range(10):
        assert s.observe("shape", 5.0) is None
    # 11th sample is judged, but sits on its own baseline: still quiet
    assert s.observe("shape", 5.0) is None


def test_consecutive_filter_and_report_fields(sen):
    s = sen.sentinel.PerfSentinel(fast(sen))
    _warm(s, n=5)
    assert s.observe("4x2x8", 1.0) is None  # streak 1 of 2
    report = s.observe("4x2x8", 1.0)  # streak 2: fires
    assert report is not None
    assert report["shape"] == "4x2x8"
    assert report["wall_s"] == 1.0
    # baseline folded once at alpha/8 by the first slow sample:
    # 0.1 + (0.25/8)*(1.0-0.1) ≈ 0.128
    assert 0.09 < report["baseline_wall_s"] < 0.15
    assert report["ratio"] > 6
    assert report["streak"] == 2
    assert report["samples"] == 7


def test_single_spike_is_not_a_regression(sen):
    s = sen.sentinel.PerfSentinel(fast(sen))
    _warm(s, n=5)
    assert s.observe("4x2x8", 1.0) is None  # one blip
    assert s.observe("4x2x8", 0.1) is None  # back in band: streak reset
    assert s.observe("4x2x8", 1.0) is None  # streak restarts at 1
    assert s.observe("4x2x8", 1.0) is not None


def test_latched_until_recovery_then_rearms(sen):
    s = sen.sentinel.PerfSentinel(fast(sen))
    _warm(s, n=5)
    s.observe("4x2x8", 1.0)
    assert s.observe("4x2x8", 1.0) is not None  # fires
    assert s.observe("4x2x8", 1.0) is None  # latched: no page storm
    assert s.observe("4x2x8", 0.1) is None  # recovery re-arms
    s.observe("4x2x8", 1.0)
    assert s.observe("4x2x8", 1.0) is not None  # second regression pages
    assert s.snapshot()["shapes"]["4x2x8"]["regressions"] == 2


def test_spike_barely_moves_baseline(sen):
    s = sen.sentinel.PerfSentinel(fast(sen))
    _warm(s, n=5)
    before = s.snapshot()["shapes"]["4x2x8"]["baseline_wall_s"]
    s.observe("4x2x8", 10.0)  # out of band: folds at alpha/8
    after = s.snapshot()["shapes"]["4x2x8"]["baseline_wall_s"]
    assert after < before + (10.0 - before) * fast(sen).alpha / 4
    # an in-band sample folds at full alpha by comparison
    s2 = sen.sentinel.PerfSentinel(fast(sen))
    _warm(s2, n=5)
    s2.observe("4x2x8", 0.15)
    moved = s2.snapshot()["shapes"]["4x2x8"]["baseline_wall_s"]
    assert moved > before + (0.15 - before) * fast(sen).alpha * 0.9


def test_floor_guards_noise_shapes(sen):
    s = sen.sentinel.PerfSentinel(sen.sentinel.SentinelConfig(min_samples=2, consecutive=1, floor_s=0.005))
    for _ in range(5):
        s.observe("tiny", 0.0001)
    # 30x drift but still under the floor: never judged
    assert s.observe("tiny", 0.003) is None


def test_shapes_are_independent(sen):
    s = sen.sentinel.PerfSentinel(fast(sen))
    _warm(s, shape="a", n=5, wall=0.1)
    _warm(s, shape="b", n=5, wall=2.0)
    s.observe("a", 1.0)
    assert s.observe("a", 1.0) is not None  # 10x on shape a
    assert s.observe("b", 2.0) is None  # shape b undisturbed


def test_metrics_and_snapshot(sen):
    reg = sen.metrics.MetricsRegistry()
    s = sen.sentinel.PerfSentinel(fast(sen), registry=reg)
    _warm(s, n=5)
    s.observe("4x2x8", 1.0)
    s.observe("4x2x8", 1.0)
    assert reg.get("verifyd_perf_regressions_total").value(shape="4x2x8") == 1
    assert reg.get("verifyd_perf_baseline_wall_seconds").value(shape="4x2x8") > 0
    snap = s.snapshot()
    assert snap["regressions"] == 1
    assert snap["config"]["band"] == fast(sen).band
    st = snap["shapes"]["4x2x8"]
    assert st["fired"] and st["streak"] == 2 and st["samples"] == 7


def test_event_stream_reemits_perf_regression(sen):
    """done events → sentinel → perf_regression on the stream → counter."""
    reg = sen.metrics.MetricsRegistry()
    sink = io.StringIO()
    stats = sen.stats.ServiceStats(sink, registry=reg, sentinel=sen.sentinel.PerfSentinel(fast(sen), registry=reg))
    for _ in range(5):
        stats.emit("done", shape="4x2x8", backend="native", wall_s=0.1)
    stats.emit("done", shape="4x2x8", backend="native", wall_s=1.0)
    stats.emit("done", shape="4x2x8", backend="native", wall_s=1.0)
    lines = [json.loads(line) for line in sink.getvalue().splitlines()]
    regressions = [e for e in lines if e["ev"] == "perf_regression"]
    assert len(regressions) == 1 and regressions[0]["shape"] == "4x2x8"
    snap = stats.snapshot()
    assert snap["perf_regressions"] == 1
    assert snap["sentinel"]["regressions"] == 1


def test_event_stream_routes_to_alert_engine(sen):
    """done events → sentinel → perf_regression re-emit → counter + alert."""
    reg = sen.metrics.MetricsRegistry()
    fired = []

    class _CaptureEngine(sen.alerts.AlertEngine):
        def _deliver(self, alert):
            fired.append(alert["rule"].name)

    eng = _CaptureEngine("http://127.0.0.1:1/unused", registry=reg)
    sentinel = sen.sentinel.PerfSentinel(fast(sen), registry=reg)
    stats = sen.stats.ServiceStats(sink=None, registry=reg, sentinel=sentinel, alerts=eng)
    try:
        for _ in range(5):
            stats.emit("done", shape="4x2x8", backend="native", wall_s=0.1)
        stats.emit("done", shape="4x2x8", backend="native", wall_s=1.0)
        stats.emit("done", shape="4x2x8", backend="native", wall_s=1.0)
        assert eng.flush(timeout=10.0)
        assert fired == ["perf_regression"]
        snap = stats.snapshot()
        assert snap["perf_regressions"] == 1
        assert snap["sentinel"]["regressions"] == 1
    finally:
        eng.close()


# -- restart-surviving baselines (test_obs_v4.py) ------------------------------


def test_slowdown_across_restart_fires_perf_regression(tmp_path, sen):
    """Boot 1 learns a baseline and dies; boot 2 seeds from the telemetry
    store, so a post-restart slowdown is judged against the pre-restart
    baseline and pages."""
    PerfSentinel, SentinelConfig = sen.sentinel.PerfSentinel, sen.sentinel.SentinelConfig
    tdir = str(tmp_path / "tel")
    clock = [1000.0]
    reg1 = sen.metrics.MetricsRegistry()
    s1 = PerfSentinel(SentinelConfig(), registry=reg1, time_fn=lambda: clock[0])
    for _ in range(12):
        clock[0] += 1.0
        assert s1.observe("64x5x8", 0.020, t=clock[0]) is None
    store = sen.tsdb.TelemetryStore(tdir, reg1, time_fn=lambda: clock[0])
    store.sample_once()
    store.close()

    s2 = PerfSentinel(SentinelConfig(), registry=sen.metrics.MetricsRegistry(), time_fn=lambda: clock[0])
    _t, finals = sen.tsdb.last_values(tdir)
    assert sen.sentinel.seed_from_telemetry(s2, finals) == 1
    snap = s2.snapshot()["shapes"]["64x5x8"]
    assert snap["baseline_wall_s"] == pytest.approx(0.020)
    assert snap["samples"] > SentinelConfig().min_samples
    reports = []
    for _ in range(3):
        clock[0] += 1.0
        reports.append(s2.observe("64x5x8", 0.080, t=clock[0]))
    assert reports[0] is None and reports[1] is None
    assert reports[2] is not None and reports[2]["shape"] == "64x5x8"
    assert reports[2]["baseline_wall_s"] < 0.03
    # control: an unseeded sentinel is cold and never fires on the same three
    s3 = PerfSentinel(SentinelConfig(), registry=sen.metrics.MetricsRegistry())
    assert all(s3.observe("64x5x8", 0.080, t=2000.0 + i) is None for i in range(3))


def test_latched_shape_stays_latched_across_restart(sen):
    values = {
        'verifyd_perf_baseline_wall_seconds{shape="8x3x4"}': 0.02,
        'verifyd_perf_regression_fired{shape="8x3x4"}': 1.0,
        'verifyd_perf_baseline_wall_seconds{shape="bad"}': 0.0,  # rejected
    }
    s = sen.sentinel.PerfSentinel(sen.sentinel.SentinelConfig(), registry=sen.metrics.MetricsRegistry())
    assert sen.sentinel.seed_from_telemetry(s, values) == 1
    assert s.observe("8x3x4", 0.080, t=1.0) is None  # latched: must not re-page
    assert s.observe("8x3x4", 0.020, t=2.0) is None  # recovery re-arms
    fired = [s.observe("8x3x4", 0.080, t=3.0 + i) for i in range(3)]
    assert fired[2] is not None


def test_live_samples_outrank_history(sen):
    s = sen.sentinel.PerfSentinel(sen.sentinel.SentinelConfig(), registry=sen.metrics.MetricsRegistry())
    s.observe("s", 0.01, t=1.0)
    assert s.seed("s", 9.9) is False
    assert s.snapshot()["shapes"]["s"]["baseline_wall_s"] == 0.01
