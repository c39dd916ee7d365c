"""The alert engine (obs/alerts.py) beside the JAX package's.

- Every case of ``tests/test_alerts.py``, run over both packages: the rule
  grammar, the built-in rules, delivery of the alertmanager payload to a
  real loopback receiver, backoff on 5xx, permanent failure with its
  flight marker, no retry on a definite 4xx, the dedup window, edge
  triggering and re-arm of field and metric rules.  Clocks and sleeps are
  injected, so no case waits on real backoff.
- Side by side, exact: the same rules fed the same events deliver the same
  payloads (the ``startsAt`` stamps aside) and count the same in the
  metric families of each package.
- Through the daemon: a port daemon under ``alert_url`` delivers a
  ``--alert-rule`` match to the receiver, and records the alert in its
  flight ring, which the other package's ``postmortem`` reads.
"""

import http.server
import importlib
import io
import json
import threading
from types import SimpleNamespace

import pytest

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    'AlertEngine': ('obs.alerts', 'AlertEngine'),
    'AlertRule': ('obs.alerts', 'AlertRule'),
    'builtin_rules': ('obs.alerts', 'builtin_rules'),
    'parse_rule': ('obs.alerts', 'parse_rule'),
    'MetricsRegistry': ('obs.metrics', 'MetricsRegistry'),
}


@pytest.fixture(autouse=True, params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    for name, (mod, attr) in _NAMES.items():
        m = importlib.import_module(f"{request.param}.{mod}" if mod else request.param)
        setattr(P, name, getattr(m, attr) if attr else m)
    yield request.param


@pytest.fixture(autouse=True)
def _time_limit():
    """Each case fails after 60 s instead of hanging the run."""
    from test_torch_service import time_limit

    with time_limit(60):
        yield


class _Receiver:
    """Scripted webhook endpoint: ``script`` is the status code per
    attempt (exhausted → 200).  Bodies of accepted (2xx) posts are kept."""

    def __init__(self, script=()):
        self.bodies = []
        self.attempts = 0
        script = list(script)
        recv = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - stdlib handler name
                recv.attempts += 1
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                code = script.pop(0) if script else 200
                if 200 <= code < 300:
                    recv.bodies.append(json.loads(body.decode("utf-8")))
                self.send_response(code)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/alert"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()


class _Recorder:
    """FlightRecorder stand-in capturing alert records and dump markers."""

    def __init__(self):
        self.alerts = []
        self.dumps = []

    def record_alert(self, alert):
        self.alerts.append(dict(alert))

    def dump(self, reason, **fields):
        self.dumps.append({"reason": reason, **fields})


def _engine(url, **kw):
    kw.setdefault("registry", P.MetricsRegistry())
    kw.setdefault("sleep_fn", lambda s: None)
    return P.AlertEngine(url, **kw)


# -- rule grammar -----------------------------------------------------------


def test_parse_rule_event():
    r = P.parse_rule("slo_breach")
    assert r.kind == "event" and r.event == "slo_breach"
    assert r.severity == "page"


def test_parse_rule_field_threshold():
    r = P.parse_rule("done.wall_s>30")
    assert r == P.AlertRule(
        name="done.wall_s>30", kind="field", event="done", field="wall_s",
        op=">", threshold=30.0, severity="warn",
    )


def test_parse_rule_metric_threshold_longest_op_wins():
    r = P.parse_rule("metric:verifyd_job_errors_total>=5")
    assert r.kind == "metric"
    assert r.metric == "verifyd_job_errors_total"
    assert r.op == ">=" and r.threshold == 5.0


@pytest.mark.parametrize(
    "spec",
    ["", "  ", "done.>3", ".wall_s>3", "wall_s>", "metric:>5",
     "metric:foo>bar", "no spaces allowed", "a.b.c>x"],
)
def test_parse_rule_rejects_nonsense(spec):
    with pytest.raises(ValueError):
        P.parse_rule(spec)


def test_builtin_rules_page_on_breach_and_regression():
    names = {r.name for r in P.builtin_rules()}
    assert names == {
        "slo_breach",
        "perf_regression",
        "retrace_storm",
        "job_quarantined",
        "writer_degraded",
        "checker_false_verdict",
    }
    assert all(r.severity == "page" for r in P.builtin_rules())


# -- delivery ---------------------------------------------------------------


def test_delivers_alertmanager_payload():
    recv = _Receiver()
    recorder = _Recorder()
    eng = _engine(recv.url, recorder=recorder)
    try:
        eng.observe_event(
            {"ev": "slo_breach", "t": 123.0, "reason": "burn", "shape": "4x2x8"}
        )
        assert eng.flush(timeout=10.0)
        assert len(recv.bodies) == 1
        payload = recv.bodies[0]
        assert isinstance(payload, list) and len(payload) == 1
        alert = payload[0]
        assert alert["labels"]["alertname"] == "slo_breach"
        assert alert["labels"]["service"] == "verifyd"
        assert alert["labels"]["severity"] == "page"
        assert alert["labels"]["shape"] == "4x2x8"
        assert "T" in alert["startsAt"] and alert["startsAt"].endswith("Z")
        assert "slo_breach" in alert["annotations"]["summary"]
        detail = json.loads(alert["annotations"]["detail"])
        assert detail["reason"] == "burn"
        # flight ring got the alert record on the firing path
        assert recorder.alerts == [
            {"rule": "slo_breach", "event": "slo_breach", "severity": "page"}
        ]
        sent = eng.registry.get("verifyd_alerts_sent_total")
        assert sum(sent.snapshot().values()) == 1
    finally:
        eng.close()
        recv.close()


def test_5xx_backs_off_then_succeeds():
    recv = _Receiver(script=[503, 500])
    sleeps = []
    eng = _engine(recv.url, backoff_s=0.5, sleep_fn=sleeps.append)
    try:
        eng.observe_event({"ev": "slo_breach"})
        assert eng.flush(timeout=10.0)
        assert recv.attempts == 3  # 503, 500, 200
        assert len(recv.bodies) == 1
        # full jitter: each sleep within the exponential cap for its attempt
        assert len(sleeps) == 2
        assert 0.0 <= sleeps[0] <= 0.5
        assert 0.0 <= sleeps[1] <= 1.0
        sent = eng.registry.get("verifyd_alerts_sent_total")
        failed = eng.registry.get("verifyd_alerts_failed_total")
        assert sum(sent.snapshot().values()) == 1
        assert sum(failed.snapshot().values()) == 0
    finally:
        eng.close()
        recv.close()


def test_permanent_failure_counts_and_dumps():
    recv = _Receiver(script=[500, 500, 500])
    recorder = _Recorder()
    eng = _engine(recv.url, retries=2, recorder=recorder)
    try:
        eng.observe_event({"ev": "slo_breach"})
        assert eng.flush(timeout=10.0)
        assert recv.attempts == 3  # initial + 2 retries, all 500
        assert recv.bodies == []
        failed = eng.registry.get("verifyd_alerts_failed_total")
        assert failed.value(rule="slo_breach") == 1
        assert len(recorder.dumps) == 1
        dump = recorder.dumps[0]
        assert dump["reason"] == "alert_failed"
        assert dump["rule"] == "slo_breach"
        assert dump["attempts"] == 3
        assert "500" in dump["error"]
    finally:
        eng.close()
        recv.close()


def test_definite_4xx_is_not_retried():
    recv = _Receiver(script=[400, 200, 200])
    eng = _engine(recv.url, retries=3)
    try:
        eng.observe_event({"ev": "slo_breach"})
        assert eng.flush(timeout=10.0)
        assert recv.attempts == 1  # 400 is definite: no retry
        failed = eng.registry.get("verifyd_alerts_failed_total")
        assert sum(failed.snapshot().values()) == 1
    finally:
        eng.close()
        recv.close()


# -- dedup / re-arm ---------------------------------------------------------


def test_dedup_window_suppresses_then_rearms():
    recv = _Receiver()
    clock = [1000.0]
    eng = _engine(recv.url, dedup_s=300.0, time_fn=lambda: clock[0])
    try:
        eng.observe_event({"ev": "slo_breach"})
        clock[0] += 10.0
        eng.observe_event({"ev": "slo_breach"})  # inside the window
        assert eng.flush(timeout=10.0)
        assert len(recv.bodies) == 1
        snap = eng.snapshot()
        assert snap["rules"]["slo_breach"]["fired"] == 1
        assert snap["rules"]["slo_breach"]["suppressed"] == 1
        sup = eng.registry.get("verifyd_alerts_suppressed_total")
        assert sup.value(rule="slo_breach") == 1

        clock[0] += 300.0  # window over: delivery resumes
        eng.observe_event({"ev": "slo_breach"})
        assert eng.flush(timeout=10.0)
        assert len(recv.bodies) == 2
    finally:
        eng.close()
        recv.close()


def test_field_rule_edge_triggered_rearm():
    recv = _Receiver()
    clock = [0.0]
    eng = _engine(
        recv.url,
        rules=[P.parse_rule("done.wall_s>1")],
        dedup_s=0.0,
        time_fn=lambda: clock[0],
    )
    try:
        for wall in (2.0, 3.0, 5.0):  # one crossing, held above
            clock[0] += 1.0
            eng.observe_event({"ev": "done", "wall_s": wall})
        assert eng.flush(timeout=10.0)
        assert len(recv.bodies) == 1  # fired on the edge only

        clock[0] += 1.0
        eng.observe_event({"ev": "done", "wall_s": 0.5})  # back in band
        clock[0] += 1.0
        eng.observe_event({"ev": "done", "wall_s": 2.0})  # second crossing
        assert eng.flush(timeout=10.0)
        assert len(recv.bodies) == 2
    finally:
        eng.close()
        recv.close()


def test_metric_rule_thresholds_registry_value():
    recv = _Receiver()
    registry = P.MetricsRegistry()
    errors = registry.counter(
        "job_errors_total", "test counter", labelnames=("kind",)
    )
    eng = _engine(
        recv.url,
        rules=[P.parse_rule("metric:job_errors_total>=3")],
        registry=registry,
        dedup_s=0.0,
    )
    try:
        errors.inc(kind="a")
        eng.observe_event({"ev": "done"})  # 1 < 3: quiet
        errors.inc(kind="a")
        errors.inc(kind="b")  # labeled sum = 3
        eng.observe_event({"ev": "done"})
        eng.observe_event({"ev": "done"})  # still over: edge-triggered, quiet
        assert eng.flush(timeout=10.0)
        assert len(recv.bodies) == 1
        assert recv.bodies[0][0]["labels"]["severity"] == "warn"
    finally:
        eng.close()
        recv.close()


def test_unmatched_events_deliver_nothing():
    recv = _Receiver()
    eng = _engine(recv.url)
    try:
        eng.observe_event({"ev": "done", "wall_s": 0.1})
        eng.observe_event({"ev": "accept"})
        eng.observe_event({"no_event_key": True})
        assert eng.flush(timeout=5.0)
        assert recv.bodies == [] and recv.attempts == 0
    finally:
        eng.close()
        recv.close()


# -- side by side and through the daemon --------------------------------------


def other(package: str) -> str:
    return PACKAGES[1 - PACKAGES.index(package)]


def _mod(package: str, path: str):
    return importlib.import_module(f"{package}.{path}")


#: one event stream that fires every kind of rule, crosses and re-arms a
#: field threshold, and repeats a page inside its dedup window
STREAM = [
    {"ev": "slo_breach", "t": 10.0, "reason": "burn", "shape": "4x2x8"},
    {"ev": "done", "t": 11.0, "job": 1, "wall_s": 45.0, "shape": "4x2x8"},
    {"ev": "done", "t": 12.0, "job": 2, "wall_s": 50.0, "shape": "4x2x8"},
    {"ev": "done", "t": 13.0, "job": 3, "wall_s": 1.0, "shape": "4x2x8"},
    {"ev": "done", "t": 14.0, "job": 4, "wall_s": 31.0, "shape": "8x4x16"},
    {"ev": "perf_regression", "t": 15.0, "shape": "4x2x8", "wall_s": 3.0, "baseline_s": 1.0},
    {"ev": "slo_breach", "t": 16.0, "reason": "burn", "shape": "4x2x8"},
    {"ev": "job_quarantined", "t": 17.0, "fingerprint": "ab" * 32, "crashes": 3},
]


def _deliver(package: str) -> tuple[list, dict]:
    alerts, metrics = _mod(package, "obs.alerts"), _mod(package, "obs.metrics")
    recv = _Receiver()
    reg = metrics.MetricsRegistry()
    rules = {r.name: r for r in alerts.builtin_rules()}
    rules.update((r.name, r) for r in map(alerts.parse_rule, ["done.wall_s>30", "metric:t_depth>=2"]))
    depth = reg.gauge("t_depth", "depth")
    eng = alerts.AlertEngine(recv.url, rules.values(), registry=reg, sleep_fn=lambda s: None,
                             time_fn=lambda: 1000.0)
    try:
        for i, ev in enumerate(STREAM):
            depth.set(float(i % 4))
            eng.observe_event(dict(ev))
        assert eng.flush(timeout=10.0)
    finally:
        eng.close()
        recv.close()
    families = {
        name: reg.get(name).snapshot()
        for name in ("verifyd_alerts_sent_total", "verifyd_alerts_suppressed_total", "verifyd_alerts_failed_total")
    }
    return recv.bodies, families


def test_the_same_events_deliver_the_same_payloads(package):
    mine, theirs = _deliver(package), _deliver(other(package))
    assert mine[0] and mine == theirs


def test_a_daemon_delivers_a_rule_match_and_rings_it(tmp_path, package):
    """``package``'s daemon, under ``alert_url`` and ``--alert-rule done``,
    delivers the ``done`` of its one job; the alert lands in its flight
    ring, which the other package's ``postmortem`` reads."""
    from helpers import H, fold

    h = H()
    h.append_ok(1, [7], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([7]))
    buf = io.StringIO()
    _mod("s2_verification_tpu", "utils.events").write_history(h.events, buf)
    recv = _Receiver()
    daemon, client = _mod(package, "service.daemon"), _mod(package, "service.client")
    cfg = daemon.VerifydConfig(
        socket_path=str(tmp_path / "v.sock"), device="off", no_viz=True, stats_log=None,
        state_dir=str(tmp_path / "state"), alert_url=recv.url, alert_rules=("done",),
    )
    try:
        with daemon.Verifyd(cfg) as d:
            assert client.VerifydClient(cfg.socket_path, timeout=30).submit(buf.getvalue())["verdict"] == 0
            assert d.alerts.flush(timeout=10.0)
    finally:
        recv.close()
    names = [a["labels"]["alertname"] for body in recv.bodies for a in body]
    assert names == ["done"]
    pm = _mod(other(package), "obs.flight").postmortem(cfg.state_dir)
    assert [(a["rule"], a["event"]) for a in pm["alerts"]] == [("done", "done")]
    assert pm["clean_shutdown"]
