"""Rule-driven alert delivery: the first obs consumer that *acts*.

The port's copy of the JAX package's ``obs/alerts.py`` (plain Python,
unchanged in behaviour: the same rules, payloads and metric families).

Metrics, traces, SLO burn rates and the edge-triggered ``slo_breach``
event make the daemon visible, but alone every signal dead-ends in the
stats stream.  The :class:`AlertEngine` closes the loop: it
subscribes to the same ServiceStats event stream everything else rides
(fed outside the sink lock, like the flight recorder), matches each
event against a small rule set, and delivers alertmanager-compatible
JSON to an operator-configured URL (``serve --alert-url``) over stdlib
HTTP.

Rule grammar (``serve --alert-rule``, repeatable)::

    slo_breach                      fire whenever the event occurs
    done.wall_s>30                  event-field threshold (edge-triggered)
    reject.queue_depth>=48          ops: > >= < <=
    metric:verifyd_job_errors_total>100
                                    registry counter/gauge threshold,
                                    evaluated on every event (edge-triggered)

``slo_breach`` and ``perf_regression`` rules are built in — an alert URL
with no explicit rules still pages on the two signals that matter.

Delivery discipline (everything injected for tests):

- one background daemon thread drains a bounded queue, so a dead
  webhook endpoint can never stall the emit path a job passes through;
- exponential backoff with full jitter between attempts; a 4xx other
  than 408/429 is definite (the payload will never be accepted) and is
  not retried;
- per-rule dedup window (default 300 s): a flapping signal produces one
  delivery per window, the rest are counted as suppressed;
- field/metric threshold rules are *edge-triggered*: they fire on the
  crossing and re-arm only after a sample back inside the band, so a
  saturated gauge pages once, not per event.

Metric families: ``verifyd_alerts_sent_total`` /
``verifyd_alerts_failed_total`` / ``verifyd_alerts_suppressed_total``
(all by rule) and the ``verifyd_alert_delivery_seconds`` histogram.
Fired alerts land in the flight ring as ``{"k": "alert"}`` records and
exhausted deliveries as ``alert_failed`` dump markers, so the doctor can
report both cold.
"""

from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, List, Optional, Tuple

from .metrics import LATENCY_BUCKETS, MetricsRegistry

if TYPE_CHECKING:  # pragma: no cover
    from .flight import FlightRecorder

__all__ = ["AlertEngine", "AlertRule", "builtin_rules", "parse_rule"]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

#: 4xx statuses worth retrying (timeout / throttle); every other 4xx is
#: a definite refusal of this payload.
_RETRYABLE_4XX = (408, 429)


@dataclass(frozen=True)
class AlertRule:
    """One compiled rule.  ``kind`` is ``event`` (fire on occurrence),
    ``field`` (event-field threshold) or ``metric`` (registry value
    threshold, checked whenever any event arrives)."""

    name: str  #: the spec string; doubles as the alertname label
    kind: str
    event: str = ""
    field: str = ""
    metric: str = ""
    op: str = ">"
    threshold: float = 0.0
    severity: str = "page"

    def describe(self) -> str:
        if self.kind == "event":
            return f"event {self.event}"
        if self.kind == "field":
            return f"{self.event}.{self.field} {self.op} {self.threshold:g}"
        return f"metric {self.metric} {self.op} {self.threshold:g}"


def _split_threshold(expr: str) -> Tuple[str, str, float]:
    """``"name>=5"`` → (name, op, 5.0); longest operator wins."""
    for op in (">=", "<=", ">", "<"):
        if op in expr:
            lhs, rhs = expr.split(op, 1)
            lhs, rhs = lhs.strip(), rhs.strip()
            if not lhs or not rhs:
                break
            try:
                return lhs, op, float(rhs)
            except ValueError:
                break
    raise ValueError(f"bad alert threshold expression: {expr!r}")


def parse_rule(spec: str) -> AlertRule:
    """Compile one ``--alert-rule`` spec; raises ValueError on nonsense."""
    spec = spec.strip()
    if not spec:
        raise ValueError("empty alert rule")
    if spec.startswith("metric:"):
        name, op, thr = _split_threshold(spec[len("metric:") :])
        return AlertRule(
            name=spec, kind="metric", metric=name, op=op, threshold=thr,
            severity="warn",
        )
    if any(op in spec for op in _OPS):
        lhs, op, thr = _split_threshold(spec)
        if "." not in lhs:
            raise ValueError(
                f"field rule needs EVENT.FIELD on the left: {spec!r}"
            )
        event, fname = lhs.split(".", 1)
        if not event or not fname:
            raise ValueError(f"field rule needs EVENT.FIELD: {spec!r}")
        return AlertRule(
            name=spec, kind="field", event=event, field=fname, op=op,
            threshold=thr, severity="warn",
        )
    if not spec.replace("_", "").isalnum():
        raise ValueError(f"bad event name in alert rule: {spec!r}")
    return AlertRule(name=spec, kind="event", event=spec)


def builtin_rules() -> Tuple[AlertRule, ...]:
    """The signals every deployment should page on: SLO burn, perf
    regressions, retrace storms, a poison job entering quarantine, a
    durable writer degrading (journal on a full disk), and the soak loop
    catching the checker contradicting a ground-truth label."""
    return (
        AlertRule(name="slo_breach", kind="event", event="slo_breach"),
        AlertRule(name="perf_regression", kind="event", event="perf_regression"),
        AlertRule(name="retrace_storm", kind="event", event="retrace_storm"),
        AlertRule(name="job_quarantined", kind="event", event="job_quarantined"),
        AlertRule(name="writer_degraded", kind="event", event="writer_degraded"),
        AlertRule(
            name="checker_false_verdict",
            kind="event",
            event="checker_false_verdict",
        ),
    )


@dataclass
class _RuleState:
    armed: bool = True  #: threshold rules: re-armed by an in-band sample
    last_fired: Optional[float] = None
    fired: int = 0
    suppressed: int = 0


def _rfc3339(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


class AlertEngine:
    """Matches the ServiceStats stream against rules and delivers webhooks.

    ``observe_event`` (the hot path) only does rule matching and a deque
    append; all HTTP happens on the drain thread.  ``time_fn`` /
    ``sleep_fn`` / ``rng`` are injectable so tests cover backoff and
    dedup without real clocks.
    """

    def __init__(
        self,
        url: str,
        rules: Iterable[AlertRule] = (),
        *,
        registry: Optional[MetricsRegistry] = None,
        recorder: "Optional[FlightRecorder]" = None,
        retries: int = 4,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        dedup_s: float = 300.0,
        timeout_s: float = 5.0,
        queue_cap: int = 256,
        time_fn: Callable[[], float] = time.time,
        sleep_fn: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.url = url
        self.rules: Tuple[AlertRule, ...] = tuple(rules) or builtin_rules()
        self.recorder = recorder
        self.registry = registry if registry is not None else MetricsRegistry()
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.dedup_s = dedup_s
        self.timeout_s = timeout_s
        self.queue_cap = queue_cap
        self._time = time_fn
        self._sleep = sleep_fn
        self._rng = rng if rng is not None else random.Random()

        r = self.registry
        self._m_sent = r.counter(
            "verifyd_alerts_sent_total",
            "Alert webhooks delivered (2xx)",
            labelnames=("rule",),
        )
        self._m_failed = r.counter(
            "verifyd_alerts_failed_total",
            "Alert deliveries abandoned after retries (or queue overflow)",
            labelnames=("rule",),
        )
        self._m_suppressed = r.counter(
            "verifyd_alerts_suppressed_total",
            "Alerts swallowed by the per-rule dedup window",
            labelnames=("rule",),
        )
        self._m_latency = r.histogram(
            "verifyd_alert_delivery_seconds",
            "Wall time from firing to 2xx, retries included",
            buckets=LATENCY_BUCKETS,
        )

        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._state: Dict[str, _RuleState] = {
            rule.name: _RuleState() for rule in self.rules
        }
        self._inflight = 0
        self._closed = False
        self._worker = threading.Thread(
            target=self._drain, name="verifyd-alerts", daemon=True
        )
        self._worker.start()

    # -- hot path: rule matching --------------------------------------------

    def observe_event(self, ev: Dict[str, Any]) -> None:
        """Feed one event line; fired rules enqueue for async delivery."""
        name = ev.get("ev") or ev.get("event")
        if not name:
            return
        now = self._time()
        for rule in self.rules:
            if self._matches(rule, name, ev):
                self._fire(rule, name, ev, now)

    def _matches(self, rule: AlertRule, name: str, ev: Dict[str, Any]) -> bool:
        state = self._state[rule.name]
        if rule.kind == "event":
            return name == rule.event
        if rule.kind == "field":
            if name != rule.event or rule.field not in ev:
                return False
            try:
                value = float(ev[rule.field])
            except (TypeError, ValueError):
                return False
        else:  # metric
            value = self._metric_value(rule.metric)
            if value is None:
                return False
        crossed = _OPS[rule.op](value, rule.threshold)
        if not crossed:
            state.armed = True  # back in band: re-arm
            return False
        if not state.armed:
            return False  # still over threshold since the last firing
        state.armed = False
        return True

    def _metric_value(self, name: str) -> Optional[float]:
        metric = self.registry.get(name)
        if metric is None or not hasattr(metric, "value"):
            return None
        try:
            if not getattr(metric, "labelnames", ()):
                return float(metric.value())
            # Labeled counter/gauge: threshold the sum over all series.
            return float(sum(metric.snapshot().values()))
        except (TypeError, ValueError, AttributeError):
            return None

    def _fire(
        self, rule: AlertRule, event: str, ev: Dict[str, Any], now: float
    ) -> None:
        state = self._state[rule.name]
        if state.last_fired is not None and now - state.last_fired < self.dedup_s:
            state.suppressed += 1
            self._m_suppressed.inc(rule=rule.name)
            return
        state.last_fired = now
        state.fired += 1
        if self.recorder is not None:
            self.recorder.record_alert(
                {"rule": rule.name, "event": event, "severity": rule.severity}
            )
        alert = {"rule": rule, "event": event, "ev": dict(ev), "t": now}
        with self._cv:
            if self._closed:
                return
            if len(self._queue) >= self.queue_cap:
                # Shed the oldest undelivered alert, accounted as failed:
                # recency wins when the endpoint is this far behind.
                dropped = self._queue.popleft()
                self._m_failed.inc(rule=dropped["rule"].name)
            self._queue.append(alert)
            self._cv.notify()

    # -- delivery thread ----------------------------------------------------

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(timeout=0.5)
                if not self._queue:
                    if self._closed:
                        return
                    continue
                alert = self._queue.popleft()
                self._inflight += 1
            try:
                self._deliver(alert)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _payload(self, alert: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Alertmanager v1 shape: a JSON list of alert objects."""
        rule: AlertRule = alert["rule"]
        ev = alert["ev"]
        labels = {
            "alertname": rule.name,
            "service": "verifyd",
            "severity": rule.severity,
            "event": alert["event"],
        }
        for key in ("shape", "backend", "client"):
            if ev.get(key) is not None:
                labels[key] = str(ev[key])
        # Drop bulky nested payloads (profiles, SLO snapshots) from the
        # annotation; the flight ring keeps the full record.
        detail = {
            k: v for k, v in ev.items() if not isinstance(v, (dict, list))
        }
        return [
            {
                "labels": labels,
                "annotations": {
                    "summary": f"verifyd {alert['event']}: {rule.describe()}",
                    "detail": json.dumps(detail, sort_keys=True, default=str),
                },
                "startsAt": _rfc3339(alert["t"]),
                "generatorURL": f"verifyd://{os.uname().nodename}/{os.getpid()}",
            }
        ]

    def _post_once(self, body: bytes) -> Tuple[bool, bool, str]:
        """One POST → (delivered, retryable, error-detail)."""
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                resp.read()
                return True, False, ""
        except urllib.error.HTTPError as e:
            retryable = e.code >= 500 or e.code in _RETRYABLE_4XX
            return False, retryable, f"HTTP {e.code}"
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            return False, True, str(e)

    def _deliver(self, alert: Dict[str, Any]) -> None:
        rule: AlertRule = alert["rule"]
        body = json.dumps(self._payload(alert), default=str).encode("utf-8")
        t0 = self._time()
        error = ""
        attempts = 0
        for attempt in range(self.retries + 1):
            attempts = attempt + 1
            delivered, retryable, error = self._post_once(body)
            if delivered:
                self._m_sent.inc(rule=rule.name)
                self._m_latency.observe(max(0.0, self._time() - t0))
                return
            if not retryable:
                break
            if attempt < self.retries:
                # Exponential backoff with full jitter, capped.
                cap = min(self.max_backoff_s, self.backoff_s * (2**attempt))
                self._sleep(self._rng.uniform(0.0, cap))
        self._m_failed.inc(rule=rule.name)
        if self.recorder is not None:
            self.recorder.dump(
                "alert_failed",
                rule=rule.name,
                url=self.url,
                error=error,
                attempts=attempts,
            )

    # -- lifecycle / introspection ------------------------------------------

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until the queue drains (tests, shutdown); False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
        return True

    def close(self, timeout: float = 5.0) -> None:
        self.flush(timeout=timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=2.0)

    def snapshot(self) -> Dict[str, Any]:
        with self._cv:
            pending = len(self._queue) + self._inflight
        return {
            "url": self.url,
            "dedup_s": self.dedup_s,
            "pending": pending,
            "rules": {
                rule.name: {
                    "kind": rule.kind,
                    "fired": self._state[rule.name].fired,
                    "suppressed": self._state[rule.name].suppressed,
                    "armed": self._state[rule.name].armed,
                }
                for rule in self.rules
            },
        }
