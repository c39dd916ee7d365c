"""SLO health engine: rolling availability, latency quantiles, burn rates.

Consumes the single ServiceStats event stream (``done`` / ``cache_hit``
are good requests, ``job_error`` / ``reject`` are bad) and maintains
per-second buckets merged on demand into rolling windows (1m/5m/30m by
default).  From each window it derives:

- **availability** — good / (good + bad);
- **latency quantiles** — p50/p95/p99 estimated from the fixed
  ``LATENCY_BUCKETS`` histogram by linear interpolation within the
  bucket (the classic Prometheus ``histogram_quantile``), over
  end-to-end job wall (queue wait + execution);
- **error-budget burn rate** — ``error_rate / (1 - target)``: how many
  times faster than sustainable the budget is being spent.  Burn 1.0
  exactly exhausts a 30-day budget in 30 days; the standard
  multiwindow alerting pair is a *fast* burn (~14.4 on the short
  window: budget gone in ~2 days) and a *slow* burn (~6 on the long
  window: gone in ~5 days).

The engine is passive — no threads.  ``observe_event`` is fed by
ServiceStats (outside its sink lock), and readers (``/healthz``,
``/slo``, the ``stats`` op, gauge refresh before each ``/metrics``
scrape) recompute windows on demand.  Breach detection is
edge-triggered: ``check_breach`` reports a burn trip only on the
not-breached → breached transition, which is what gates the
``slo_breach`` ServiceStats event and the flight-recorder dump.

Everything is stdlib-only and injectable-clock (``time_fn``) so the
window math is testable on a synthetic stream without sleeping.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .metrics import LATENCY_BUCKETS, MetricsRegistry

__all__ = ["SLOConfig", "SLOHealth"]

#: events that count as a served request, successfully
_GOOD_EVENTS = ("done", "cache_hit")
#: events that count as a served request, failed (burns budget)
_BAD_EVENTS = ("job_error", "reject")


@dataclass(frozen=True)
class SLOConfig:
    """Targets + window geometry for the health engine."""

    availability_target: float = 0.99
    latency_target_s: float = 5.0
    latency_quantile: float = 0.95
    #: rolling windows in seconds, shortest first
    windows: Tuple[int, ...] = (60, 300, 1800)
    quantiles: Tuple[float, ...] = (0.5, 0.95, 0.99)
    #: burn-rate trip levels: fast on windows[0], slow on windows[-1]
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 6.0
    #: a window with fewer total events than this never trips (cold-start
    #: guard: one early failure must not read as burn 100)
    min_events: int = 10


_WINDOW_NAMES = {60: "1m", 300: "5m", 1800: "30m"}


def window_name(seconds: int) -> str:
    return _WINDOW_NAMES.get(seconds, "%ds" % seconds)


@dataclass
class _Bucket:
    """One second of aggregated events."""

    ok: int = 0
    err: int = 0
    lat: List[int] = field(default_factory=lambda: [0] * (len(LATENCY_BUCKETS) + 1))


def _quantile_from_buckets(counts: List[int], q: float) -> Optional[float]:
    """Estimate a quantile from cumulative-less bucket counts by linear
    interpolation inside the owning bucket (the +Inf bucket answers with
    the largest finite boundary — the estimate saturates, as Prometheus's
    does)."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    seen = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if seen + c >= rank:
            if i >= len(LATENCY_BUCKETS):
                return LATENCY_BUCKETS[-1]
            lo = LATENCY_BUCKETS[i - 1] if i > 0 else 0.0
            hi = LATENCY_BUCKETS[i]
            frac = (rank - seen) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += c
    return LATENCY_BUCKETS[-1]


class SLOHealth:
    """Rolling multi-window SLO state over the ServiceStats event stream."""

    def __init__(
        self,
        config: Optional[SLOConfig] = None,
        *,
        registry: Optional[MetricsRegistry] = None,
        time_fn: Callable[[], float] = time.time,
    ) -> None:
        self.config = config or SLOConfig()
        self._time = time_fn
        self._lock = threading.Lock()
        self._buckets: Dict[int, _Bucket] = {}
        self._horizon = max(self.config.windows) + 2
        self._breached = False
        self._last_breach: Optional[Dict[str, Any]] = None
        self._breach_count = 0
        #: operational degradations reported from outside the SLO math
        #: (e.g. a journal writer on a full disk): key → detail dict.
        #: Any entry forces /healthz to degraded with a "degraded" reason.
        self._degraded_reasons: Dict[str, Dict[str, Any]] = {}
        self._m_avail = self._m_burn = self._m_lat = None
        self._m_healthy = self._m_breaches = None
        if registry is not None:
            self._m_avail = registry.gauge(
                "verifyd_slo_availability",
                "Rolling availability (good/(good+bad)) per window.",
                labelnames=("window",),
            )
            self._m_burn = registry.gauge(
                "verifyd_slo_burn_rate",
                "Error-budget burn rate (error_rate/(1-target)) per window.",
                labelnames=("window",),
            )
            self._m_lat = registry.gauge(
                "verifyd_slo_latency_seconds",
                "Rolling end-to-end latency quantiles per window.",
                labelnames=("window", "quantile"),
            )
            self._m_healthy = registry.gauge(
                "verifyd_slo_healthy",
                "1 when within SLO, 0 when degraded (mirrors /healthz).",
            )
            self._m_breaches = registry.counter(
                "verifyd_slo_breaches_total",
                "Edge-triggered SLO burn-rate breaches.",
            )
            self._m_healthy.set(1)
            self._m_breaches.inc(0)

    # ------------------------------------------------------------- ingest

    def observe_event(self, ev: Dict[str, Any]) -> None:
        """Feed one ServiceStats event line (already-serialized dict).

        Only request-outcome events count; everything else — including
        ``slo_breach`` itself, which would otherwise feed back — is
        ignored.  The event's own ``t`` field wins over the engine clock
        so post-mortem replay (doctor) reconstructs the same windows.
        """
        # ServiceStats lines carry the name under "ev"; synthetic test
        # streams may use "event" — accept both.
        name = ev.get("ev") or ev.get("event")
        if name in _GOOD_EVENTS:
            ok, err = 1, 0
        elif name in _BAD_EVENTS:
            ok, err = 0, 1
        else:
            return
        try:
            t = float(ev.get("t", self._time()))
        except (TypeError, ValueError):
            t = self._time()
        latency = None
        if ok:
            try:
                latency = float(ev.get("wall_s", 0.0)) + float(
                    ev.get("queue_wait_s", 0.0)
                )
            except (TypeError, ValueError):
                latency = None
        sec = int(t)
        with self._lock:
            b = self._buckets.get(sec)
            if b is None:
                b = self._buckets[sec] = _Bucket()
                self._gc_locked(sec)
            b.ok += ok
            b.err += err
            if latency is not None:
                b.lat[self._lat_index(latency)] += 1

    @staticmethod
    def _lat_index(latency: float) -> int:
        for i, edge in enumerate(LATENCY_BUCKETS):
            if latency <= edge:
                return i
        return len(LATENCY_BUCKETS)

    def _gc_locked(self, now_sec: int) -> None:
        if len(self._buckets) <= self._horizon:
            return
        cutoff = now_sec - self._horizon
        for sec in [s for s in self._buckets if s < cutoff]:
            del self._buckets[sec]

    # ------------------------------------------------------------ windows

    def _window_locked(self, seconds: int, now: float) -> Tuple[int, int, List[int]]:
        lo = int(now) - seconds
        hi = int(now)
        ok = err = 0
        lat = [0] * (len(LATENCY_BUCKETS) + 1)
        for sec, b in self._buckets.items():
            if lo < sec <= hi:
                ok += b.ok
                err += b.err
                for i, c in enumerate(b.lat):
                    lat[i] += c
        return ok, err, lat

    def snapshot(self) -> Dict[str, Any]:
        """Full SLO picture: per-window availability/burn/quantiles plus
        the health verdict.  Shape is shared by ``/slo``, the ``stats``
        op ``slo`` section, and the flight recorder."""
        cfg = self.config
        now = self._time()
        windows: Dict[str, Any] = {}
        with self._lock:
            for w in cfg.windows:
                ok, err, lat = self._window_locked(w, now)
                total = ok + err
                avail = (ok / total) if total else 1.0
                burn = (
                    ((err / total) / (1.0 - cfg.availability_target))
                    if total and cfg.availability_target < 1.0
                    else 0.0
                )
                quantiles = {
                    ("p%g" % (q * 100)): _quantile_from_buckets(lat, q)
                    for q in cfg.quantiles
                }
                windows[window_name(w)] = {
                    "seconds": w,
                    "good": ok,
                    "bad": err,
                    "availability": round(avail, 6),
                    "burn_rate": round(burn, 4),
                    "latency": {
                        k: (round(v, 6) if v is not None else None)
                        for k, v in quantiles.items()
                    },
                }
            breached = self._breached
            last_breach = self._last_breach
            breach_count = self._breach_count
            degraded = {k: dict(v) for k, v in self._degraded_reasons.items()}
        healthy, reasons = self._verdict(windows)
        for key, detail in sorted(degraded.items()):
            reasons.append({"kind": "degraded", "what": key, **detail})
            healthy = False
        return {
            "healthy": healthy,
            "reasons": reasons,
            "availability_target": cfg.availability_target,
            "latency_target_s": cfg.latency_target_s,
            "windows": windows,
            "breached": breached,
            "breaches": breach_count,
            "last_breach": last_breach,
        }

    def _verdict(self, windows: Dict[str, Any]) -> Tuple[bool, List[Dict[str, Any]]]:
        """Degraded when a burn threshold trips (with enough events) or the
        target latency quantile blows through its target on the short
        window."""
        cfg = self.config
        reasons: List[Dict[str, Any]] = []
        checks = (
            (window_name(cfg.windows[0]), cfg.fast_burn_threshold, "fast_burn"),
            (window_name(cfg.windows[-1]), cfg.slow_burn_threshold, "slow_burn"),
        )
        for wname, threshold, kind in checks:
            w = windows.get(wname)
            if not w or (w["good"] + w["bad"]) < cfg.min_events:
                continue
            if w["burn_rate"] >= threshold:
                reasons.append(
                    {
                        "kind": kind,
                        "window": wname,
                        "burn_rate": w["burn_rate"],
                        "threshold": threshold,
                        "availability": w["availability"],
                    }
                )
        short = windows.get(window_name(cfg.windows[0]))
        if short and (short["good"] + short["bad"]) >= cfg.min_events:
            qkey = "p%g" % (cfg.latency_quantile * 100)
            lat = short["latency"].get(qkey)
            if lat is not None and lat > cfg.latency_target_s:
                reasons.append(
                    {
                        "kind": "latency",
                        "window": window_name(cfg.windows[0]),
                        "quantile": qkey,
                        "latency_s": lat,
                        "target_s": cfg.latency_target_s,
                    }
                )
        return (not reasons), reasons

    # ------------------------------------------------------------ surface

    def set_degraded(self, key: str, **detail: Any) -> None:
        """Mark an operational degradation (journal on a full disk, …):
        /healthz answers 503 with a ``degraded`` reason naming ``key``
        until :meth:`clear_degraded` re-arms it."""
        with self._lock:
            self._degraded_reasons[key] = dict(detail)

    def clear_degraded(self, key: str) -> None:
        with self._lock:
            self._degraded_reasons.pop(key, None)

    def healthz(self) -> Tuple[bool, Dict[str, Any]]:
        """The /healthz verdict: (healthy, body).  Body is small and
        machine-readable either way — a degraded 503 carries reasons."""
        snap = self.snapshot()
        body = {
            "status": "ok" if snap["healthy"] else "degraded",
            "reasons": snap["reasons"],
            "breaches": snap["breaches"],
        }
        return snap["healthy"], body

    def check_breach(self) -> Optional[Dict[str, Any]]:
        """Edge-triggered breach detection.

        Returns a breach description exactly once per not-breached →
        breached transition (None otherwise); recovery re-arms it.  The
        caller (ServiceStats) turns the description into an
        ``slo_breach`` event + flight-recorder dump.
        """
        snap = self.snapshot()
        burning = [r for r in snap["reasons"] if r["kind"].endswith("_burn")]
        with self._lock:
            if burning and not self._breached:
                self._breached = True
                self._breach_count += 1
                breach = {
                    "reasons": burning,
                    "availability": {
                        k: w["availability"] for k, w in snap["windows"].items()
                    },
                }
                self._last_breach = breach
                if self._m_breaches is not None:
                    self._m_breaches.inc()
                return breach
            if not burning and self._breached:
                self._breached = False
            return None

    def refresh(self) -> Dict[str, Any]:
        """Recompute windows and push them into the metric gauges (called
        before each /metrics render so scrapes are never stale).  Returns
        the snapshot so callers can reuse it."""
        snap = self.snapshot()
        if self._m_avail is not None:
            for wname, w in snap["windows"].items():
                self._m_avail.set(w["availability"], window=wname)
                self._m_burn.set(w["burn_rate"], window=wname)
                for qkey, v in w["latency"].items():
                    if v is not None:
                        self._m_lat.set(v, window=wname, quantile=qkey)
            self._m_healthy.set(1 if snap["healthy"] else 0)
        return snap
