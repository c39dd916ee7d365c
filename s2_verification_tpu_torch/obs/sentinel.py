"""Perf-regression sentinel: rolling per-shape EWMA baselines that page.

BENCH json lines and BASELINE.json catch regressions *between releases*;
nothing watched the live daemon drift *within* one.  The sentinel rides
the same ServiceStats event stream as every other obs consumer and
keeps, per ``shape_key``, an exponentially-weighted moving average of
verification wall time plus a completion-rate EWMA (from done-event
inter-arrival gaps).  When a shape's wall time sits above its own
baseline by more than the configured band for ``consecutive`` jobs in a
row, the sentinel reports a regression; ServiceStats re-emits it as a
``perf_regression`` event on the stream — which the
:class:`~.alerts.AlertEngine` routes by default, the flight ring
records, and ``verifyd_perf_regressions_total`` counts.

Tuning rationale:

- **cold start**: the first ``min_samples`` jobs per shape only build
  the baseline (the first job of a shape legitimately pays its builds);
- **consecutive filter**: one GC pause or noisy-neighbor blip is not a
  regression — the band must hold for several jobs running;
- **contaminated baseline**: out-of-band samples still fold in, but at
  ``alpha/8`` — a genuine persistent shift re-baselines over time
  instead of paging forever, while a transient spike barely moves it;
- **re-arm**: a sample back inside the band resets the streak and
  re-arms the shape, so recovery → regression pages again (edge
  triggering, same discipline as the SLO breach and alert rules);
- **floor**: sub-``floor_s`` walls are scheduler-noise dominated on a
  warm shape and never judged.

Exposed via ``GET /sentinel`` on the obs httpd and the ``stats`` op's
``sentinel`` section.  The port's copy of the JAX package's
``obs/sentinel.py``.  :func:`seed_from_telemetry` re-seeds the baselines across a restart from
the telemetry store (``obs/tsdb.py``); the daemon calls it only with one.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from .metrics import MetricsRegistry

__all__ = ["PerfSentinel", "SentinelConfig", "ewma_drift", "seed_from_telemetry"]


@dataclass(frozen=True)
class SentinelConfig:
    alpha: float = 0.25  #: EWMA weight of the newest in-band sample
    band: float = 0.75  #: fire when wall > baseline * (1 + band)
    min_samples: int = 8  #: per-shape cold-start guard
    consecutive: int = 3  #: out-of-band jobs in a row before firing
    floor_s: float = 0.005  #: walls under this are noise, never judged


def ewma_drift(value: float, baseline: float, band: float) -> bool:
    """The one drift predicate, shared with scripts/perf_watch.py."""
    return value > baseline * (1.0 + band)


class _ShapeState:
    __slots__ = (
        "n",
        "ewma_wall",
        "ewma_rate",
        "last_t",
        "last_wall",
        "streak",
        "fired",
        "regressions",
    )

    def __init__(self) -> None:
        self.n = 0
        self.ewma_wall: Optional[float] = None
        self.ewma_rate: Optional[float] = None
        self.last_t: Optional[float] = None
        self.last_wall = 0.0
        self.streak = 0
        self.fired = False
        self.regressions = 0


class PerfSentinel:
    """Per-shape EWMA drift detector over done events."""

    def __init__(
        self,
        config: Optional[SentinelConfig] = None,
        *,
        registry: Optional[MetricsRegistry] = None,
        time_fn: Callable[[], float] = time.time,
    ) -> None:
        self.config = config if config is not None else SentinelConfig()
        self.registry = registry if registry is not None else MetricsRegistry()
        self._time = time_fn
        self._lock = threading.Lock()
        self._shapes: Dict[str, _ShapeState] = {}
        self._m_regressions = self.registry.counter(
            "verifyd_perf_regressions_total",
            "Sentinel wall-time drift trips, by shape",
            labelnames=("shape",),
        )
        self._m_baseline = self.registry.gauge(
            "verifyd_perf_baseline_wall_seconds",
            "Sentinel EWMA wall-time baseline, by shape",
            labelnames=("shape",),
        )
        # Latch state as a gauge so the telemetry store carries it across
        # restarts: a shape that was paging when the process died must not
        # re-page on the first post-boot sample (seed() restores it).
        self._m_fired = self.registry.gauge(
            "verifyd_perf_regression_fired",
            "Sentinel regression latch, by shape (1 = latched)",
            labelnames=("shape",),
        )

    # -- stream side ---------------------------------------------------------

    def observe_event(self, ev: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Feed one event line; a regression report means the caller
        (ServiceStats) should emit ``perf_regression`` with it."""
        name = ev.get("ev") or ev.get("event")
        if name != "done":
            return None
        shape = ev.get("shape")
        try:
            wall = float(ev.get("wall_s"))
        except (TypeError, ValueError):
            return None
        if not isinstance(shape, str) or not shape:
            return None
        return self.observe(shape, wall, t=ev.get("t"))

    def observe(
        self, shape: str, wall_s: float, t: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        """Core fold, directly unit-testable without event plumbing."""
        cfg = self.config
        now = float(t) if t is not None else self._time()
        with self._lock:
            st = self._shapes.setdefault(shape, _ShapeState())
            st.n += 1
            st.last_wall = wall_s
            if st.last_t is not None and now > st.last_t:
                rate = 1.0 / (now - st.last_t)
                st.ewma_rate = (
                    rate
                    if st.ewma_rate is None
                    else (1 - cfg.alpha) * st.ewma_rate + cfg.alpha * rate
                )
            st.last_t = now

            if st.ewma_wall is None:
                st.ewma_wall = wall_s
                self._m_baseline.set(st.ewma_wall, shape=shape)
                # padding-bucketed like the baseline gauge above
                self._m_fired.set(0.0, shape=shape)  # verifylint: disable=metric-open-label
                return None
            baseline = st.ewma_wall
            judged = (
                st.n > cfg.min_samples
                and wall_s > cfg.floor_s
                and ewma_drift(wall_s, baseline, cfg.band)
            )
            if judged:
                # Out of band: barely move the baseline so a transient
                # spike can't poison it, but a persistent shift still
                # re-baselines eventually.
                st.ewma_wall = (
                    1 - cfg.alpha / 8
                ) * baseline + cfg.alpha / 8 * wall_s
                st.streak += 1
                fire = st.streak >= cfg.consecutive and not st.fired
                if fire:
                    st.fired = True
                    st.regressions += 1
            else:
                st.ewma_wall = (1 - cfg.alpha) * baseline + cfg.alpha * wall_s
                st.streak = 0
                st.fired = False  # recovery re-arms the shape
                fire = False
            self._m_baseline.set(st.ewma_wall, shape=shape)
            # padding-bucketed like the baseline gauge above
            self._m_fired.set(1.0 if st.fired else 0.0, shape=shape)  # verifylint: disable=metric-open-label
            if not fire:
                return None
            self._m_regressions.inc(shape=shape)
            report = {
                "shape": shape,
                "wall_s": round(wall_s, 6),
                "baseline_wall_s": round(baseline, 6),
                "ratio": round(wall_s / baseline, 3) if baseline > 0 else 0.0,
                "band": cfg.band,
                "streak": st.streak,
                "samples": st.n,
            }
            if st.ewma_rate is not None:
                report["jobs_per_sec_ewma"] = round(st.ewma_rate, 3)
            return report

    def seed(self, shape: str, wall_s: float, *, fired: bool = False) -> bool:
        """Restore one shape's baseline from durable history at boot.

        Marks the shape warm (``n = min_samples + 1``): the whole point of
        seeding is that a post-restart slowdown is judged against the
        *pre*-restart baseline immediately, not after a fresh cold start.
        A latched shape stays latched (no re-page on the first sample);
        an in-band sample re-arms it exactly as it would have live.  Live
        samples outrank history: a shape that has already observed real
        traffic this boot is never overwritten.
        """
        cfg = self.config
        if not isinstance(shape, str) or not shape:
            return False
        try:
            wall = float(wall_s)
        except (TypeError, ValueError):
            return False
        if not wall > 0.0:  # rejects zero, negatives, and NaN
            return False
        with self._lock:
            st = self._shapes.get(shape)
            if st is not None and st.n > 0:
                return False
            st = self._shapes.setdefault(shape, _ShapeState())
            st.ewma_wall = wall
            st.n = cfg.min_samples + 1
            st.fired = bool(fired)
            st.streak = cfg.consecutive if st.fired else 0
            # padding-bucketed like the live observe() path
            self._m_baseline.set(wall, shape=shape)  # verifylint: disable=metric-open-label
            self._m_fired.set(1.0 if st.fired else 0.0, shape=shape)  # verifylint: disable=metric-open-label
        return True

    # -- read side ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        cfg = self.config
        with self._lock:
            shapes = {
                shape: {
                    "samples": st.n,
                    "baseline_wall_s": (
                        round(st.ewma_wall, 6) if st.ewma_wall is not None else None
                    ),
                    "last_wall_s": round(st.last_wall, 6),
                    "jobs_per_sec_ewma": (
                        round(st.ewma_rate, 3) if st.ewma_rate is not None else None
                    ),
                    "streak": st.streak,
                    "fired": st.fired,
                    "regressions": st.regressions,
                }
                for shape, st in self._shapes.items()
            }
            total = sum(st.regressions for st in self._shapes.values())
        return {
            "config": {
                "alpha": cfg.alpha,
                "band": cfg.band,
                "min_samples": cfg.min_samples,
                "consecutive": cfg.consecutive,
                "floor_s": cfg.floor_s,
            },
            "regressions": total,
            "shapes": shapes,
        }


def seed_from_telemetry(
    sentinel: PerfSentinel, values: Dict[str, float]
) -> int:
    """Seed baselines + latch state from a flattened telemetry snapshot
    (``obs.tsdb.last_values`` / ``TelemetryStore.boot_values``).  Returns
    how many shapes were restored — the ``telemetry_loaded`` event
    reports it."""
    from .tsdb import parse_series_key

    baselines: Dict[str, float] = {}
    latched: Dict[str, bool] = {}
    for key, value in values.items():
        name, labels = parse_series_key(key)
        shape = labels.get("shape")
        if not shape:
            continue
        if name == "verifyd_perf_baseline_wall_seconds":
            baselines[shape] = value
        elif name == "verifyd_perf_regression_fired":
            latched[shape] = value >= 0.5
    seeded = 0
    for shape, wall in sorted(baselines.items()):
        if sentinel.seed(shape, wall, fired=latched.get(shape, False)):
            seeded += 1
    return seeded
