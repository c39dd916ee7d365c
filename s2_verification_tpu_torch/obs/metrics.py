"""Counter / gauge / histogram registry with Prometheus text exposition.

The port's own copy of the JAX package's ``obs/metrics.py`` (plain Python,
unchanged in behaviour).

Stdlib-only reimplementation of the minimal prometheus_client surface the
daemon needs.  Metrics are created once through the registry (idempotent
per name) and updated from any thread; ``render()`` produces text
exposition format 0.0.4, which Prometheus, VictoriaMetrics, and the
Grafana Agent all scrape natively.

Histograms use *fixed* buckets chosen at creation: cumulative ``le``
bucket semantics (observe(v) lands in every bucket with v <= le, and
``+Inf`` always equals ``_count``), matching the official client so
``histogram_quantile()`` works unmodified in Grafana.

Histogram observations may carry an **exemplar** (the owning request's
``trace_id``): the registry keeps the last exemplar per bucket and
renders it in OpenMetrics exemplar syntax via ``render_openmetrics()``
(served under content negotiation — classic 0.0.4 parsers never see the
``# {...}`` suffix, OpenMetrics scrapers get a bucket→trace link).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS",
    "LAYER_BUCKETS",
    "OPENMETRICS_CONTENT_TYPE",
]

#: the content type negotiated for ``render_openmetrics()`` output
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)

#: Wall/queue latency buckets: sub-ms admission up to the 60s budget ceiling.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: Frontier-depth buckets: BFS layer counts are small integers, power-of-2.
LAYER_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _labelstr(names: Sequence[str], values: Sequence[str], extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def header(self) -> List[str]:
        return [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]

    def render_om(self) -> List[str]:
        """OpenMetrics lines for this metric; the default matches the
        classic exposition (gauges are identical in both syntaxes)."""
        return self.render()  # type: ignore[attr-defined]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0)

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            for key in sorted(self._series):
                out.append(
                    f"{self.name}{_labelstr(self.labelnames, key)} "
                    f"{_fmt(self._series[key])}"
                )
        return out

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                self.name + _labelstr(self.labelnames, k): v
                for k, v in self._series.items()
            }

    def render_om(self) -> List[str]:
        # OpenMetrics names the *family* without the _total suffix; the
        # samples keep it.  A counter not named *_total renders samples
        # under <family>_total so scrapers still parse the family.
        family = (
            self.name[: -len("_total")]
            if self.name.endswith("_total")
            else self.name
        )
        out = [
            f"# HELP {family} {_escape_help(self.help)}",
            f"# TYPE {family} counter",
        ]
        with self._lock:
            for key in sorted(self._series):
                out.append(
                    f"{family}_total{_labelstr(self.labelnames, key)} "
                    f"{_fmt(self._series[key])}"
                )
        return out


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = value

    def inc(self, amount: float = 1, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def dec(self, amount: float = 1, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0)

    render = Counter.render
    snapshot = Counter.snapshot


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        buckets: Sequence[float] = LATENCY_BUCKETS,
        labelnames: Sequence[str] = (),
    ) -> None:
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.buckets: Tuple[float, ...] = tuple(bs)

    def observe(
        self, value: float, exemplar: Optional[str] = None, **labels: str
    ) -> None:
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                # [per-bucket counts, sum, count, {bucket_idx: exemplar}];
                # indices 0-2 are load-bearing for counts()/render().
                series = self._series[key] = [
                    [0] * len(self.buckets),
                    0.0,
                    0,
                    {},
                ]
            idx = bisect_left(self.buckets, value)
            if idx < len(self.buckets):
                series[0][idx] += 1
            series[1] += value
            series[2] += 1
            if exemplar:
                # Last exemplar per bucket (+Inf = len(buckets)): one
                # concrete trace_id behind each latency bucket.
                series[3][idx] = (str(exemplar), float(value), time.time())

    def counts(self, **labels: str) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count) for one series."""
        with self._lock:
            series = self._series.get(self._key(labels))
            if series is None:
                return [0] * (len(self.buckets) + 1), 0.0, 0
            cum, acc = [], 0
            for c in series[0]:
                acc += c
                cum.append(acc)
            cum.append(series[2])
            return cum, series[1], series[2]

    def render(self) -> List[str]:
        out = self.header()
        with self._lock:
            for key in sorted(self._series):
                raw, total, count = self._series[key][:3]
                acc = 0
                for le, c in zip(self.buckets, raw):
                    acc += c
                    extra = 'le="%s"' % _fmt(le)
                    out.append(
                        f"{self.name}_bucket"
                        f"{_labelstr(self.labelnames, key, extra)} {acc}"
                    )
                inf = 'le="+Inf"'
                out.append(
                    f"{self.name}_bucket"
                    f"{_labelstr(self.labelnames, key, inf)} {count}"
                )
                out.append(
                    f"{self.name}_sum{_labelstr(self.labelnames, key)} {_fmt(total)}"
                )
                out.append(
                    f"{self.name}_count{_labelstr(self.labelnames, key)} {count}"
                )
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {}
            for k, v in self._series.items():
                entry: Dict[str, Any] = {"count": v[2], "sum": round(v[1], 6)}
                exemplars = v[3] if len(v) > 3 else {}
                if exemplars:
                    entry["exemplars"] = {
                        _fmt(
                            self.buckets[i] if i < len(self.buckets) else float("inf")
                        ): {"trace_id": ex[0], "value": ex[1], "t": round(ex[2], 3)}
                        for i, ex in sorted(exemplars.items())
                    }
                out[self.name + _labelstr(self.labelnames, k)] = entry
            return out

    def render_om(self) -> List[str]:
        """OpenMetrics exposition with exemplar suffixes on bucket lines:
        ``..._bucket{le="0.25"} 3 # {trace_id="<id>"} 0.18 <ts>``."""
        out = self.header()
        with self._lock:
            for key in sorted(self._series):
                series = self._series[key]
                raw, total, count = series[:3]
                exemplars = series[3] if len(series) > 3 else {}
                acc = 0
                for i, (le, c) in enumerate(zip(self.buckets, raw)):
                    acc += c
                    extra = 'le="%s"' % _fmt(le)
                    line = (
                        f"{self.name}_bucket"
                        f"{_labelstr(self.labelnames, key, extra)} {acc}"
                    )
                    out.append(line + _exemplar_suffix(exemplars.get(i)))
                inf = 'le="+Inf"'
                out.append(
                    f"{self.name}_bucket"
                    f"{_labelstr(self.labelnames, key, inf)} {count}"
                    + _exemplar_suffix(exemplars.get(len(self.buckets)))
                )
                out.append(
                    f"{self.name}_sum{_labelstr(self.labelnames, key)} {_fmt(total)}"
                )
                out.append(
                    f"{self.name}_count{_labelstr(self.labelnames, key)} {count}"
                )
        return out


def _exemplar_suffix(ex: Optional[Tuple[str, float, float]]) -> str:
    """OpenMetrics exemplar clause for one bucket line ('' when absent)."""
    if not ex:
        return ""
    trace_id, value, ts = ex
    return (
        f' # {{trace_id="{_escape_label(trace_id)}"}} {_fmt(value)} {ts:.3f}'
    )


class MetricsRegistry:
    """Idempotent metric factory + renderer (one per daemon)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"{name} already registered as {existing.kind}"
                    )
                return existing
            metric = cls(name, help, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames=labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames=labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = LATENCY_BUCKETS,
        labelnames: Sequence[str] = (),
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, buckets=buckets, labelnames=labelnames
        )

    def get(self, name: str) -> Optional[_Metric]:
        """Registered metric by name, or None — read-only lookup for
        consumers (alert threshold rules) that must not create series."""
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4 (trailing newline included).

        The registry lock is held across the whole render: a scrape
        iterating the family dict while a worker thread registers a new
        family must not race the dict (RuntimeError under concurrent
        mutation).  Per-metric locks still serialize series access, and
        registration is rare, so the widened critical section costs a
        scrape nothing measurable.
        """
        with self._lock:
            lines: List[str] = []
            for k in sorted(self._metrics):
                lines.extend(self._metrics[k].render())
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """OpenMetrics 1.0 exposition: counter families named without the
        ``_total`` suffix, histogram buckets carrying exemplars, and the
        mandatory ``# EOF`` terminator.  Served on /metrics only under
        ``Accept: application/openmetrics-text`` — classic 0.0.4 parsers
        never see exemplar syntax."""
        with self._lock:
            lines = []
            for k in sorted(self._metrics):
                lines.extend(self._metrics[k].render_om())
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable flat view, merged into the daemon `stats` op."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for k in sorted(self._metrics):
                m = self._metrics[k]
                bucket = {
                    "counter": "counters",
                    "gauge": "gauges",
                    "histogram": "histograms",
                }[m.kind]
                out[bucket].update(m.snapshot())  # type: ignore[attr-defined]
        return out
