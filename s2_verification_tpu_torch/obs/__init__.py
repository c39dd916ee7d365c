"""Zero-dependency observability: spans, metrics, health and logs.

The port's copy of the part of the JAX package's ``obs`` package that the
in-memory daemon and the supervised device escalation need:

- ``trace``      — a thread-safe Tracer recording nested spans into a
                   bounded ring, exportable as Chrome trace_event JSON
                   (Perfetto); stitches child-process rings via clock
                   rebasing.
- ``context``    — distributed trace ids (W3C-style), protocol-frame
                   propagation helpers, and the clock-rebase math.
- ``metrics``    — counter / gauge / histogram registry rendering
                   Prometheus text exposition format 0.0.4 and OpenMetrics.
- ``introspect`` — the build tracker (lazy ``nvcc`` / ``g++`` library
                   builds in place of the JAX package's ``jax.jit``
                   compiles) and the ResourceSampler (RSS / CPU / fds /
                   threads / GC pauses / card memory).
- ``log``        — the structured logger and its ``logging.Handler``.
- ``health``     — the SLO engine: availability and latency windows,
                   burn rates, the breach events.
- ``sentinel``   — per-shape EWMA wall-time baselines that report a
                   drift as ``perf_regression``.
- ``httpd``      — stdlib-only HTTP listener serving GET /metrics, a real
                   /healthz (200 ok / 503 degraded), /slo, /sentinel and
                   /dashboard.
- ``flight``     — flight recorder: bounded on-disk ring of recent events
                   + spans (seglog-backed) and the doctor's post-mortem.
- ``alerts``     — rule-driven AlertEngine delivering alertmanager-
                   compatible webhooks (backoff + jitter, dedup/re-arm).
- ``archive``    — durable per-job profile archive + deduplicated history
                   corpus over seglog.
- ``dashboard``  — live self-contained HTML dashboard sampled from the
                   metric families.
- ``tsdb``       — durable multi-resolution time-series store over seglog
                   (the ``tsq`` op and CLI, sentinel re-seeding).
- ``probe``      — the router's circuit breaker and backend health prober.
- ``federate``   — the router's FleetScraper: every backend's metrics
                   merged under a closed ``node`` label into
                   ``/fleet/metrics``, a fleet SLO rollup, and the fleet
                   dashboard board.

Everything here is stdlib-only and never imports ``torch``.
"""

from .alerts import AlertEngine, AlertRule, builtin_rules, parse_rule
from .archive import ProfileArchive, filter_records, read_archive, read_corpus
from .context import new_trace_id, valid_trace_id
from .dashboard import Dashboard
from .federate import FleetScraper, ScrapeTarget
from .flight import FlightRecorder, postmortem, read_flight, render_postmortem
from .introspect import (
    INTROSPECTOR,
    JitIntrospector,
    ResourceSampler,
    get_job_context,
    job_context,
    record_build,
)
from .health import SLOConfig, SLOHealth
from .log import StructuredHandler, StructuredLogger
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .sentinel import PerfSentinel, SentinelConfig, seed_from_telemetry
from .trace import Tracer
from .tsdb import TelemetryStore, last_values, query, telemetry_info

__all__ = [
    "AlertEngine",
    "AlertRule",
    "Counter",
    "Dashboard",
    "FleetScraper",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "INTROSPECTOR",
    "JitIntrospector",
    "MetricsRegistry",
    "PerfSentinel",
    "ProfileArchive",
    "ResourceSampler",
    "SLOConfig",
    "SLOHealth",
    "ScrapeTarget",
    "SentinelConfig",
    "StructuredHandler",
    "StructuredLogger",
    "TelemetryStore",
    "Tracer",
    "builtin_rules",
    "filter_records",
    "get_job_context",
    "job_context",
    "last_values",
    "new_trace_id",
    "parse_rule",
    "postmortem",
    "query",
    "read_archive",
    "read_corpus",
    "read_flight",
    "record_build",
    "render_postmortem",
    "seed_from_telemetry",
    "telemetry_info",
    "valid_trace_id",
]
