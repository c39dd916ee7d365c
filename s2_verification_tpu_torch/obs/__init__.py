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

The JAX package's httpd, flight, alerts, archive, dashboard, tsdb and
federate modules are not ported yet (ROADMAP.md, queue 1).  Everything
here is stdlib-only and never imports ``torch``.
"""

from .context import new_trace_id, valid_trace_id
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
from .sentinel import PerfSentinel, SentinelConfig
from .trace import Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "INTROSPECTOR",
    "JitIntrospector",
    "MetricsRegistry",
    "PerfSentinel",
    "ResourceSampler",
    "SLOConfig",
    "SLOHealth",
    "SentinelConfig",
    "StructuredHandler",
    "StructuredLogger",
    "Tracer",
    "get_job_context",
    "job_context",
    "new_trace_id",
    "record_build",
    "valid_trace_id",
]
