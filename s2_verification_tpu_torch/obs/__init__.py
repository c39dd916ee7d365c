"""Zero-dependency observability: spans, metrics and build introspection.

The port's copy of the part of the JAX package's ``obs`` package that the
supervised device escalation needs:

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

The daemon-side modules of the JAX package (health, httpd, log, flight,
alerts, archive, sentinel, dashboard, tsdb, federate) are not ported yet.
Everything here is stdlib-only and never imports ``torch``.
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
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "INTROSPECTOR",
    "JitIntrospector",
    "MetricsRegistry",
    "ResourceSampler",
    "Tracer",
    "get_job_context",
    "job_context",
    "new_trace_id",
    "record_build",
    "valid_trace_id",
]
