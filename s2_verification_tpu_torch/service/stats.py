"""Structured per-job service events + aggregate counters + metrics.

The port's own copy of the JAX package's ``service/stats.py`` (plain
Python, unchanged in behaviour).  Of the daemon-side consumers it can
feed, the port's daemon wires the SLO health, the structured logger and
the sentinel; the alert engine, profile archive and flight recorder are
referenced for type checking only and stay ``None`` until the port has
them.

Every notable daemon event becomes one JSON line on the configured sink
(a file-like object; ``None`` silences the stream but keeps counters):

    {"ev": "done", "t": <epoch>, "job": 3, "client": "loadgen",
     "backend": "native", "wall_s": 0.012, "queue_wait_s": 0.003,
     "verdict": 0, "shape": "64x5x8", "shape_warm": true}

Event names: ``serve_start``, ``admit``, ``reject``, ``cache_hit``,
``start``, ``done``, ``job_error`` (worker raised; job answered with an
internal error), ``decode_error``, ``degrade`` (supervised device job
fell back to CPU), ``serve_stop``; durability and remote-transport
events: ``cache_loaded`` (persistent verdict segments replayed at boot),
``orphan`` (journal replay re-admitted an accepted-but-unanswered job),
``orphan_dropped`` / ``orphan_invalid`` (reported, not silently lost),
``auth_reject`` (TCP frame failed HMAC verification — rejected before
admission), ``frame_error`` (oversized or malformed frame),
``stats_sink_lost`` (the event sink broke twice; counters survive);
``slo_breach`` (the SLO engine's edge-triggered burn-rate trip — emitted
back onto this same stream so sinks, the flight recorder, and counters
all see it); ``perf_regression`` (the sentinel's per-shape EWMA
wall-time drift trip — also re-emitted onto the stream, where the alert
engine routes it); ``retrace_storm`` (the JIT introspector's latched
per-(site, shape) recompile trip — emitted by
:data:`~..obs.introspect.INTROSPECTOR` onto this stream, where the
alert engine routes it like any other signal).  Overload-protection
events: ``job_cancelled`` (cooperative cancellation fired:
``reason`` = deadline / client_gone / shutdown), ``admission_shed``
(the AdmissionController refused before queueing: ``reason`` = rss /
fds / deadline), ``client_gone`` (a submit's TCP peer vanished
mid-wait), ``job_quarantined`` / ``quarantine_release`` /
``quarantine_reject`` (poison-job ledger transitions), and
``writer_degraded`` / ``writer_recovered`` (a durable writer hit
ENOSPC/OSError and dropped to memory-only / re-armed).  Continuous
batching: ``batch_launch`` — one mega-launch of a shape group
(``engine`` = batch-native / batch-vmap, ``lanes``, ``decided``,
``early_exits``, ``occupancy`` = lanes over ``batch_max``, ``late_join``,
``wall_s`` = the launch wall; per-job attribution stays on each lane's
own ``done`` event).
Incremental prefix verification: ``prefix_loaded``
(persisted frontier snapshots replayed at boot), ``prefix_hit`` /
``prefix_miss`` (an admission probe found / missed a cached prefix;
hits carry ``resume_ops`` and ``depth_frac`` = resumed fraction of the
history), ``prefix_snapshot`` (a worker persisted one cut's carried
frontier; carries the store's ``entries``/``bytes`` after the put),
``prefix_refused`` (a snapshot or frontier advance was refused:
``reason`` = open_ops / unknown_frontier), and ``window_done`` (one
``follow`` window answered: ``stream``, ``window`` ordinal,
``verdict``, ``advanced``, cumulative ``ops_total``).
Search acceleration: ``prune_applied`` — verdict-exact
order pruning contributed to a decided job (``commits`` eager-closed
ops, ``dead`` tail-pinned configurations, ``ranked`` rank-gated
candidates), and ``speculation_rollback`` — one or more speculative
multi-layer dives were discarded on misprediction (``rollbacks``,
cumulative speculated ``layers``, ``launches``, ``accepts``); both ride
the verdict-exact guarantee, so they are rate signals, never
correctness ones.
``shape_warm`` marks a job whose
padded search shape was already run by this daemon — the observable for
"jitted executables reused instead of recompiled".

Counters aggregate the same stream for the ``stats`` protocol op and for
the backpressure retry-after hint (average decided-job wall time).  The
same hooks also drive a Prometheus :class:`~..obs.MetricsRegistry`
(scraped via ``serve --metrics-port``), so the JSONL stream, the ``stats``
op, and /metrics can never disagree about what happened.
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, TYPE_CHECKING, Optional

from ..obs.metrics import LATENCY_BUCKETS, LAYER_BUCKETS, MetricsRegistry

if TYPE_CHECKING:  # pragma: no cover
    from ..obs.alerts import AlertEngine
    from ..obs.archive import ProfileArchive
    from ..obs.flight import FlightRecorder
    from ..obs.health import SLOHealth
    from ..obs.log import StructuredLogger
    from ..obs.sentinel import PerfSentinel

__all__ = ["ServiceStats"]

_VERDICT_LABEL = {0: "ok", 1: "illegal", 2: "unknown"}

#: Lanes-per-launch histogram buckets: powers of two up to the largest
#: supported ``batch_max`` — launch sizes are pow2-bucketed anyway.
_LANE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class ServiceStats:
    def __init__(
        self,
        sink: IO[str] | None = None,
        registry: Optional[MetricsRegistry] = None,
        *,
        health: "Optional[SLOHealth]" = None,
        recorder: "Optional[FlightRecorder]" = None,
        logger: "Optional[StructuredLogger]" = None,
        alerts: "Optional[AlertEngine]" = None,
        archive: "Optional[ProfileArchive]" = None,
        sentinel: "Optional[PerfSentinel]" = None,
    ) -> None:
        self._sink = sink
        #: SLO engine fed every event (outside the sink lock); its breach
        #: edge re-enters emit() as an ``slo_breach`` event.
        self.health = health
        #: flight recorder absorbing every event line for post-mortems
        self.recorder = recorder
        #: structured logger; when set and no sink is configured, events
        #: flow through it instead of a raw stderr stream
        self.logger = logger
        #: alert engine matching every event line against delivery rules
        self.alerts = alerts
        #: durable profile archive absorbing done events (+ lease waits)
        self.archive = archive
        #: perf sentinel; its drift trip re-enters emit() as
        #: ``perf_regression``
        self.sentinel = sentinel
        self._in_breach_emit = False
        self._in_regression_emit = False
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._counters: dict[str, int] = {
            "submitted": 0,
            "admitted": 0,
            "rejected": 0,
            "completed": 0,
            "cache_hits": 0,
            "decode_errors": 0,
            "degraded": 0,
            "verdict_ok": 0,
            "verdict_illegal": 0,
            "verdict_unknown": 0,
            "auth_rejects": 0,
            "frame_errors": 0,
            "orphans_recovered": 0,
            "cache_loaded": 0,
            "job_errors": 0,
            "stats_sink_lost": 0,
            "leases_granted": 0,
            "lease_timeouts": 0,
            "slo_breaches": 0,
            "perf_regressions": 0,
            "retrace_storms": 0,
            "cancelled": 0,
            "admission_shed": 0,
            "quarantined": 0,
            "quarantine_rejects": 0,
            "writer_degraded_events": 0,
            "client_gone": 0,
            "batch_launches": 0,
            "batch_lanes": 0,
            "batch_early_exits": 0,
            "prefix_hits": 0,
            "prefix_misses": 0,
            "prefix_snapshots": 0,
            "prefix_refused": 0,
            "prefix_loaded": 0,
            "windows_done": 0,
            "partitions_granted": 0,
            "partition_deltas": 0,
            "partitions_done": 0,
            "epoch_fences": 0,
            "search_progress": 0,
            "prune_applied": 0,
            "speculation_rollbacks": 0,
        }
        self._wall_total_s = 0.0
        self._active = 0  # jobs handed to a worker, not yet answered
        self._shapes_seen: set[str] = set()
        #: per-shape EWMA of decided wall time (AdmissionController's
        #: deadline-feasibility input)
        self._shape_wall: dict[str, float] = {}
        #: EWMA of device-lease hold time (retry-after's lease-wait term)
        self._lease_hold_avg = 0.0
        #: DevicePool the daemon arms so retry_after_hint can fold
        #: lease-wait estimates in (None when escalation is off)
        self.device_pool = None

        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._m_submitted = r.counter(
            "verifyd_jobs_submitted_total", "Submit requests received (any outcome)"
        )
        self._m_rejected = r.counter(
            "verifyd_jobs_rejected_total", "Submits rejected by admission control"
        )
        self._m_completed = r.counter(
            "verifyd_jobs_completed_total",
            "Jobs answered with a verdict",
            labelnames=("verdict",),
        )
        self._m_cache_hits = r.counter(
            "verifyd_cache_hits_total", "Verdicts answered from the cache"
        )
        self._m_decode_errors = r.counter(
            "verifyd_decode_errors_total", "Submits with undecodable histories"
        )
        self._m_degraded = r.counter(
            "verifyd_degraded_total", "Device escalations that fell back to CPU"
        )
        self._m_job_errors = r.counter(
            "verifyd_job_errors_total", "Jobs answered with an internal error"
        )
        self._m_auth_rejects = r.counter(
            "verifyd_auth_rejects_total", "TCP frames failing HMAC verification"
        )
        self._m_frame_errors = r.counter(
            "verifyd_frame_errors_total", "Oversized or malformed frames"
        )
        self._m_orphans = r.counter(
            "verifyd_orphans_recovered_total", "Journal orphans re-admitted at boot"
        )
        self._m_cache_loaded = r.counter(
            "verifyd_cache_loaded_total", "Persisted verdicts replayed at boot"
        )
        self._m_sink_lost = r.counter(
            "verifyd_stats_sink_lost_total", "Stats sinks dropped after a retry"
        )
        self._m_active = r.gauge(
            "verifyd_active_jobs", "Jobs currently executing on a worker"
        )
        self._m_queue_depth = r.gauge(
            "verifyd_queue_depth", "Jobs waiting in the admission queue"
        )
        self._m_queue_wait = r.histogram(
            "verifyd_queue_wait_seconds",
            "Admission-to-worker-pickup latency",
            buckets=LATENCY_BUCKETS,
        )
        self._m_wall = r.histogram(
            "verifyd_wall_seconds",
            "Verification wall time by deciding backend",
            buckets=LATENCY_BUCKETS,
            labelnames=("backend",),
        )
        self._m_layers = r.histogram(
            "verifyd_frontier_layers",
            "BFS layers searched per profiled job",
            buckets=LAYER_BUCKETS,
        )
        # Device-pool lease accounting (service/devicepool.py events).
        self._m_leases_granted = r.counter(
            "verifyd_leases_granted_total",
            "Device leases granted to escalating jobs",
        )
        self._m_lease_timeouts = r.counter(
            "verifyd_lease_timeouts_total",
            "Lease requests that timed out under contention",
        )
        self._m_devices_leased = r.gauge(
            "verifyd_devices_leased", "Devices currently under lease"
        )
        self._m_lease_wait = r.histogram(
            "verifyd_lease_wait_seconds",
            "Time escalating jobs waited for a device lease",
            buckets=LATENCY_BUCKETS,
        )
        # Per-shard mesh search metrics, labeled by shard index; label
        # cardinality is bounded by the pool size (≤ device count).
        self._m_shard_occ = r.gauge(
            "verifyd_shard_frontier_occupancy",
            "Peak live frontier rows on each mesh shard (last sharded job)",
            labelnames=("shard",),
        )
        self._m_shard_collective = r.histogram(
            "verifyd_shard_collective_seconds",
            "Cross-shard sync wall per sharded job, by shard",
            buckets=LATENCY_BUCKETS,
            labelnames=("shard",),
        )
        self._m_shard_skew = r.gauge(
            "verifyd_shard_skew",
            "Shard peak occupancy over mesh mean (1.0 = balanced)",
            labelnames=("shard",),
        )
        # Build observability (obs/introspect.py increments these through
        # the same registry — registering them here, with HELP text, makes
        # the family headers render from the first scrape).  The families
        # keep the JAX package's names; in the port a "compile" is a lazy
        # nvcc / g++ library build.
        self._m_jit_compiles = r.counter(
            "verifyd_jit_compiles_total",
            "Kernel-library builds (nvcc / g++) at a build site, by site and job shape",
            labelnames=("site", "shape"),
        )
        self._m_jit_retraces = r.counter(
            "verifyd_jit_retraces_total",
            "Rebuilds at a site that already built a library "
            "(fresh source hash)",
            labelnames=("site", "shape"),
        )
        self._m_jit_cache_hits = r.counter(
            "verifyd_jit_cache_hits_total",
            "Build-site calls answered by an already-built library",
            labelnames=("shape",),
        )
        self._m_jit_cache_misses = r.counter(
            "verifyd_jit_cache_misses_total",
            "Build-site calls that had to compile",
            labelnames=("shape",),
        )
        self._m_jit_compile_wall = r.histogram(
            "verifyd_jit_compile_seconds",
            "Compiler wall time per library build, by site",
            buckets=LATENCY_BUCKETS,
            labelnames=("site",),
        )
        self._m_retrace_storms = r.counter(
            "verifyd_retrace_storms_total",
            "Latched retrace-storm trips (a shape rebuilding one site "
            "past the threshold)",
        )
        # Overload protection.  Label sets are bounded by
        # construction: reasons come from fixed vocabularies, writer
        # names from the five durable writers.
        self._m_cancelled = r.counter(
            "verifyd_jobs_cancelled_total",
            "Jobs cooperatively cancelled after admission, by reason",
            labelnames=("reason",),
        )
        self._m_shed = r.counter(
            "verifyd_admission_shed_total",
            "Submits shed before queueing by the admission controller",
            labelnames=("reason",),
        )
        self._m_quarantine_size = r.gauge(
            "verifyd_quarantine_size",
            "Fingerprints currently quarantined as poison jobs",
        )
        self._m_quarantine_size.set(0)
        self._m_writer_degraded = r.gauge(
            "verifyd_writer_degraded",
            "1 while the named durable writer is degraded to memory-only",
            labelnames=("writer",),
        )
        # Continuous cross-job batching.  Engine label is the
        # closed {batch-native, batch-vmap} set (anything else folds to
        # "other"), so cardinality is bounded by construction.
        self._m_batch_lanes = r.histogram(
            "verifyd_batch_launch_lanes",
            "Live lanes per mega-launch, by batch engine",
            buckets=_LANE_BUCKETS,
            labelnames=("engine",),
        )
        self._m_batch_early = r.counter(
            "verifyd_batch_early_exits_total",
            "Lanes whose verdict latched while other lanes kept searching",
        )
        self._m_batch_occupancy = r.gauge(
            "verifyd_batch_launch_occupancy_ratio",
            "Lanes over batch_max for the most recent mega-launch",
        )
        # Incremental prefix verification.  The refused-reason
        # label is the closed {open_ops, unknown_frontier} vocabulary.
        self._m_prefix_hits = r.counter(
            "verifyd_prefix_hits_total",
            "Admission probes that found a cached prefix to resume from",
        )
        self._m_prefix_misses = r.counter(
            "verifyd_prefix_misses_total",
            "Admission probes that found no cached prefix (cold search)",
        )
        self._m_prefix_snapshots = r.counter(
            "verifyd_prefix_snapshots_total",
            "Frontier snapshots persisted at prefix-closed cuts",
        )
        self._m_prefix_refused = r.counter(
            "verifyd_prefix_refused_total",
            "Snapshots or frontier advances refused for soundness",
            labelnames=("reason",),
        )
        self._m_prefix_entries = r.gauge(
            "verifyd_prefix_store_entries", "Frontier snapshots held in the store"
        )
        self._m_prefix_bytes = r.gauge(
            "verifyd_prefix_store_bytes",
            "Serialized bytes of the in-memory prefix store",
        )
        self._m_prefix_depth = r.histogram(
            "verifyd_prefix_resume_depth_ratio",
            "Resumed fraction of the history on a prefix hit (1.0 = the "
            "whole committed prefix was cached)",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 1.0),
        )
        self._m_windows = r.counter(
            "verifyd_follow_windows_total",
            "Follow windows answered with a window-scoped verdict",
        )
        # Distributed search, backend side (service/daemon.py _ds_* ops;
        # the coordinator's own families live on the router registry).
        self._m_ds_granted = r.counter(
            "verifyd_distsearch_partitions_granted_total",
            "Partition ownership grants accepted by this backend",
        )
        self._m_ds_deltas = r.counter(
            "verifyd_distsearch_deltas_total",
            "Frontier deltas answered, by partition verdict",
            labelnames=("verdict",),
        )
        self._m_ds_delta_bytes = r.counter(
            "verifyd_distsearch_delta_bytes_total",
            "Serialized end-of-segment state-union bytes shipped back",
        )
        self._m_ds_done = r.counter(
            "verifyd_distsearch_partitions_done_total",
            "Partition grants closed (done, revoked or failed)",
        )
        self._m_ds_fences = r.counter(
            "verifyd_distsearch_epoch_fences_total",
            "Stale-epoch frames refused, by op",
            labelnames=("op",),
        )
        # Resource telemetry (obs/introspect.ResourceSampler sets these).
        self._m_res_rss = r.gauge(
            "verifyd_resource_rss_bytes", "Daemon resident set size"
        )
        self._m_res_cpu = r.gauge(
            "verifyd_resource_cpu_seconds",
            "Cumulative process CPU time (user+system)",
        )
        self._m_res_fds = r.gauge(
            "verifyd_resource_open_fds", "Open file descriptors"
        )
        self._m_res_threads = r.gauge(
            "verifyd_resource_threads", "Live Python threads"
        )
        self._m_res_gc = r.gauge(
            "verifyd_resource_gc_pause_seconds",
            "Cumulative GC pause time observed via gc callbacks",
        )
        self._m_res_devmem = r.gauge(
            "verifyd_resource_device_memory_bytes",
            "Per-device bytes in use (when the backend reports memory stats)",
            labelnames=("device",),
        )
        # Live search progress (service/progress.JobProgress heartbeats):
        # last-heartbeat values per engine family — a watch surface, not a
        # per-job timeseries (job ids would be unbounded labels).
        self._m_progress_ratio = r.gauge(
            "verifyd_search_progress_ratio",
            "Committed fraction of the search (last heartbeat), by engine",
            labelnames=("engine",),
        )
        self._m_frontier_width = r.gauge(
            "verifyd_search_frontier_width",
            "Live frontier width of the search (last heartbeat), by engine",
            labelnames=("engine",),
        )
        self._m_layer_rate = r.gauge(
            "verifyd_search_layer_rate",
            "EWMA search layers per second (last heartbeat), by engine",
            labelnames=("engine",),
        )
        # Search acceleration: verdict-exact pruning and
        # speculative expansion counters, fed per decided job from the
        # scheduler's prune_applied / speculation_rollback events.
        self._m_prune_commits = r.counter(
            "verifyd_search_prune_commits_total",
            "Ops eagerly committed by the verdict-exact prune "
            "(inert ops and state-passing filters closed without search)",
        )
        self._m_prune_dead = r.counter(
            "verifyd_search_prune_dead_total",
            "Configurations dropped by the tail-pin dead-row rule",
        )
        self._m_prune_ranked = r.counter(
            "verifyd_search_prune_ranked_total",
            "Expansion candidates skipped by the append rank-order gate",
        )
        self._m_spec_layers = r.counter(
            "verifyd_search_spec_layers_total",
            "Search layers expanded inside speculative multi-layer dives",
        )
        self._m_spec_rollbacks = r.counter(
            "verifyd_search_spec_rollbacks_total",
            "Speculative dives discarded on misprediction (exact loop "
            "re-searches from the pre-dive frontier)",
        )

    # -- event stream -------------------------------------------------------

    def emit(self, event: str, **fields) -> None:
        line = {"ev": event, "t": round(time.time(), 3)}
        line.update(fields)
        with self._lock:
            self._count(event, fields)
            if self._sink is not None:
                payload = json.dumps(line, separators=(",", ":"), default=str) + "\n"
                # A broken stats sink must never take a job down — but a
                # single transient OSError (EINTR, brief ENOSPC) must not
                # silence the stream forever either: retry once, then drop
                # the sink with an accounted stats_sink_lost increment.
                for attempt in (0, 1):
                    try:
                        self._sink.write(payload)
                        self._sink.flush()
                        break
                    except ValueError:
                        # Closed file object: no point retrying.
                        self._drop_sink()
                        break
                    except OSError:
                        if attempt:
                            self._drop_sink()
            elif self.logger is not None:
                self.logger.event(event, fields)
        # Observability consumers run outside the sink lock: neither the
        # flight recorder's disk flush, the archive append, nor the SLO
        # window math may extend the emit critical section every job
        # passes through.
        if self.recorder is not None:
            self.recorder.record_event(line)
        if self.archive is not None:
            self.archive.observe_event(line)
        if self.sentinel is not None and not self._in_regression_emit:
            regression = self.sentinel.observe_event(line)
            if regression is not None:
                # Re-entrant emit, same discipline as slo_breach: the
                # regression rides the stream (sink, recorder, alert
                # engine, counters).  The guard stops a regression from
                # judging itself; the sentinel also only folds done
                # events, so no feedback.
                self._in_regression_emit = True
                try:
                    self.emit("perf_regression", **regression)
                finally:
                    self._in_regression_emit = False
        if self.alerts is not None:
            self.alerts.observe_event(line)
        if self.health is not None and not self._in_breach_emit:
            self.health.observe_event(line)
            breach = self.health.check_breach()
            if breach is not None:
                # Re-entrant emit: slo_breach rides the same stream as
                # everything else (sink, recorder, logger, counters).  The
                # guard only stops a breach from evaluating itself; the
                # engine also ignores non-outcome events, so no feedback.
                self._in_breach_emit = True
                try:
                    self.emit("slo_breach", **breach)
                finally:
                    self._in_breach_emit = False
                if self.recorder is not None:
                    self.recorder.dump("slo_breach", breach=breach, slo=self.health.snapshot())

    def _drop_sink(self) -> None:
        # Caller holds self._lock.
        self._sink = None
        self._counters["stats_sink_lost"] += 1
        self._m_sink_lost.inc()

    def _count(self, event: str, fields: dict) -> None:
        if event == "admit":
            self._counters["submitted"] += 1
            self._counters["admitted"] += 1
            self._m_submitted.inc()
        elif event == "reject":
            self._counters["submitted"] += 1
            self._counters["rejected"] += 1
            self._m_submitted.inc()
            self._m_rejected.inc()
        elif event == "cache_hit":
            self._counters["submitted"] += 1
            self._counters["cache_hits"] += 1
            self._m_submitted.inc()
            self._m_cache_hits.inc()
            if "queue_wait_s" in fields:
                self._m_queue_wait.observe(
                    float(fields["queue_wait_s"]),
                    exemplar=fields.get("trace_id"),
                )
        elif event == "decode_error":
            self._counters["submitted"] += 1
            self._counters["decode_errors"] += 1
            self._m_submitted.inc()
            self._m_decode_errors.inc()
        elif event == "degrade":
            self._counters["degraded"] += 1
            self._m_degraded.inc()
        elif event == "lease_grant":
            self._counters["leases_granted"] += 1
            self._m_leases_granted.inc()
            self._m_devices_leased.set(int(fields.get("in_use", 0)))
            if "wait_s" in fields:
                self._m_lease_wait.observe(float(fields["wait_s"]))
        elif event == "lease_release":
            self._m_devices_leased.set(int(fields.get("in_use", 0)))
            if "held_s" in fields:
                held = float(fields["held_s"])
                prev = self._lease_hold_avg
                self._lease_hold_avg = held if prev <= 0 else 0.7 * prev + 0.3 * held
        elif event == "lease_timeout":
            self._counters["lease_timeouts"] += 1
            self._m_lease_timeouts.inc()
        elif event == "slo_breach":
            self._counters["slo_breaches"] += 1
        elif event == "perf_regression":
            self._counters["perf_regressions"] += 1
        elif event == "retrace_storm":
            self._counters["retrace_storms"] += 1
            self._m_retrace_storms.inc()
        elif event == "auth_reject":
            self._counters["auth_rejects"] += 1
            self._m_auth_rejects.inc()
        elif event == "frame_error":
            self._counters["frame_errors"] += 1
            self._m_frame_errors.inc()
        elif event == "orphan":
            self._counters["orphans_recovered"] += 1
            self._m_orphans.inc()
        elif event == "cache_loaded":
            # Additive: one boot can replay several segments (and a long
            # daemon life can reload more than once); each event reports
            # the entries *it* replayed.
            n = int(fields.get("entries", 0))
            self._counters["cache_loaded"] += n
            self._m_cache_loaded.inc(n)
        elif event == "start":
            self._active += 1
            self._m_active.set(self._active)
            if "queue_wait_s" in fields:
                # Exemplar: the event's trace_id rides the observation so
                # an OpenMetrics scrape links the bucket to a timeline.
                self._m_queue_wait.observe(
                    float(fields["queue_wait_s"]),
                    exemplar=fields.get("trace_id"),
                )
        elif event == "job_cancelled":
            self._counters["cancelled"] += 1
            reason = str(fields.get("reason", "other"))
            if reason not in ("deadline", "client_gone", "shutdown"):
                reason = "other"
            self._m_cancelled.inc(reason=reason)
            # Only a job that actually started (emitted `start`) holds a
            # slot in the active gauge; queue-expiry cancels never did.
            if fields.get("started"):
                self._active = max(0, self._active - 1)
                self._m_active.set(self._active)
        elif event == "admission_shed":
            self._counters["submitted"] += 1
            self._counters["admission_shed"] += 1
            self._m_submitted.inc()
            reason = str(fields.get("reason", "other"))
            if reason not in ("rss", "fds", "deadline"):
                reason = "other"
            self._m_shed.inc(reason=reason)
        elif event == "job_quarantined":
            self._counters["quarantined"] += 1
            self._m_quarantine_size.set(int(fields.get("size", 0)))
        elif event == "quarantine_release":
            self._m_quarantine_size.set(int(fields.get("size", 0)))
        elif event == "quarantine_reject":
            self._counters["submitted"] += 1
            self._counters["quarantine_rejects"] += 1
            self._m_submitted.inc()
        elif event == "writer_degraded":
            self._counters["writer_degraded_events"] += 1
            writer = str(fields.get("writer", "?"))
            if writer not in (
                "flight", "archive", "journal", "cache", "telemetry"
            ):
                writer = "other"
            self._m_writer_degraded.set(1, writer=writer)
        elif event == "writer_recovered":
            writer = str(fields.get("writer", "?"))
            if writer not in (
                "flight", "archive", "journal", "cache", "telemetry"
            ):
                writer = "other"
            self._m_writer_degraded.set(0, writer=writer)
        elif event == "client_gone":
            self._counters["client_gone"] += 1
        elif event == "batch_launch":
            lanes = int(fields.get("lanes", 0))
            early = int(fields.get("early_exits", 0))
            self._counters["batch_launches"] += 1
            self._counters["batch_lanes"] += lanes
            self._counters["batch_early_exits"] += early
            engine = str(fields.get("engine", "other"))
            if engine not in ("batch-native", "batch-vmap"):
                engine = "other"
            self._m_batch_lanes.observe(float(lanes), engine=engine)
            if early:
                self._m_batch_early.inc(early)
            self._m_batch_occupancy.set(float(fields.get("occupancy", 0.0)))
        elif event == "prefix_loaded":
            n = int(fields.get("entries", 0))
            self._counters["prefix_loaded"] += n
            self._m_prefix_entries.set(n)
            self._m_prefix_bytes.set(int(fields.get("bytes", 0)))
        elif event == "prefix_hit":
            self._counters["prefix_hits"] += 1
            self._m_prefix_hits.inc()
            if "depth_frac" in fields:
                self._m_prefix_depth.observe(
                    float(fields["depth_frac"]),
                    exemplar=fields.get("trace_id"),
                )
        elif event == "prefix_miss":
            self._counters["prefix_misses"] += 1
            self._m_prefix_misses.inc()
        elif event == "prefix_snapshot":
            self._counters["prefix_snapshots"] += 1
            self._m_prefix_snapshots.inc()
            self._m_prefix_entries.set(int(fields.get("entries", 0)))
            self._m_prefix_bytes.set(int(fields.get("bytes", 0)))
        elif event == "prefix_refused":
            self._counters["prefix_refused"] += 1
            reason = str(fields.get("reason", "other"))
            if reason not in ("open_ops", "unknown_frontier"):
                reason = "other"
            self._m_prefix_refused.inc(reason=reason)
        elif event == "window_done":
            self._counters["windows_done"] += 1
            self._m_windows.inc()
        elif event == "partition_granted":
            self._counters["partitions_granted"] += 1
            self._m_ds_granted.inc()
        elif event == "partition_delta":
            self._counters["partition_deltas"] += 1
            try:
                v = int(fields.get("verdict", 2))
            except (TypeError, ValueError):
                v = 2
            self._m_ds_deltas.inc(verdict=_VERDICT_LABEL.get(v, "unknown"))
            try:
                self._m_ds_delta_bytes.inc(int(fields.get("bytes", 0)))
            except (TypeError, ValueError):
                pass
        elif event == "partition_done":
            self._counters["partitions_done"] += 1
            self._m_ds_done.inc()
        elif event == "epoch_fence":
            self._counters["epoch_fences"] += 1
            op = str(fields.get("op", "other"))
            if op not in ("grant", "delta", "delta_reply", "done"):
                op = "other"
            self._m_ds_fences.inc(op=op)
        elif event == "prune_applied":
            self._counters["prune_applied"] += 1
            self._m_prune_commits.inc(int(fields.get("commits", 0)))
            self._m_prune_dead.inc(int(fields.get("dead", 0)))
            self._m_prune_ranked.inc(int(fields.get("ranked", 0)))
        elif event == "speculation_rollback":
            n = int(fields.get("rollbacks", 1))
            self._counters["speculation_rollbacks"] += n
            self._m_spec_rollbacks.inc(n)
            self._m_spec_layers.inc(int(fields.get("layers", 0)))
        elif event == "search_progress":
            self._counters["search_progress"] += 1
            engine = str(fields.get("engine", "other"))
            if engine not in (
                "native",
                "oracle",
                "frontier",
                "device",
                "device-mesh",
                "batch-native",
                "batch-vmap",
            ):
                engine = "other"
            self._m_progress_ratio.set(
                float(fields.get("progress_ratio", 0.0)), engine=engine
            )
            self._m_frontier_width.set(
                float(fields.get("frontier_width", 0)), engine=engine
            )
            self._m_layer_rate.set(
                float(fields.get("layer_rate", 0.0)), engine=engine
            )
        elif event == "job_error":
            self._counters["job_errors"] += 1
            self._active = max(0, self._active - 1)
            self._m_job_errors.inc()
            self._m_active.set(self._active)
        elif event == "done":
            self._counters["completed"] += 1
            self._active = max(0, self._active - 1)
            self._m_active.set(self._active)
            wall = float(fields.get("wall_s", 0.0))
            self._wall_total_s += wall
            shape = fields.get("shape")
            if shape:
                prev = self._shape_wall.get(str(shape))
                self._shape_wall[str(shape)] = (
                    wall if prev is None else 0.7 * prev + 0.3 * wall
                )
            v = fields.get("verdict")
            name = {0: "verdict_ok", 1: "verdict_illegal", 2: "verdict_unknown"}.get(v)
            if name is not None:
                self._counters[name] += 1
            self._m_completed.inc(verdict=_VERDICT_LABEL.get(v, "unknown"))
            # The event field carries sized values ("device-mesh[4]",
            # "device-3"): fold to the engine family before it becomes a
            # label, or every mesh size / device ordinal mints a new
            # timeseries.
            backend = str(fields.get("backend", "unknown"))
            if backend.startswith("device-mesh"):
                backend = "device-mesh"
            elif backend.startswith("device"):
                backend = "device"
            elif backend.startswith("frontier"):
                # frontier-cold / frontier-resume / frontier-unbounded:
                # one engine family, one timeseries.
                backend = "frontier"
            if backend not in (
                "native",
                "oracle",
                "frontier",
                "device",
                "device-mesh",
                "auto",
                "unknown",
                "batch-native",
                "batch-vmap",
            ):
                backend = "other"
            self._m_wall.observe(
                wall,
                exemplar=fields.get("trace_id"),
                backend=backend,
            )
            profile = fields.get("profile")
            if isinstance(profile, dict) and "layers" in profile:
                self._m_layers.observe(float(profile["layers"]))
            for s in fields.get("shards") or []:
                if not isinstance(s, dict):
                    continue
                # shard ordinals are bounded by the device-pool size (≤8
                # mesh devices), not by traffic — closed in practice, just
                # not provable from a literal set.
                shard = str(s.get("shard", "?"))
                self._m_shard_occ.set(
                    float(s.get("peak_occupancy", 0)),
                    shard=shard,  # verifylint: disable=metric-open-label
                )
                self._m_shard_collective.observe(
                    float(s.get("collective_wall_s", 0.0)),
                    shard=shard,  # verifylint: disable=metric-open-label
                )
                self._m_shard_skew.set(
                    float(s.get("skew", 1.0)),
                    shard=shard,  # verifylint: disable=metric-open-label
                )

    def set_quarantine_size(self, size: int) -> None:
        """Boot-time (re)sync of the quarantine gauge with the persisted
        ledger; live transitions ride the event stream."""
        self._m_quarantine_size.set(int(size))

    def set_queue_depth(self, depth: int) -> None:
        """Point-in-time admission-queue depth (daemon after put, workers
        after a batch pull)."""
        self._m_queue_depth.set(depth)

    # -- shape warmth -------------------------------------------------------

    def note_shape(self, shape: str) -> bool:
        """Record a shape about to run; returns True when this daemon has
        already run it (compiled executables are warm)."""
        with self._lock:
            warm = shape in self._shapes_seen
            self._shapes_seen.add(shape)
            return warm

    # -- aggregates ---------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            snap = dict(self._counters)
            snap["uptime_s"] = round(time.time() - self._t0, 3)
            snap["shapes_run"] = len(self._shapes_seen)
            snap["active"] = self._active
            done = self._counters["completed"]
            snap["avg_wall_s"] = round(self._wall_total_s / done, 4) if done else 0.0
        snap["metrics"] = self.registry.snapshot()
        if self.health is not None:
            snap["slo"] = self.health.snapshot()
        if self.sentinel is not None:
            snap["sentinel"] = self.sentinel.snapshot()
        if self.alerts is not None:
            snap["alerts"] = self.alerts.snapshot()
        if self.archive is not None:
            snap["archive"] = self.archive.snapshot()
        return snap

    @property
    def active(self) -> int:
        """Jobs handed to a worker and not yet answered (drain poller)."""
        with self._lock:
            return self._active

    def predicted_wall_s(self, shape: str) -> float:
        """EWMA of decided wall time for ``shape`` (0.0 = never seen) —
        the AdmissionController's deadline-feasibility input."""
        with self._lock:
            return self._shape_wall.get(str(shape), 0.0)

    def retry_after_hint(self, queue_depth: int) -> float:
        """Backpressure hint: roughly how long until the queue has room —
        (queued + in-flight jobs) × average decided-job wall time, plus
        the device pool's lease-wait backlog (waiters × EWMA lease hold:
        jobs parked in supervised escalation drain no faster than leases
        turn over, and a hint that ignored them taught clients to
        dogpile a wedged mesh), clamped to [0.5, 30] s (a cold daemon
        has no average yet; never tell a client "0")."""
        with self._lock:
            done = self._counters["completed"]
            avg = (self._wall_total_s / done) if done else 1.0
            pending = queue_depth + self._active
            hold = self._lease_hold_avg
        extra = 0.0
        if self.device_pool is not None and hold > 0:
            try:
                extra = self.device_pool.snapshot().get("waiters", 0) * hold
            except Exception:
                extra = 0.0
        return round(min(30.0, max(0.5, pending * avg + extra)), 2)
