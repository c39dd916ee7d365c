"""verifyd: the resident verification daemon.

The port's copy of the JAX package's ``service/daemon.py``: serves the :mod:`.protocol` over a unix-domain socket and, optionally, an
HMAC-authenticated TCP listener (``VerifydConfig.tcp`` + ``secret``) so
collectors on other machines can submit.  Like the collector's loopback
S2 server (``collector/socket_s2.py``), the asyncio acceptor runs a
private event loop on a daemon thread, so the daemon composes as a
context manager in tests and as a foreground process under
``python -m s2_verification_tpu_torch serve``.  Checking itself never runs
on the event loop: the acceptor only decodes, consults the verdict cache,
and admits into the bounded queue; :class:`~.scheduler.Scheduler` worker
threads do the searching and resolve each submit's deferred reply through
``call_soon_threadsafe``.

Ops served: ``ping``, ``stats``, ``trace``, ``watch``, ``shutdown`` (and
its drain), ``submit`` (with deadlines and cancel) and ``follow``.  A
supervised escalation runs the device search in a child process;
``device="inline"`` runs it here, on ``torch_device`` (``None`` = the
card), the one field the port adds to the JAX config.  A supervised or
device-off daemon never imports ``torch`` unless it batches with the vmap
engine.

Durability (``VerifydConfig.state_dir``), as in the JAX daemon and in
its on-disk formats: the verdict cache spills to CRC-checked segment
files (``<state_dir>/verdicts/``), admission write-ahead records go to a
journal (``<state_dir>/journal/``), crashes per fingerprint to the
quarantine ledger (``<state_dir>/quarantine/``), and the flight recorder,
profile archive and telemetry store keep their rings beside them.
Startup replays the verdicts and the journal — previously decided
fingerprints answer warm without a checker, and accepted-but-unanswered
jobs from a crashed run are re-admitted (``orphan`` stats events) after
the poison accounting.  A state dir either package's daemon wrote is
read by the other's.  The ops layer: ``--metrics-port`` (``/metrics``,
``/healthz``, ``/slo``, ``/sentinel``, ``/dashboard``), ``--alert-url``,
and the ``tsq``, ``profiles`` and ``quarantine`` ops.

Continuous batching (``batching``, ``service/batcher.py``) runs a shape
group as one launch; with ``batch_engine="vmap"`` (or ``"auto"`` where the
native engine does not build) that launch is the lane-batched search on
``torch_device``, resolved when the daemon is built, so a batching daemon
without a card raises ``DeviceUnavailable`` then.  Incremental
verification (``prefix_enabled``): the prefix store
(``service/prefixstore.py``, ``<state_dir>/prefix`` or in memory) probes
each submit for a cached prefix and serves the ``follow`` op; its keys,
entries and segments are the JAX package's byte for byte.

Fleet peer ops (``service/distsearch.py``): ``grant``, ``delta`` and
``partition_done`` make this daemon one partition owner of a router's
distributed search, under the same epoch fencing as the JAX daemon.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import itertools
import json
import logging
import os
import platform
import sys
import threading
import time
from dataclasses import dataclass, field

from .. import version as _version
from ..checker.entries import prepare
from ..checker.prefix import PrefixCarry
from ..obs.alerts import AlertEngine, builtin_rules, parse_rule
from ..obs.archive import ARCHIVE_SUBDIR, ProfileArchive
from ..obs.context import TRACE_FIELD, new_trace_id, parse_trace_frame
from ..obs.dashboard import Dashboard
from ..obs.flight import FLIGHT_SUBDIR, FlightRecorder
from ..obs.health import SLOConfig, SLOHealth
from ..obs.httpd import MetricsServer
from ..obs.introspect import INTROSPECTOR, ResourceSampler
from ..obs.log import StructuredLogger
from ..obs.metrics import MetricsRegistry
from ..obs.sentinel import PerfSentinel, SentinelConfig, seed_from_telemetry
from ..obs.trace import Tracer
from ..obs.tsdb import TelemetryStore
from ..obs.tsdb import default_dir as telemetry_default_dir
from ..obs.tsdb import tsq_request
from ..utils import events as ev
from .cache import VerdictCache, history_fingerprint
from .distsearch import pack_states
from .fastprep import FastPrepFallback, fast_prepare
from .journal import JobJournal
from .overload import (
    AdmissionController,
    CancelToken,
    DegradedWriter,
    QuarantineStore,
)
from .prefixstore import (
    PREFIX_SUBDIR,
    PrefixPlan,
    PrefixStore,
    make_entry,
    plan_for_submit,
    plan_for_window,
)
from .protocol import (
    ERR_AUTH,
    ERR_DEADLINE,
    ERR_DECODE,
    ERR_EPOCH,
    ERR_FRAME,
    ERR_FRONTIER,
    ERR_INTERNAL,
    ERR_QUARANTINED,
    ERR_QUEUE_FULL,
    ERR_SHUTTING_DOWN,
    ERR_TOO_LARGE,
    ERR_UNKNOWN_JOB,
    MAX_FRAME_BYTES,
    PROTOCOL_VERSION,
    decode_frame,
    encode_frame,
    err,
    ok,
    parse_hostport,
    sign_frame,
    verify_frame,
)
from .queue import AdmissionQueue, Job, QueueFull
from .scheduler import Scheduler, shape_key
from .stats import ServiceStats

__all__ = ["VerifydConfig", "Verifyd"]

log = logging.getLogger("s2_verification_tpu_torch.verifyd")


@dataclass
class VerifydConfig:
    socket_path: str
    queue_depth: int = 64
    workers: int = 1  # 0 = admission only (test hook: nothing drains)
    batch_max: int = 16
    time_budget_s: float | None = 10.0  # per-job CPU budget; 0 = unbounded CPU
    device: str = "supervised"  # supervised | inline | off
    unbounded_close: bool = False
    out_dir: str = "./porcupine-outputs"
    no_viz: bool = False
    cache_capacity: int = 4096
    spool_dir: str | None = None
    device_rows: int | None = None
    attempt_timeout_s: float = 900.0
    max_restarts: int = 2
    #: structured-events sink: a path, "-" for stderr, or None (silent)
    stats_log: str | None = None
    #: "host:port" for the authenticated TCP listener (port 0 = ephemeral,
    #: bound port on :attr:`Verifyd.tcp_port`); requires ``secret``
    tcp: str | None = None
    #: shared secret for TCP frame HMACs; the unix socket never needs it
    secret: bytes | None = None
    #: per-frame read bound; oversized frames get a definite FrameTooLarge
    frame_max_bytes: int = MAX_FRAME_BYTES
    #: TCP per-frame *read* deadline (slowloris bound) — the deferred
    #: submit reply is bounded by the scheduler's budgets, not this
    conn_deadline_s: float = 30.0
    #: graceful-drain budget (``serve --drain-timeout``): on SIGTERM or a
    #: drain-flagged shutdown op, stop admitting, let queued + in-flight
    #: jobs finish up to this many seconds, close the journal cleanly,
    #: then stop.  0 keeps the immediate stop
    drain_timeout_s: float = 0.0
    #: durable-state root (verdict segments + admission journal +
    #: quarantine ledger + flight ring + profile archive); None =
    #: in-memory only
    state_dir: str | None = None
    #: fsync every durable append (survives machine crash, not just
    #: process death); off by default — SIGKILL safety needs only flush
    fsync: bool = False
    #: Prometheus /metrics HTTP listener port; None = no listener, 0 =
    #: ephemeral (bound port on :attr:`Verifyd.metrics_port`)
    metrics_port: int | None = None
    #: span-ring capacity for the in-process tracer (`trace` op / CLI
    #: export); 0 disables tracing entirely
    trace_capacity: int = 8192
    #: attach per-job search profiles (FrontierStats timeline, native
    #: phase attribution) to `done` events and submit replies
    profile: bool = False
    #: size of the device pool for mesh-sharded escalations; None = the
    #: single-card path (no pool).  The daemon only tracks abstract slot
    #: indices — devices are resolved by the escalation itself
    mesh_devices: int | None = None
    #: how long an escalation waits for a lease before running unsharded
    lease_timeout_s: float = 120.0
    #: structured-log line format for daemon diagnostics (and the
    #: stats_log="-" fallback): "text" or "json"
    log_format: str = "text"
    #: SLO availability target for the burn-rate breach events; 1.0
    #: disables burn math (never degraded by errors)
    slo_target: float = 0.99
    #: end-to-end latency target (p95 on the short window)
    slo_latency_target_s: float = 5.0
    #: alert webhook URL (alertmanager-compatible POST target); None
    #: disables the alert engine entirely
    alert_url: str | None = None
    #: extra --alert-rule specs (see obs/alerts.parse_rule); the
    #: slo_breach + perf_regression built-ins always apply
    alert_rules: tuple = ()
    #: per-rule alert dedup window (a flapping signal pages once per
    #: window; the rest count as suppressed)
    alert_dedup_s: float = 300.0
    alert_retries: int = 4
    alert_backoff_s: float = 0.5
    #: perf sentinel drift band: fire when a shape's wall time exceeds
    #: its EWMA baseline by this fraction for consecutive jobs; <= 0
    #: disables the sentinel
    sentinel_band: float = 0.75
    #: sentinel cold-start guard: per-shape jobs folded before judging
    sentinel_min_samples: int = 8
    #: resource-telemetry sampling interval (RSS, CPU, fds, threads, GC
    #: pauses, card memory → gauges); <= 0 disables
    resource_sample_s: float = 1.0
    #: retained resource samples in the in-memory ring
    resource_capacity: int = 600
    #: latched retrace_storm trip point: a shape rebuilding one build
    #: site more than this many times emits the event once
    retrace_storm_threshold: int = 5
    #: /dashboard scrape-ring tick (sparkline resolution); <= 0 disables
    #: the dashboard even when the metrics listener is up
    dashboard_sample_s: float = 2.0
    #: retained dashboard ticks (sparkline history length)
    dashboard_capacity: int = 240
    #: durable telemetry store root; None = <state_dir>/telemetry when a
    #: state dir is set, else disabled (the ``tsq`` op / CLI and sentinel
    #: re-seeding read it)
    telemetry_dir: str | None = None
    #: telemetry sampling cadence (raw ring tick; the 1m/15m rings
    #: downsample from it); <= 0 disables recording entirely
    telemetry_sample_s: float = 2.0
    #: RSS watermark for the admission controller, as a fraction of
    #: MemTotal: submits arriving past it are shed with an honest
    #: retry_after instead of queued; <= 0 disables pressure shedding
    max_rss_frac: float = 0.0
    #: SIGTERM→SIGKILL grace for cancelled supervised children (also the
    #: slack a 2 s-deadline job gets to actually free its worker)
    deadline_grace_s: float = 2.0
    #: process deaths / child kills per fingerprint before quarantine;
    #: only meaningful with ``state_dir``
    quarantine_threshold: int = 3
    #: fused single-pass admission (service/fastprep.py): parse, pair,
    #: validate and prepare in one walk, falling back to the layered
    #: decode path on any anomaly (identical errors, just slower)
    fast_admission: bool = True
    #: continuous cross-job batching: shape groups run as mega-launches
    #: (service/batcher.py) with late-join and per-lane attribution
    batching: bool = False
    #: lane engine for mega-launches: auto | native | vmap
    batch_engine: str = "auto"
    #: incremental prefix verification (service/prefixstore.py): probe
    #: incoming histories for cached prefixes, snapshot OK searches at
    #: closed op boundaries, and serve the ``follow`` op.  Opt-in
    #: (``serve --prefix``): planned jobs run the resumable host-frontier
    #: engine instead of the native/oracle portfolio.
    prefix_enabled: bool = False
    #: in-memory prefix-store entries (LRU); disk is bounded separately
    #: by segment rotation
    prefix_capacity: int = 2048
    #: histories below this many ops never probe or snapshot (the cold
    #: engines already answer them faster than a store round-trip)
    prefix_min_ops: int = 4
    #: snapshot cuts collected per OK search (probes still check every
    #: closed boundary — lookups are cheap, snapshots are not)
    prefix_cuts: int = 8
    #: prefix-store segment-rotation bound under <state_dir>/prefix/
    prefix_max_segments: int = 8
    #: progress-heartbeat cadence per job (checker/progress.ProgressSink
    #: time gate, the `watch` op's data source); <= 0 disables heartbeats
    #: entirely — engines then run exactly the pre-progress code path
    progress_interval_s: float = 0.5
    #: verdict-exact search pruning (``serve --prune``) on every engine
    #: that carries it (checker/prune.py); never changes a verdict
    prune: bool = False
    #: speculative multi-layer frontier expansion depth for device
    #: escalations (``serve --speculate-depth``); 0 = off
    speculate_depth: int = 0
    extra: dict = field(default_factory=dict)
    #: the port's one addition: the torch device of inline and supervised
    #: escalations and of vmap launch groups (``serve --torch-device``).
    #: None = the card; an inline or vmap-batching daemon without one
    #: raises when it is built.  "cpu" runs the device search on the CPU
    torch_device: str | None = None


def holds_card(cfg: VerifydConfig) -> bool:
    """Whether the daemon's own process searches on ``torch_device``: an
    inline escalation, or batching whose launch engine is vmap
    (``"auto"`` picks native wherever the C++ engine builds)."""
    if cfg.device == "inline":
        return True
    if not cfg.batching or cfg.batch_engine == "native":
        return False
    if cfg.batch_engine == "vmap":
        return True
    from ..checker.batched import default_engine

    return default_engine() == "vmap"


class Verifyd:
    """The daemon.  ``with Verifyd(cfg) as d: ...`` for tests;
    :meth:`serve_forever` for the foreground CLI."""

    def __init__(self, config: VerifydConfig) -> None:
        self.cfg = config
        if config.tcp is not None and not config.secret:
            raise ValueError(
                "a TCP listener requires a shared secret (VerifydConfig.secret)"
            )
        if holds_card(config):
            # An inline or vmap-batching daemon holds the card itself:
            # without one it raises DeviceUnavailable now, never at its
            # first escalation or launch.
            from ..checker.device import resolve_device

            resolve_device(config.torch_device)
        self.logger = StructuredLogger(
            sys.stderr, fmt=config.log_format, component="verifyd"
        )
        self._stats_file = None
        sink = None
        stats_logger = None
        if config.stats_log == "-":
            # Events flow through the structured logger so they share
            # format + stream with every other daemon diagnostic.
            stats_logger = self.logger
        elif config.stats_log:
            self._stats_file = open(config.stats_log, "a", encoding="utf-8")
            sink = self._stats_file
        self.registry = MetricsRegistry()
        self.tracer = Tracer(config.trace_capacity)
        self.tracer.name_track(0, "admission")
        self._m_trace_dropped = self.registry.counter(
            "verifyd_trace_spans_dropped_total",
            "Spans evicted from the saturated trace ring (timelines truncated)",
        )
        self._m_trace_dropped.inc(0)
        self.tracer.drop_hook = lambda _total: self._m_trace_dropped.inc()
        # Info-style gauge (constant 1): build identity rides the label
        # set, so scrapes can tell nodes apart.
        self.registry.gauge(
            "verifyd_build_info",
            "Build identity (value is always 1; the labels carry it)",
            labelnames=("version", "backend", "python"),
        ).set(
            1.0,
            version=_version.__version__,
            backend=config.device,
            python=platform.python_version(),
        )
        self.health = SLOHealth(
            SLOConfig(
                availability_target=config.slo_target,
                latency_target_s=config.slo_latency_target_s,
            ),
            registry=self.registry,
        )
        self.flight = None
        self.archive = None
        if config.state_dir:
            self.flight = FlightRecorder(
                os.path.join(config.state_dir, FLIGHT_SUBDIR), fsync=config.fsync
            )
            self.tracer.span_hook = self.flight.record_span
            self.archive = ProfileArchive(
                os.path.join(config.state_dir, ARCHIVE_SUBDIR),
                fsync=config.fsync,
            )
        self.sentinel = None
        if config.sentinel_band > 0:
            self.sentinel = PerfSentinel(
                SentinelConfig(
                    band=config.sentinel_band,
                    min_samples=config.sentinel_min_samples,
                ),
                registry=self.registry,
            )
        self.alerts = None
        if config.alert_url:
            # User rules extend (never replace) the built-ins; a repeated
            # spec keeps one state slot.
            rules = {r.name: r for r in builtin_rules()}
            for spec in config.alert_rules:
                rule = parse_rule(spec)
                rules[rule.name] = rule
            self.alerts = AlertEngine(
                config.alert_url,
                rules.values(),
                registry=self.registry,
                recorder=self.flight,
                retries=config.alert_retries,
                backoff_s=config.alert_backoff_s,
                dedup_s=config.alert_dedup_s,
            )
        self.stats = ServiceStats(
            sink,
            registry=self.registry,
            health=self.health,
            recorder=self.flight,
            logger=stats_logger,
            alerts=self.alerts,
            archive=self.archive,
            sentinel=self.sentinel,
        )
        # Runtime introspection: point the process-global build tracker at
        # this daemon's registry + event stream (retrace_storm rides the
        # stream into the alert engine like every other signal), and arm
        # the resource sampler feeding gauges + the flight ring.
        INTROSPECTOR.attach(
            registry=self.registry,
            stats=self.stats,
            storm_threshold=config.retrace_storm_threshold,
        )
        # Disk-full degradation: every persistent writer routes its appends
        # through a DegradedWriter, so ENOSPC degrades the feature (dropped
        # flight/archive records, memory-only cache, non-durable journal)
        # instead of taking the daemon down.  flight/archive are built
        # before stats exists, so their writers attach post-hoc.
        if self.flight is not None:
            self.flight.writer = DegradedWriter("flight", self.stats)
        if self.archive is not None:
            self.archive.writer = DegradedWriter("archive", self.stats)
        self.sampler = None
        if config.resource_sample_s > 0:
            self.sampler = ResourceSampler(
                self.registry,
                interval_s=config.resource_sample_s,
                capacity=config.resource_capacity,
                recorder=self.flight,
            )
        self.dashboard = None
        # Kernel launches (``launch_counts``) as a counter family, brought
        # up to date before each /metrics render and stats reply.
        self._m_launches = self.registry.counter(
            "verifyd_kernel_launches_total",
            "Kernel launches on this daemon's escalations (where: inline = "
            "this process, children = reported by supervised children)",
            labelnames=("kernel", "where"),
        )
        self._launch_metric_lock = threading.Lock()
        # Durable telemetry: periodic registry snapshots delta-encoded
        # into multi-resolution seglog rings.  Built after stats (the
        # degraded-writer + telemetry_loaded sinks) and after the
        # sentinel, whose baselines the previous run's history re-seeds —
        # a slowdown across a restart still fires perf_regression.
        self.telemetry = None
        self._telemetry_dir = None
        if config.telemetry_sample_s > 0:
            tdir = config.telemetry_dir or (
                telemetry_default_dir(config.state_dir)
                if config.state_dir
                else None
            )
            if tdir:
                self._telemetry_dir = tdir
                self.telemetry = TelemetryStore(
                    tdir,
                    self.registry,
                    sample_s=config.telemetry_sample_s,
                    fsync=config.fsync,
                )
                self.telemetry.writer = DegradedWriter("telemetry", self.stats)
                seeded = 0
                if self.sentinel is not None:
                    _boot_t, boot_values = self.telemetry.boot_values()
                    seeded = seed_from_telemetry(self.sentinel, boot_values)
                recs = self.telemetry.recovery_summary().values()
                self.stats.emit(
                    "telemetry_loaded",
                    dir=tdir,
                    records=sum(r["records"] for r in recs),
                    segments=sum(r["segments"] for r in recs),
                    torn_tail_bytes=sum(r["torn_tail_bytes"] for r in recs),
                    bad_segments=sum(r["bad_segments"] for r in recs),
                    baselines_seeded=seeded,
                )
        verdict_dir = (
            os.path.join(config.state_dir, "verdicts") if config.state_dir else None
        )
        self._cache_writer = (
            DegradedWriter("cache", self.stats) if verdict_dir is not None else None
        )
        self.cache = VerdictCache(
            config.cache_capacity,
            verdict_dir,
            fsync=config.fsync,
            writer=self._cache_writer,
        )
        if verdict_dir is not None:
            rec = self.cache.recovery
            self.stats.emit(
                "cache_loaded",
                entries=self.cache.loaded,
                segments=rec.segments if rec else 0,
                torn_tail_bytes=rec.torn_tail_bytes if rec else 0,
                bad_segments=rec.bad_segments if rec else 0,
            )
        self.prefix = None
        self._prefix_writer = None
        if config.prefix_enabled:
            prefix_dir = (
                os.path.join(config.state_dir, PREFIX_SUBDIR)
                if config.state_dir
                else None
            )
            self._prefix_writer = (
                DegradedWriter("prefix", self.stats)
                if prefix_dir is not None
                else None
            )
            self.prefix = PrefixStore(
                config.prefix_capacity,
                prefix_dir,
                fsync=config.fsync,
                max_segments=config.prefix_max_segments,
                writer=self._prefix_writer,
            )
            if prefix_dir is not None:
                rec = self.prefix.recovery
                self.stats.emit(
                    "prefix_loaded",
                    entries=self.prefix.loaded,
                    bytes=self.prefix.bytes,
                    segments=rec.segments if rec else 0,
                    torn_tail_bytes=rec.torn_tail_bytes if rec else 0,
                    bad_segments=rec.bad_segments if rec else 0,
                )
        self.journal = (
            JobJournal(os.path.join(config.state_dir, "journal"), fsync=config.fsync)
            if config.state_dir
            else None
        )
        self._journal_writer = None
        if self.journal is not None:
            # Journal ENOSPC is the one degradation the client must *see*:
            # replies carry durable=false, /healthz goes unhealthy with the
            # reason, and the writer_degraded alert fires.  Recovery (disk
            # freed, reprobe write succeeds) re-arms durability and clears
            # the health reason.
            self._journal_writer = DegradedWriter(
                "journal",
                self.stats,
                on_degrade=lambda e: self.health.set_degraded("journal", error=e),
                on_recover=lambda: self.health.clear_degraded("journal"),
            )
        self.quarantine = None
        if config.state_dir:
            self.quarantine = QuarantineStore(
                os.path.join(config.state_dir, "quarantine"),
                threshold=config.quarantine_threshold,
                stats=self.stats,
            )
            self.stats.set_quarantine_size(len(self.quarantine))
        self.queue = AdmissionQueue(
            config.queue_depth, retry_hint=self.stats.retry_after_hint
        )
        self.device_pool = None
        if config.mesh_devices and config.device != "off":
            from .devicepool import DevicePool

            self.device_pool = DevicePool(config.mesh_devices, stats=self.stats)
        # retry_after hints fold supervised lease-wait estimates in: the
        # stats object reads pool waiters straight off this snapshot.
        self.stats.device_pool = self.device_pool
        self.admission = AdmissionController(
            self.stats,
            max_rss_frac=config.max_rss_frac,
            sampler=self.sampler,
        )
        self.progress = None
        if config.progress_interval_s > 0:
            from .progress import JobProgress

            self.progress = JobProgress(
                interval_s=config.progress_interval_s,
                on_heartbeat=self._emit_progress,
            )
        self.scheduler = Scheduler(
            self.queue,
            self.cache,
            self.stats,
            time_budget_s=config.time_budget_s,
            device=config.device,
            unbounded_close=config.unbounded_close,
            batch_max=config.batch_max,
            out_dir=config.out_dir,
            spool_dir=config.spool_dir,
            device_rows=config.device_rows,
            attempt_timeout_s=config.attempt_timeout_s,
            max_restarts=config.max_restarts,
            journal=self.journal,
            tracer=self.tracer,
            profile=config.profile,
            device_pool=self.device_pool,
            lease_timeout_s=config.lease_timeout_s,
            journal_writer=self._journal_writer,
            quarantine=self.quarantine,
            cancel_grace_s=config.deadline_grace_s,
            progress=self.progress,
            prune=config.prune,
            speculate_depth=config.speculate_depth,
            batching=config.batching,
            batch_engine=config.batch_engine,
            prefix_store=self.prefix,
            torch_device=config.torch_device,
        )
        #: distributed-search partition grants: (search, part) -> epoch.
        #: Bounded (oldest evicted) — a coordinator that never closes its
        #: grants must not leak backend memory.  Loop-thread owned.
        self._grants: dict[tuple[str, str], int] = {}
        #: in-flight partition jobs by (search, part), for revocation
        self._part_jobs: dict[tuple[str, str], CancelToken] = {}
        self._job_ids = itertools.count(1)
        #: submits between dispatch and reply-written (loop thread owns
        #: the writes; the drain poller only reads)
        self._inflight = 0
        self._drain_lock = threading.Lock()
        self._draining = False
        self._drain_thread: threading.Thread | None = None
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._stop: asyncio.Future | None = None
        self._startup_error: BaseException | None = None
        #: bound port of the TCP listener (set before __enter__ returns)
        self.tcp_port: int | None = None
        #: bound port of the /metrics listener (set in __enter__)
        self.metrics_port: int | None = None
        self._metrics_server: MetricsServer | None = None

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "Verifyd":
        if self.sampler is not None:
            self.sampler.start()
        if self.telemetry is not None:
            self.telemetry.start()
        if self.cfg.metrics_port is not None:
            if self.cfg.dashboard_sample_s > 0:
                self.dashboard = Dashboard(
                    self.registry,
                    health=self.health,
                    sampler=self.sampler,
                    interval_s=self.cfg.dashboard_sample_s,
                    capacity=self.cfg.dashboard_capacity,
                    progress_fn=(
                        self.progress.rows
                        if self.progress is not None
                        else None
                    ),
                ).start()
            self._metrics_server = MetricsServer(
                self.registry,
                self.cfg.metrics_port,
                health=self.health,
                sentinel=self.sentinel,
                dashboard=self.dashboard,
                refresh=self._refresh_launch_metrics,
            )
            self.metrics_port = self._metrics_server.port
        self._recover_orphans()
        self.scheduler.start(self.cfg.workers)
        self.stats.emit(
            "serve_start",
            socket=self.cfg.socket_path,
            tcp=self.cfg.tcp,
            workers=self.cfg.workers,
            queue_depth=self.cfg.queue_depth,
            pid=os.getpid(),
            mesh_devices=self.cfg.mesh_devices,
        )
        self._thread = threading.Thread(
            target=self._run, name="verifyd-accept", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError(
                f"verifyd failed to start on {self.cfg.socket_path}"
            )
        if self._startup_error is not None:
            raise RuntimeError(
                f"verifyd failed to start on {self.cfg.socket_path}"
            ) from self._startup_error
        return self

    def __exit__(self, *exc) -> None:
        self.request_stop()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.scheduler.stop()
        if self._metrics_server is not None:
            self._metrics_server.close()
        if self.dashboard is not None:
            self.dashboard.close()
        if self.sampler is not None:
            # Final sample first: the flight ring's last resource record
            # should reflect the moment of shutdown, not a second before.
            with contextlib.suppress(Exception):
                self.sampler.sample_once()
            self.sampler.close()
        if self.telemetry is not None:
            # Close takes a final sample and flushes the pending coarse
            # buckets, so the history's last point is the shutdown state.
            with contextlib.suppress(Exception):
                self._refresh_launch_metrics()
                self.telemetry.close()
        self.stats.emit("serve_stop", **self.stats.snapshot())
        self.dump_flight("shutdown")
        if self.alerts is not None:
            # Drain pending deliveries while the flight ring can still
            # absorb alert_failed markers.
            self.alerts.close()
        if self.flight is not None:
            self.flight.close()
        if self.archive is not None:
            self.archive.close()
        self.cache.close()
        if self.prefix is not None:
            self.prefix.close()
        if self.journal is not None:
            self.journal.close()
        if self._stats_file is not None:
            with contextlib.suppress(OSError):
                self._stats_file.close()
        with contextlib.suppress(FileNotFoundError):
            os.remove(self.cfg.socket_path)

    def _recover_orphans(self) -> None:
        """Journal replay: re-admit jobs a previous run accepted but never
        answered.  Runs before the acceptor and the workers start, so
        recovered jobs are first in line; their verdicts land in the
        (durable) cache, which is what answers the submitter's retry."""
        if self.journal is None:
            return
        for rec in self.journal.orphans():
            text = rec.get("history", "")
            fp = str(rec.get("fp") or "")
            if self.quarantine is not None and fp:
                # Poison accounting BEFORE re-admission: an orphan a worker
                # had *started* (journal "run" record) when the process
                # died is one crash against its fingerprint.  Queued-only
                # orphans are innocent bystanders — replayed for free.
                if rec.get("started"):
                    self.quarantine.note_crash(fp, kind="boot")
                if self.quarantine.is_quarantined(fp):
                    self.stats.emit(
                        "orphan_quarantined",
                        fingerprint=fp,
                        client=rec.get("client"),
                        crashes=self.quarantine.crash_count(fp),
                    )
                    continue  # compact() below drops the accept for good
            try:
                events = list(ev.iter_history(text))
                hist = prepare(events, elide_trivial=True)
            except (ev.DecodeError, ValueError) as e:
                self.stats.emit(
                    "orphan_invalid",
                    fingerprint=rec.get("fp"),
                    client=rec.get("client"),
                    reason=str(e)[:200],
                )
                continue
            job = Job(
                id=next(self._job_ids),
                client=str(rec.get("client") or "anon"),
                priority=int(rec.get("priority") or 10),
                shape=shape_key(hist),
                fingerprint=history_fingerprint(hist),
                events=events,
                hist=hist,
                no_viz=True,  # the submitter is gone; re-run for the verdict
                trace_id=new_trace_id(),
            )
            self.journal.accept(
                job=job.id,
                fingerprint=job.fingerprint,
                client=job.client,
                priority=job.priority,
                history=text,
            )
            if self.archive is not None:
                self.archive.add_history(job.fingerprint, text)
            job.enqueued_at = self.tracer.now()
            try:
                self.queue.put(job)
            except QueueFull:
                # Reported, not silent — and the journal still holds the
                # accept, so the *next* restart retries the re-admission.
                self.stats.emit(
                    "orphan_dropped", job=job.id, fingerprint=job.fingerprint
                )
                continue
            self.stats.emit(
                "orphan",
                job=job.id,
                fingerprint=job.fingerprint,
                client=job.client,
                from_boot=rec.get("boot"),
            )
        self.journal.compact()

    def dump_flight(self, reason: str) -> None:
        """Write a flight-recorder marker with the SLO picture at this
        instant (shutdown path, SIGTERM handler).  Safe without a state
        dir (no-op) and safe to call more than once."""
        if self.flight is not None:
            self.flight.dump(reason, slo=self.health.snapshot())

    def request_drain(self, timeout_s: float | None = None) -> float:
        """Graceful drain, then stop (drain-flagged shutdown op, SIGTERM
        under ``serve --drain-timeout``).  Thread-safe and idempotent.

        Closes the admission queue immediately — new submits answer
        ``ShuttingDown``, workers finish what is queued — then a
        background thread waits until every dispatched submit has its
        reply written, the queue is empty, and no worker holds an active
        job (or the budget runs out), and finally triggers the normal
        stop path, which closes the journal and verdict segments
        cleanly.  Cache hits keep answering throughout: they touch no
        queue slot and cost nothing.  Returns the effective budget.
        """
        t = float(
            timeout_s
            if timeout_s is not None
            else (self.cfg.drain_timeout_s or 30.0)
        )
        with self._drain_lock:
            if self._draining:
                return t
            self._draining = True

        def _drain() -> None:
            self.queue.close()
            self.stats.emit(
                "drain_start",
                queued=len(self.queue),
                inflight=self._inflight,
                active=self.stats.active,
                timeout_s=t,
            )
            t0 = time.monotonic()
            while time.monotonic() - t0 < t:
                if (
                    self._inflight == 0
                    and len(self.queue) == 0
                    and self.stats.active == 0
                ):
                    break
                time.sleep(0.05)
            waited = time.monotonic() - t0
            clean = (
                self._inflight == 0
                and len(self.queue) == 0
                and self.stats.active == 0
            )
            self.stats.emit(
                "drain_done", waited_s=round(waited, 3), clean=clean
            )
            self.dump_flight("drain")
            self.request_stop()

        self._drain_thread = threading.Thread(
            target=_drain, name="verifyd-drain", daemon=True
        )
        self._drain_thread.start()
        return t

    def request_stop(self) -> None:
        """Thread-safe stop trigger (shutdown op, signal handler)."""
        self._stopped.set()
        if self._loop is not None and self._stop is not None:
            def _finish() -> None:
                if not self._stop.done():
                    self._stop.set_result(None)

            with contextlib.suppress(RuntimeError):
                self._loop.call_soon_threadsafe(_finish)

    def wait(self) -> None:
        """Block until a shutdown request (or KeyboardInterrupt)."""
        try:
            self._stopped.wait()
        except KeyboardInterrupt:
            pass

    def serve_forever(self) -> int:
        with self:
            log.info(
                "verifyd listening on %s%s (queue depth %d, %d workers, "
                "device=%s)",
                self.cfg.socket_path,
                f" + tcp {self.cfg.tcp} (port {self.tcp_port})"
                if self.cfg.tcp
                else "",
                self.cfg.queue_depth,
                self.cfg.workers,
                self.cfg.device,
            )
            self.wait()
        return 0

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:
            self._startup_error = e
        finally:
            self._started.set()
            self._stopped.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = self._loop.create_future()
        # The stream limit IS the frame bound: readuntil past it raises
        # LimitOverrunError, answered as a definite FrameTooLarge.
        server = await asyncio.start_unix_server(
            functools.partial(self._handle, secret=None, deadline_s=None),
            path=self.cfg.socket_path,
            limit=self.cfg.frame_max_bytes,
        )
        tcp_server = None
        if self.cfg.tcp is not None:
            host, port = parse_hostport(self.cfg.tcp)
            tcp_server = await asyncio.start_server(
                functools.partial(
                    self._handle,
                    secret=self.cfg.secret,
                    deadline_s=self.cfg.conn_deadline_s,
                ),
                host=host,
                port=port,
                limit=self.cfg.frame_max_bytes,
            )
            self.tcp_port = tcp_server.sockets[0].getsockname()[1]
        self._started.set()
        try:
            await self._stop
        finally:
            server.close()
            await server.wait_closed()
            if tcp_server is not None:
                tcp_server.close()
                await tcp_server.wait_closed()

    # -- connection handling ------------------------------------------------

    async def _read_frame(
        self, reader: asyncio.StreamReader, deadline_s: float | None
    ) -> bytes | None:
        """One frame, bounded in size (stream limit) and, on TCP, in read
        time.  Returns None on clean EOF; raises the caller's per-frame
        protocol failures as marker exceptions."""
        fut = reader.readuntil(b"\n")
        if deadline_s is not None:
            fut = asyncio.wait_for(fut, timeout=deadline_s)
        try:
            return await fut
        except asyncio.IncompleteReadError as e:
            return e.partial or None  # truncated final frame or clean EOF

    async def _handle(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        *,
        secret: bytes | None,
        deadline_s: float | None,
    ) -> None:
        try:
            while True:
                try:
                    line = await self._read_frame(reader, deadline_s)
                except (asyncio.LimitOverrunError, ValueError):
                    # Oversized frame: a definite protocol error, then
                    # close — the stream cannot be resynced past it.
                    self.stats.emit("frame_error", reason="oversized")
                    resp = err(
                        ERR_TOO_LARGE,
                        f"frame exceeds {self.cfg.frame_max_bytes} bytes",
                    )
                    await self._reply(writer, resp, secret)
                    break
                except asyncio.TimeoutError:
                    self.stats.emit("frame_error", reason="read_deadline")
                    break
                if not line:
                    break
                close_after = False
                inflight = False
                try:
                    try:
                        req = decode_frame(line)
                    except ValueError as e:
                        self.stats.emit("frame_error", reason="decode")
                        resp = err(ERR_FRAME, f"malformed frame: {e}")
                    else:
                        if secret is not None and not verify_frame(req, secret):
                            # Rejected before admission: nothing below the
                            # transport ever sees an unauthenticated frame.
                            peer = writer.get_extra_info("peername")
                            self.stats.emit(
                                "auth_reject", op=req.get("op"), peer=str(peer)
                            )
                            resp = err(ERR_AUTH, "missing or invalid frame auth")
                            close_after = True
                        else:
                            if req.get("op") in ("submit", "follow", "delta"):
                                # Drain counts a submit (or follow window)
                                # until its reply is *written* — an accepted
                                # job whose verdict never reached the client
                                # is a lost job.
                                inflight = True
                                # Single-threaded by construction: every
                                # _handle coroutine runs on the accept
                                # loop's event loop, so +=/-= never
                                # interleave; the drain poller thread only
                                # reads the counter (a stale read just
                                # re-polls).
                                self._inflight += 1  # verifylint: disable=concurrency-unlocked-write
                            resp = await self._dispatch(req, reader)
                    await self._reply(writer, resp, secret)
                finally:
                    if inflight:
                        self._inflight -= 1
                if close_after:
                    break
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _reply(
        self, writer: asyncio.StreamWriter, resp: dict, secret: bytes | None
    ) -> None:
        if secret is not None:
            resp = sign_frame(resp, secret)
        writer.write(encode_frame(resp))
        await writer.drain()

    def launch_counts(self) -> dict:
        """Kernel launches on this daemon's escalations: ``inline`` counts
        the fold launches of this process (the inline device search; zero
        unless ``ops/fold_cuda.py`` was loaded here), ``children`` the
        launches the supervised children reported."""
        fold = sys.modules.get("s2_verification_tpu_torch.ops.fold_cuda")
        return {
            "inline": dict(fold.LAUNCHES) if fold is not None else {},
            "children": dict(self.scheduler.child_launches),
        }

    def _refresh_launch_metrics(self) -> None:
        """Bring ``verifyd_kernel_launches_total`` up to
        :meth:`launch_counts` (before every /metrics render, stats reply
        and the telemetry store's final sample)."""
        with self._launch_metric_lock:
            for where, counts in self.launch_counts().items():
                if where not in ("inline", "children"):
                    where = "other"
                # The kernel label's closed set is ops/fold_cuda.LAUNCHES's
                # keys, written out so that the daemon never loads torch;
                # any other kernel a child reports is summed under "other".
                folded = {"fold_lanes": counts.get("fold_lanes", 0)}
                folded["other"] = sum(counts.values()) - folded["fold_lanes"]
                for kernel in ("fold_lanes", "other"):
                    delta = folded[kernel] - self._m_launches.value(kernel=kernel, where=where)
                    if delta > 0:
                        self._m_launches.inc(delta, kernel=kernel, where=where)

    async def _dispatch(
        self, req: dict, reader: asyncio.StreamReader | None = None
    ) -> dict:
        op = req.get("op")
        try:
            if op == "ping":
                return ok(
                    {
                        "server": "verifyd",
                        "version": _version.__version__,
                        "protocol": PROTOCOL_VERSION,
                        "pid": os.getpid(),
                    }
                )
            if op == "stats":
                snap = self.stats.snapshot()
                snap["queue_depth_now"] = len(self.queue)
                snap["cache_entries"] = len(self.cache)
                if self.metrics_port is not None:
                    snap["metrics_port"] = self.metrics_port
                if self.device_pool is not None:
                    snap["device_pool"] = self.device_pool.snapshot()
                self._refresh_launch_metrics()
                introspection: dict = {
                    "jit": INTROSPECTOR.snapshot(),
                    "launches": self.launch_counts(),
                }
                if self.sampler is not None:
                    introspection["resources"] = self.sampler.snapshot()
                snap["introspection"] = introspection
                if self.progress is not None:
                    snap["progress"] = self.progress.rows()
                if self.telemetry is not None:
                    snap["telemetry"] = {
                        "dir": self._telemetry_dir,
                        "sample_s": self.cfg.telemetry_sample_s,
                        "recovery": self.telemetry.recovery_summary(),
                    }
                return ok(snap)
            if op == "tsq":
                if self._telemetry_dir is None:
                    return err(
                        ERR_DECODE,
                        "no telemetry store (daemon runs without "
                        "--state-dir or --telemetry-dir)",
                    )
                payload, bad = tsq_request(
                    self._telemetry_dir, req, store=self.telemetry
                )
                if bad is not None:
                    return err(ERR_DECODE, bad)
                return ok(payload)
            if op == "watch":
                return self._watch(req)
            if op == "trace":
                return ok(self.tracer.export())
            if op == "profiles":
                if self.archive is None:
                    return err(
                        ERR_DECODE,
                        "no profile archive (daemon runs without --state-dir)",
                    )
                filters = {}
                for key in ("shape", "backend", "client"):
                    if req.get(key) is not None:
                        filters[key] = str(req[key])
                for key in ("verdict", "slowest", "limit"):
                    if req.get(key) is not None:
                        try:
                            filters[key] = int(req[key])
                        except (TypeError, ValueError):
                            return err(
                                ERR_DECODE, f"{key} must be an int"
                            )
                if req.get("since") is not None:
                    try:
                        filters["since"] = float(req["since"])
                    except (TypeError, ValueError):
                        return err(ERR_DECODE, "since must be a number")
                # Bound the reply frame unless the caller chose a cut.
                if "limit" not in filters and "slowest" not in filters:
                    filters["limit"] = 100
                return ok(
                    {
                        "records": self.archive.query(**filters),
                        "total": len(self.archive),
                    }
                )
            if op == "shutdown":
                if req.get("drain"):
                    tmo = req.get("timeout")
                    try:
                        tmo = float(tmo) if tmo is not None else None
                    except (TypeError, ValueError):
                        return err(ERR_DECODE, "timeout must be a number")
                    effective = self.request_drain(tmo)
                    return ok(
                        {
                            "stopping": True,
                            "draining": True,
                            "timeout_s": effective,
                        }
                    )
                self.request_stop()
                return ok({"stopping": True})
            if op == "quarantine":
                if self.quarantine is None:
                    return err(
                        ERR_DECODE,
                        "no quarantine store (daemon runs without --state-dir)",
                    )
                action = str(req.get("action") or "list")
                if action == "list":
                    return ok(
                        {
                            "entries": self.quarantine.list(),
                            "threshold": self.quarantine.threshold,
                        }
                    )
                fp = str(req.get("fingerprint") or "")
                if not fp:
                    return err(
                        ERR_DECODE, f"quarantine {action!r} needs a fingerprint"
                    )
                if action == "inspect":
                    info = self.quarantine.get(fp)
                    if info is None:
                        return err(ERR_DECODE, f"{fp!r} is not quarantined")
                    return ok(info)
                if action == "release":
                    return ok(
                        {
                            "released": self.quarantine.release(fp),
                            "fingerprint": fp,
                        }
                    )
                return err(ERR_DECODE, f"unknown quarantine action {action!r}")
            if op == "submit":
                return await self._submit(req, reader)
            if op == "follow":
                return await self._follow(req, reader)
            if op == "grant":
                return self._ds_grant(req)
            if op == "delta":
                return await self._ds_delta(req, reader)
            if op == "partition_done":
                return self._ds_done(req)
            return err(ERR_DECODE, f"unknown op {op!r}")
        except Exception as e:  # protocol handler must never kill the loop
            log.exception("dispatch failed for op %r", op)
            return err(ERR_INTERNAL, repr(e))

    def _emit_progress(self, row: dict) -> None:
        """JobProgress heartbeat hook → the ``search_progress`` event
        (flight ring, metrics, archive all ride the normal emit path)."""
        self.stats.emit(
            "search_progress",
            job=row["job"],
            engine=row["engine"],
            ops_committed=row["ops_committed"],
            total_ops=row["total_ops"],
            frontier_width=row["frontier_width"],
            states_expanded=row["states_expanded"],
            layer_rate=row["layer_rate"],
            progress_ratio=row["progress_ratio"],
            eta_s=row["eta_s"],
            fingerprint=row["fingerprint"],
            trace_id=row["trace_id"],
        )

    def _watch(self, req: dict) -> dict:
        """One-shot progress snapshot of running (or just-done) searches.

        Selectors: ``job`` (one id), ``fingerprint`` (verdict-cache key;
        how a distsearch coordinator polls its ``ppart:`` partition
        jobs), ``search`` (+ optional ``part``: every partition of a
        distributed search running here), or none (all active jobs).  A
        named selector with no match is the definite
        :data:`~.protocol.ERR_UNKNOWN_JOB` — the router forwards it
        rather than failing over."""
        if self.progress is None:
            return err(
                ERR_DECODE,
                "progress heartbeats disabled (progress_interval_s <= 0)",
            )
        if req.get("job") is not None:
            try:
                job = int(req["job"])
            except (TypeError, ValueError):
                return err(ERR_DECODE, "job must be an int")
            row = self.progress.get(job)
            if row is None:
                return err(
                    ERR_UNKNOWN_JOB, f"job {job} is not running here", job=job
                )
            return ok({"progress": [row]})
        if req.get("fingerprint") is not None:
            fp = str(req["fingerprint"])
            rows = self.progress.find(fp)
            if not rows:
                return err(
                    ERR_UNKNOWN_JOB, f"no running job for fingerprint {fp!r}"
                )
            return ok({"progress": rows})
        if req.get("search") is not None:
            search = str(req["search"])
            rows = self.progress.find(f"ppart:{search[:16]}/", prefix=True)
            if req.get("part") is not None:
                part = str(req["part"])
                rows = [
                    r for r in rows if r["fingerprint"].rsplit("/", 1)[-1] == part
                ]
            if not rows:
                return err(
                    ERR_UNKNOWN_JOB,
                    f"no partition of search {search[:16]!r} runs here",
                )
            return ok({"progress": rows})
        return ok({"progress": self.progress.rows()})

    def _decode_history(
        self, text, records, client: str
    ) -> tuple[str | None, list, object] | dict:
        """Validate and prepare one history payload, returning ``(text,
        events, hist)`` or an error frame.

        Fast admission first: one fused parse+pair+validate+build pass
        (service/fastprep.py).  Fallback-not-fork: anything the fast path
        won't vouch for re-runs through the layered decoder below, which
        produces the canonical error message for every rejection.
        """
        if records is not None:
            # Structured submission: the client ships the event records as
            # a JSON array instead of a JSONL string, skipping one
            # serialize/parse round-trip on the hot path.  The journal and
            # corpus archive still get canonical JSONL (``wire_text``).
            if not isinstance(records, list) or not records:
                self.stats.emit("decode_error", reason="bad records")
                return err(
                    ERR_DECODE, "'records' must be a non-empty list of event objects"
                )
            if text is not None:
                return err(ERR_DECODE, "send 'history' or 'records', not both")
        elif not isinstance(text, str) or not text.strip():
            self.stats.emit("decode_error", reason="missing history")
            return err(ERR_DECODE, "submit needs a non-empty 'history' JSONL string")
        prep = None
        if self.cfg.fast_admission:
            try:
                prep = fast_prepare(text=text, records=records)
            except FastPrepFallback:
                prep = None
        if prep is not None:
            events = prep.events
            hist = prep.hist
            if text is None:
                text = prep.wire_text()
            return text, events, hist
        if text is None:
            try:
                text = "\n".join(
                    json.dumps(r, separators=(",", ":")) for r in records
                )
            except (TypeError, ValueError) as e:
                self.stats.emit(
                    "decode_error", client=client, reason=str(e)[:200]
                )
                return err(
                    ERR_DECODE, f"'records' are not JSON-serializable: {e}"
                )
        try:
            events = list(ev.iter_history(text))
            hist = prepare(events, elide_trivial=True)
        except (ev.DecodeError, ValueError) as e:
            self.stats.emit("decode_error", client=client, reason=str(e)[:200])
            return err(ERR_DECODE, str(e))
        return text, events, hist

    async def _submit(
        self, req: dict, reader: asyncio.StreamReader | None = None
    ) -> dict:
        t_recv = self.tracer.now()
        # Distributed trace context: honor a client-minted id (new
        # clients), mint one otherwise (old clients) — every job traces.
        trace_id, sent_wall = parse_trace_frame(req.get(TRACE_FIELD))
        if trace_id is None:
            trace_id = new_trace_id()
        text = req.get("history")
        records = req.get("records")
        client = str(req.get("client") or "anon")
        try:
            priority = int(req.get("priority", 10))
        except (TypeError, ValueError):
            return err(ERR_DECODE, f"priority must be an int, got {req.get('priority')!r}")
        no_viz = bool(req.get("no_viz", self.cfg.no_viz))
        # Remaining end-to-end budget in seconds.  Optional (old clients
        # never send it), HMAC-covered like every frame field, and already
        # decremented by any router hop the frame crossed.
        deadline = req.get("deadline")
        if deadline is not None:
            try:
                deadline = float(deadline)
            except (TypeError, ValueError):
                return err(
                    ERR_DECODE, f"deadline must be a number, got {deadline!r}"
                )

        t_prep0 = self.tracer.now()
        decoded = self._decode_history(text, records, client)
        if isinstance(decoded, dict):
            return decoded
        text, events, hist = decoded
        t_prep1 = self.tracer.now()

        fingerprint = history_fingerprint(hist)
        cached = self.cache.get(fingerprint)
        if cached is not None:
            self.stats.emit(
                "cache_hit",
                stage="admission",
                client=client,
                fingerprint=fingerprint,
                queue_wait_s=0.0,
            )
            self.tracer.add_span(
                "admit",
                t_recv,
                self.tracer.now(),
                tid=0,
                args={"client": client, "cached": True, "trace_id": trace_id},
            )
            cached.update(cached=True, queue_wait_s=0.0, trace_id=trace_id)
            return ok(cached)

        # Admission gates, in cost order, all BEFORE the journal sees the
        # job (a shed admission owes the client nothing on replay):
        # quarantine (definite — the router must not fail it over), dead
        # deadline, then pressure shedding with an honest retry_after.
        if self.quarantine is not None and self.quarantine.is_quarantined(
            fingerprint
        ):
            info = self.quarantine.get(fingerprint) or {}
            self.stats.emit(
                "quarantine_reject",
                client=client,
                fingerprint=fingerprint,
                crashes=info.get("crashes", 0),
                trace_id=trace_id,
            )
            return err(
                ERR_QUARANTINED,
                f"fingerprint {fingerprint[:12]} is quarantined after "
                f"{info.get('crashes', 0)} crash(es); "
                "`python -m s2_verification_tpu_torch quarantine release` re-admits it",
                fingerprint=fingerprint,
                crashes=info.get("crashes", 0),
            )
        shape = shape_key(hist)
        if deadline is not None and deadline <= 0:
            self.stats.emit(
                "admission_shed",
                reason="deadline",
                client=client,
                trace_id=trace_id,
            )
            return err(
                ERR_DEADLINE,
                "deadline already expired at admission",
                reason="deadline",
            )
        shed = self.admission.decide(
            queue_depth=len(self.queue), deadline_s=deadline, shape=shape
        )
        if shed is not None:
            self.stats.emit(
                "admission_shed",
                reason=shed,
                client=client,
                depth=len(self.queue),
                trace_id=trace_id,
            )
            if shed == "deadline":
                return err(
                    ERR_DEADLINE,
                    "cannot finish inside the deadline at the current "
                    "queue depth (observed per-shape wall time)",
                    reason=shed,
                )
            return err(
                ERR_QUEUE_FULL,
                f"admission shed under {shed} pressure",
                retry_after_s=self.stats.retry_after_hint(len(self.queue)),
                reason=shed,
                depth=len(self.queue),
            )

        # Prefix probe (service/prefixstore.py): fold the chain-hash
        # frontier of the incoming history, ask the store for the deepest
        # cached cut, and plan where the search snapshots next.  Planned
        # jobs run the resumable host-frontier engine in the scheduler.
        plan = None
        if self.prefix is not None:
            plan = plan_for_submit(
                self.prefix,
                hist,
                max_cuts=self.cfg.prefix_cuts,
                min_ops=self.cfg.prefix_min_ops,
            )
            if plan is not None:
                plan.total_events = len(events)
                if plan.carry is not None:
                    self.stats.emit(
                        "prefix_hit",
                        client=client,
                        resume_ops=plan.resume_ops,
                        ops=len(hist.ops),
                        depth_frac=round(
                            plan.resume_ops / max(1, len(hist.ops)), 4
                        ),
                        probed=plan.probed,
                        trace_id=trace_id,
                    )
                    # A resumed search replays no linearization prefix: the
                    # witness would be partial, so the artifact is skipped.
                    no_viz = True
                else:
                    self.stats.emit(
                        "prefix_miss",
                        client=client,
                        ops=len(hist.ops),
                        probed=plan.probed,
                        trace_id=trace_id,
                    )
                if plan.refused:
                    self.stats.emit(
                        "prefix_refused",
                        op="submit",
                        reason=plan.refused,
                        client=client,
                        trace_id=trace_id,
                    )

        cancel = CancelToken(
            time.monotonic() + deadline if deadline is not None else None
        )
        job = Job(
            id=next(self._job_ids),
            client=client,
            priority=priority,
            shape=shape,
            fingerprint=fingerprint,
            events=events,
            hist=hist,
            no_viz=no_viz,
            trace_id=trace_id,
            cancel=cancel,
            prefix=plan,
        )
        fut: asyncio.Future = self._loop.create_future()

        def _resolve(reply: dict) -> None:
            def _finish() -> None:
                if not fut.done():
                    fut.set_result(reply)

            with contextlib.suppress(RuntimeError):  # loop already closed
                self._loop.call_soon_threadsafe(_finish)

        job.resolve = _resolve
        # Write-ahead: the accept record lands before the queue sees the
        # job, so a daemon killed in between owes (and replays) the job
        # rather than silently dropping an admission the client saw.  The
        # append runs through the journal's DegradedWriter: on a full
        # disk the job still runs, but the reply says durable=false.
        durable = False
        if self.journal is not None:
            _, durable = self._journal_writer.run(
                lambda: self.journal.accept(
                    job=job.id,
                    fingerprint=fingerprint,
                    client=client,
                    priority=priority,
                    history=text,
                )
            )
        if self.archive is not None:
            # One corpus entry per fingerprint: the archived workload is
            # replayable even after the stats sink is long gone.
            self.archive.add_history(fingerprint, text)
        try:
            depth = self.queue.put(job)
        except QueueFull as e:
            if self.journal is not None:
                self._journal_writer.run(lambda: self.journal.reject(job.id))
            self.stats.emit(
                "reject",
                client=client,
                priority=priority,
                depth=e.depth,
                retry_after_s=e.retry_after_s,
            )
            return err(
                ERR_QUEUE_FULL,
                str(e),
                retry_after_s=e.retry_after_s,
                depth=e.depth,
            )
        except RuntimeError as e:  # queue closed: daemon is stopping
            if self.journal is not None:
                self._journal_writer.run(lambda: self.journal.reject(job.id))
            return err(ERR_SHUTTING_DOWN, str(e))
        job.enqueued_at = self.tracer.now()
        self.stats.emit(
            "admit",
            job=job.id,
            client=client,
            priority=priority,
            shape=job.shape,
            depth=depth,
            trace_id=trace_id,
        )
        self.stats.set_queue_depth(depth)
        if self.tracer.enabled:
            self.tracer.name_track(job.id, f"job {job.id} ({client})")
            if sent_wall is not None:
                # Client-origin span: network + connect + queueing before
                # the daemon saw the frame.  sent_wall is the client's
                # wall clock, mapped onto our monotonic timeline and
                # clamped to t_recv so skew can't produce negative wait.
                t_sent = min(t_recv, self.tracer.mono_of_wall(sent_wall))
                self.tracer.add_span(
                    "client_wait",
                    t_sent,
                    t_recv,
                    tid=job.id,
                    cat="client",
                    args={"trace_id": trace_id, "origin": "client"},
                )
            self.tracer.add_span(
                "prepare", t_prep0, t_prep1, tid=job.id,
                args={"trace_id": trace_id},
            )
            self.tracer.add_span(
                "admit",
                t_recv,
                job.enqueued_at,
                tid=job.id,
                args={
                    "client": client,
                    "shape": job.shape,
                    "depth": depth,
                    "trace_id": trace_id,
                },
            )
        reply = await self._await_reply(fut, job, reader)
        if self.journal is not None and isinstance(reply.get("ok"), dict):
            # Honest durability: false when the accept record never hit
            # disk OR the journal degraded while the job ran (the done
            # record is then also non-durable).
            reply["ok"]["durable"] = durable and not self._journal_writer.degraded
        return reply

    async def _await_reply(
        self,
        fut: asyncio.Future,
        job: Job,
        reader: asyncio.StreamReader | None,
    ) -> dict:
        """Wait for the worker's reply while watching the client socket.

        A peer that disconnects mid-submit (EOF or reset on ``reader``)
        cancels the job with reason ``client_gone`` so no worker stays
        pinned computing an answer nobody will read — the scheduler
        notices at its next cancellation boundary, the lease releases,
        and the (unwritable) reply just fails fast in ``_handle``.  The
        asyncio transport feeds EOF without a pending read, so polling
        ``at_eof()`` here never consumes a pipelined frame.
        """
        while True:
            done, _ = await asyncio.wait({fut}, timeout=0.2)
            if done:
                return fut.result()
            if reader is not None and (
                reader.at_eof() or reader.exception() is not None
            ):
                if job.cancel.cancel("client_gone"):
                    self.stats.emit(
                        "client_gone",
                        job=job.id,
                        client=job.client,
                        trace_id=job.trace_id,
                    )

    async def _follow(
        self, req: dict, reader: asyncio.StreamReader | None = None
    ) -> dict:
        """One window of a followed stream: verify the delta against the
        carried frontier and advance the durable frontier on OK.

        The window verdict is **window-scoped** — it answers "is the
        stream still linearizable given the committed prefix", not "is
        this standalone history linearizable" — so it never enters the
        verdict cache, the journal, or any router edge cache; the reply
        carries ``scope="window"`` precisely so caches can refuse it.
        A window with in-flight ops still gets a verdict, but the
        frontier does not advance (``advanced=false``): the client
        resends those events once their finishes arrive.
        """
        t_recv = self.tracer.now()
        trace_id, _ = parse_trace_frame(req.get(TRACE_FIELD))
        if trace_id is None:
            trace_id = new_trace_id()
        if self.prefix is None:
            return err(
                ERR_DECODE,
                "follow needs the prefix store (start verifyd with --prefix)",
            )
        stream = str(req.get("stream") or "")
        if not stream:
            return err(ERR_DECODE, "follow needs a non-empty 'stream' id")
        token = req.get("frontier")
        entry = None
        if token is not None:
            token = str(token)
            entry = self.prefix.get(token)
            if entry is None:
                # Evicted, never durable, or from another fleet member's
                # store: the client resyncs by submitting the full history.
                self.stats.emit(
                    "prefix_refused",
                    op="follow",
                    reason="unknown_frontier",
                    stream=stream,
                    trace_id=trace_id,
                )
                return err(
                    ERR_FRONTIER,
                    f"frontier {token!r} is not in the store (evicted or "
                    "never durable); resubmit the full history",
                    frontier=token,
                )
        client = str(req.get("client") or "anon")
        try:
            priority = int(req.get("priority", 10))
        except (TypeError, ValueError):
            return err(
                ERR_DECODE, f"priority must be an int, got {req.get('priority')!r}"
            )
        deadline = req.get("deadline")
        if deadline is not None:
            try:
                deadline = float(deadline)
            except (TypeError, ValueError):
                return err(
                    ERR_DECODE, f"deadline must be a number, got {deadline!r}"
                )
        decoded = self._decode_history(
            req.get("history"), req.get("records"), client
        )
        if isinstance(decoded, dict):
            return decoded
        _text, events, hist = decoded
        try:
            plan = plan_for_window(hist, token=token, entry=entry, stream=stream)
        except ValueError as e:
            return err(ERR_FRONTIER, str(e), frontier=token)
        plan.total_events = len(events)
        n = len(hist.ops)
        if plan.refused:
            self.stats.emit(
                "prefix_refused",
                op="follow",
                reason=plan.refused,
                stream=stream,
                window=plan.window,
                trace_id=trace_id,
            )
        if n == 0:
            # An all-trivial window: nothing to search (trivial ops cannot
            # change a verdict — checker/entries.py), so it is vacuously
            # OK; the frontier re-keys at the same cut with the event
            # horizon advanced, unless ops were left dangling.
            advanced = False
            if token is not None and not plan.refused:
                new_entry = make_entry(
                    plan.carry,
                    events=plan.base_events + len(events),
                    stream=stream,
                    window=plan.window,
                )
                try:
                    self.prefix.put(token, new_entry)
                    advanced = True
                except ValueError:
                    log.exception("follow re-key refused for %r", token)
            self.stats.emit(
                "window_done",
                stream=stream,
                window=plan.window,
                verdict=0,
                advanced=advanced,
                ops_total=plan.base_ops,
                trace_id=trace_id,
            )
            # Numeric verdict like every searched window (VERDICT_EXIT):
            # clients compare ``verdict == 0``, and a string here would
            # make them treat a vacuously-OK window as inconclusive.
            return ok(
                {
                    "verdict": 0,
                    "outcome": "OK",
                    "backend": "frontier-trivial",
                    "scope": "window",
                    "stream": stream,
                    "window": plan.window,
                    "ops": 0,
                    "ops_total": plan.base_ops,
                    "frontier": token,
                    "advanced": advanced,
                    "trace_id": trace_id,
                }
            )
        shape = shape_key(hist)
        cancel = CancelToken(
            time.monotonic() + deadline if deadline is not None else None
        )
        # The job "fingerprint" is the window's cut key (``pv2:...``) — a
        # namespace the verdict cache never stores, so the scheduler's
        # pre-start cache check always misses for window jobs.
        fingerprint = plan.snap_keys.get(n) or f"pwindow:{stream}/{plan.window}"
        job = Job(
            id=next(self._job_ids),
            client=client,
            priority=priority,
            shape=shape,
            fingerprint=fingerprint,
            events=events,
            hist=hist,
            no_viz=True,  # a window has no standalone witness to draw
            trace_id=trace_id,
            cancel=cancel,
            prefix=plan,
        )
        fut: asyncio.Future = self._loop.create_future()

        def _resolve(reply: dict) -> None:
            def _finish() -> None:
                if not fut.done():
                    fut.set_result(reply)

            with contextlib.suppress(RuntimeError):  # loop already closed
                self._loop.call_soon_threadsafe(_finish)

        job.resolve = _resolve
        try:
            depth = self.queue.put(job)
        except QueueFull as e:
            self.stats.emit(
                "reject",
                client=client,
                priority=priority,
                depth=e.depth,
                retry_after_s=e.retry_after_s,
            )
            return err(
                ERR_QUEUE_FULL,
                str(e),
                retry_after_s=e.retry_after_s,
                depth=e.depth,
            )
        except RuntimeError as e:  # queue closed: daemon is stopping
            return err(ERR_SHUTTING_DOWN, str(e))
        job.enqueued_at = self.tracer.now()
        self.stats.emit(
            "admit",
            job=job.id,
            client=client,
            priority=priority,
            shape=job.shape,
            depth=depth,
            trace_id=trace_id,
        )
        self.stats.set_queue_depth(depth)
        if self.tracer.enabled:
            self.tracer.name_track(
                job.id, f"follow {stream}#{plan.window} ({client})"
            )
            self.tracer.add_span(
                "admit",
                t_recv,
                job.enqueued_at,
                tid=job.id,
                args={
                    "client": client,
                    "stream": stream,
                    "window": plan.window,
                    "trace_id": trace_id,
                },
            )
        reply = await self._await_reply(fut, job, reader)
        body = reply.get("ok")
        if isinstance(body, dict):
            new_key = plan.snap_keys.get(n)
            # The frontier only advances when the worker actually stored
            # the end-of-window snapshot (OK verdict, complete cut).
            advanced = bool(new_key) and new_key in self.prefix
            body.update(
                stream=stream,
                window=plan.window,
                ops=n,
                ops_total=plan.base_ops + n,
                frontier=new_key if advanced else token,
                advanced=advanced,
            )
            self.stats.emit(
                "window_done",
                stream=stream,
                window=plan.window,
                verdict=body.get("verdict"),
                advanced=advanced,
                ops_total=plan.base_ops + n,
                trace_id=trace_id,
            )
        return reply

    # -- distributed search (service/distsearch.py coordinator peer) -------

    _GRANTS_MAX = 1024  # bounded: a dead coordinator must not leak grants

    @staticmethod
    def _ds_fields(req: dict) -> tuple[str, str, str, int] | dict:
        search = str(req.get("search") or "")
        seg = str(req.get("seg") or "")
        part = str(req.get("part") or "")
        if not search or not part:
            return err(ERR_DECODE, "distributed ops need 'search' and 'part'")
        try:
            epoch = int(req.get("epoch"))
        except (TypeError, ValueError):
            return err(
                ERR_DECODE, f"epoch must be an int, got {req.get('epoch')!r}"
            )
        return search, seg, part, epoch

    def _ds_grant(self, req: dict) -> dict:
        """Claim partition ownership.  The fence: a grant older than the
        one already held is a zombie coordinator thread — refused with
        the definite ``EpochFenced`` so it can never double-own."""
        fields = self._ds_fields(req)
        if isinstance(fields, dict):
            return fields
        search, seg, part, epoch = fields
        key = (search, part)
        have = self._grants.get(key)
        if have is not None and have > epoch:
            self.stats.emit(
                "epoch_fence", op="grant", search=search, part=part,
                epoch=epoch, have=have,
            )
            return err(
                ERR_EPOCH,
                f"partition {part} of {search[:12]} is owned at epoch "
                f"{have} > {epoch}",
                epoch=have,
            )
        # Re-insert so the eviction order tracks grant recency.
        self._grants.pop(key, None)
        self._grants[key] = epoch
        while len(self._grants) > self._GRANTS_MAX:
            self._grants.pop(next(iter(self._grants)))
        self.stats.emit(
            "partition_granted", search=search, part=part, epoch=epoch
        )
        return ok({"search": search, "part": part, "epoch": epoch, "seg": seg})

    async def _ds_delta(
        self, req: dict, reader: asyncio.StreamReader | None = None
    ) -> dict:
        """One partition of one segment: search the segment history from
        the carried share of the boundary union and reply with the
        partition's end-of-segment union.

        The epoch is checked twice: at entry (a stale delta never costs a
        search) and again when the verdict is ready — a revocation that
        landed mid-search turns this reply into ``EpochFenced``, so a
        zombie node that missed its own revocation cannot leak a verdict
        back into the merge.  The reply is partition-scoped
        (``scope="partition"``) and never enters any verdict cache.
        """
        t_recv = self.tracer.now()
        trace_id, _ = parse_trace_frame(req.get(TRACE_FIELD))
        if trace_id is None:
            trace_id = new_trace_id()
        fields = self._ds_fields(req)
        if isinstance(fields, dict):
            return fields
        search, seg, part, epoch = fields
        key = (search, part)
        have = self._grants.get(key)
        if have != epoch:
            self.stats.emit(
                "epoch_fence", op="delta", search=search, part=part,
                epoch=epoch, have=have,
            )
            return err(
                ERR_EPOCH,
                f"no live grant for partition {part} of {search[:12]} at "
                f"epoch {epoch} (have {have})",
                epoch=have,
            )
        try:
            carry = PrefixCarry.from_payload(req.get("carry"))
        except (TypeError, ValueError) as e:
            return err(ERR_DECODE, f"bad partition carry: {e}")
        client = str(req.get("client") or "distsearch")
        deadline = req.get("deadline")
        if deadline is not None:
            try:
                deadline = float(deadline)
            except (TypeError, ValueError):
                return err(
                    ERR_DECODE, f"deadline must be a number, got {deadline!r}"
                )
        decoded = self._decode_history(
            req.get("history"), req.get("records"), client
        )
        if isinstance(decoded, dict):
            return decoded
        _text, events, hist = decoded
        n = len(hist.ops)
        if n == 0:
            # All-trivial segment slice: the union passes through unchanged.
            states = pack_states(carry.states)
            self.stats.emit(
                "partition_delta", search=search, part=part, epoch=epoch,
                verdict=0, states=len(states),
                bytes=len(json.dumps(states, separators=(",", ":"))),
            )
            return ok(
                {
                    "verdict": 0,
                    "outcome": "OK",
                    "backend": "frontier-trivial",
                    "scope": "partition",
                    "search": search,
                    "seg": seg,
                    "part": part,
                    "epoch": epoch,
                    "ops": 0,
                    "states": states,
                    "trace_id": trace_id,
                }
            )
        # The final segment's verdict suffices on its own (there is no
        # next boundary to seed), so the coordinator sends union=False
        # and the search may accept early instead of materializing every
        # indefinite-append layer for an unwanted union.
        want_union = req.get("union", True)
        plan = PrefixPlan(
            kind="partition",
            carry=carry,
            snap_keys={n: None} if want_union else {},
        )
        plan.total_events = len(events)
        cancel = CancelToken(
            time.monotonic() + deadline if deadline is not None else None
        )
        self._part_jobs[key] = cancel
        job = Job(
            id=next(self._job_ids),
            client=client,
            priority=0,  # a partition blocks a whole fleet: front of queue
            shape=shape_key(hist),
            fingerprint=f"ppart:{search[:16]}/{part}",
            events=events,
            hist=hist,
            no_viz=True,
            trace_id=trace_id,
            cancel=cancel,
            prefix=plan,
        )
        fut: asyncio.Future = self._loop.create_future()

        def _resolve(reply: dict) -> None:
            def _finish() -> None:
                if not fut.done():
                    fut.set_result(reply)

            with contextlib.suppress(RuntimeError):  # loop already closed
                self._loop.call_soon_threadsafe(_finish)

        job.resolve = _resolve
        try:
            depth = self.queue.put(job)
        except QueueFull as e:
            self._part_jobs.pop(key, None)
            return err(
                ERR_QUEUE_FULL, str(e),
                retry_after_s=e.retry_after_s, depth=e.depth,
            )
        except RuntimeError as e:  # queue closed: daemon is stopping
            self._part_jobs.pop(key, None)
            return err(ERR_SHUTTING_DOWN, str(e))
        job.enqueued_at = self.tracer.now()
        self.stats.emit(
            "admit",
            job=job.id,
            client=client,
            priority=0,
            shape=job.shape,
            depth=depth,
            trace_id=trace_id,
        )
        self.stats.set_queue_depth(depth)
        if self.tracer.enabled:
            self.tracer.name_track(
                job.id, f"partition {part}@{epoch} ({client})"
            )
            self.tracer.add_span(
                "admit", t_recv, job.enqueued_at, tid=job.id,
                args={"client": client, "part": part, "trace_id": trace_id},
            )
        try:
            reply = await self._await_reply(fut, job, reader)
        finally:
            if self._part_jobs.get(key) is cancel:
                self._part_jobs.pop(key, None)
        # Reply-time fence: the grant must STILL be ours.  A steal or
        # revocation that raced the search makes this node a zombie — its
        # verdict must die here, not in the coordinator's merge.
        if self._grants.get(key) != epoch:
            self.stats.emit(
                "epoch_fence", op="delta_reply", search=search, part=part,
                epoch=epoch, have=self._grants.get(key),
            )
            return err(
                ERR_EPOCH,
                f"grant for partition {part} superseded mid-search "
                f"(epoch {epoch})",
                epoch=self._grants.get(key),
            )
        body = reply.get("ok")
        if isinstance(body, dict):
            # Work complete: the grant is spent (the next segment's grant
            # arrives under a fresh epoch).
            self._grants.pop(key, None)
            body.update(
                scope="partition", search=search, seg=seg, part=part,
                epoch=epoch,
            )
            states = body.get("states") or []
            self.stats.emit(
                "partition_delta", search=search, part=part, epoch=epoch,
                verdict=body.get("verdict"), states=len(states),
                bytes=len(json.dumps(states, separators=(",", ":"))),
            )
        return reply

    def _ds_done(self, req: dict) -> dict:
        """Close (or revoke) a partition grant; cancels the in-flight
        partition job so a revoked search stops burning the worker."""
        fields = self._ds_fields(req)
        if isinstance(fields, dict):
            return fields
        search, _seg, part, epoch = fields
        reason = str(req.get("reason") or "done")
        key = (search, part)
        have = self._grants.get(key)
        if have is not None and have > epoch:
            self.stats.emit(
                "epoch_fence", op="done", search=search, part=part,
                epoch=epoch, have=have,
            )
            return err(
                ERR_EPOCH,
                f"partition {part} re-owned at epoch {have} > {epoch}",
                epoch=have,
            )
        closed = self._grants.pop(key, None) is not None
        tok = self._part_jobs.pop(key, None)
        if tok is not None:
            tok.cancel("revoked")
        self.stats.emit(
            "partition_done", search=search, part=part, epoch=epoch,
            reason=reason, closed=closed,
        )
        return ok({"closed": closed, "search": search, "part": part})
