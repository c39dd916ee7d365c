"""Runtime introspection: build observability + resource telemetry.

The port's counterpart of the JAX package's ``obs/introspect.py``.  Two
halves, both always-on and stdlib-only (``torch`` is only touched lazily,
and only when the process already imported it):

**Build observability** — the JAX package counts ``jax.jit`` compiles per
abstract signature.  The port compiles nothing per shape: its kernels are
libraries built once, at first use, into ``_build/`` — the ``nvcc`` build
of ``csrc/fold_lanes.cu`` (``ops/fold_cuda.py::compile_library``) and the
``g++`` build of ``csrc/s2check.cpp`` (``checker/native.py``).  Each build
that actually runs the compiler is one :meth:`JitIntrospector.
record_compile` (via :func:`record_build`): ``site`` names the compiler
and source, ``sig`` is the source hash that names the ``.so``, and
``wall_s`` the compiler's wall; a ``build`` span lands on the job
context's tracer.  A library loaded from ``_build/`` records nothing, so
a supervised child's harvested snapshot says whether that child paid a
cold build.  Counts are kept per ``(site, shape_key)`` and exported as
the ``verifyd_jit_*`` metric families.  A shape that rebuilds one site
more than ``storm_threshold`` times trips a **latched** ``retrace_storm``
ServiceStats event, once per (site, shape).  (The JAX package's
``observe_jit`` decorator has no site to wrap here and is not ported.)

The tracker is a process-global singleton (:data:`INTROSPECTOR`): the
build sites report to it, a daemon attaches its registry/stats, and a
supervised child harvests :meth:`JitIntrospector.snapshot_and_reset`
into the result JSON so the parent can :meth:`~JitIntrospector.fold` the
child's build activity into its own families — the same side channel the
child span ring rides.

**Resource telemetry** — :class:`ResourceSampler`, a low-overhead daemon
thread reading host RSS, CPU time, open fds, thread count, GC pauses
(via ``gc.callbacks``), and per-card memory (best effort, only when
``torch`` is already imported and CUDA already initialised) into the
``verifyd_resource_*`` gauge families, a bounded in-memory ring, and —
when a flight recorder is attached — ``{"k": "res"}`` flight records.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "INTROSPECTOR",
    "JitIntrospector",
    "JobContext",
    "ResourceSampler",
    "get_job_context",
    "job_context",
    "record_build",
]

_UNKNOWN_SHAPE = "?"

_local = threading.local()


class JobContext:
    """What the thread is working on: set by the scheduler worker (and
    the supervised child) so build sites can attribute builds to a job,
    a shape bucket, a trace id, and a tracer track."""

    __slots__ = ("job", "shape", "trace_id", "tracer")

    def __init__(
        self,
        job: int = 0,
        shape: str = _UNKNOWN_SHAPE,
        trace_id: str = "",
        tracer=None,
    ) -> None:
        self.job = job
        self.shape = shape
        self.trace_id = trace_id
        self.tracer = tracer


_DEFAULT_CONTEXT = JobContext()


def get_job_context() -> JobContext:
    return getattr(_local, "job_context", _DEFAULT_CONTEXT)


class job_context:
    """``with job_context(job=3, shape="64x5x8", trace_id=..., tracer=t):``
    — scoped per-thread attribution for everything the body compiles."""

    def __init__(self, **kw: Any) -> None:
        self._ctx = JobContext(**kw)
        self._prev: Optional[JobContext] = None

    def __enter__(self) -> JobContext:
        self._prev = getattr(_local, "job_context", None)
        _local.job_context = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> None:
        if self._prev is None:
            del _local.job_context
        else:
            _local.job_context = self._prev


class JitIntrospector:
    """Process-global build tracker behind :func:`record_build`.

    Unattached (no registry/stats) it still counts — the numbers a child
    accumulates before harvest are exactly what the parent folds.
    """

    def __init__(self, storm_threshold: int = 5) -> None:
        self._lock = threading.Lock()
        self.storm_threshold = storm_threshold
        self._registry = None
        self._stats = None
        # site -> set of abstract signatures already compiled there
        self._sigs: Dict[str, set] = {}
        # (site, shape) -> count
        self._compiles: Dict[Tuple[str, str], int] = {}
        self._retraces: Dict[Tuple[str, str], int] = {}
        # shape -> count
        self._hits: Dict[str, int] = {}
        self._misses: Dict[str, int] = {}
        # site -> total first-call wall (compile + first dispatch)
        self._compile_wall: Dict[str, float] = {}
        # latched (site, shape) storm trips, with the count at trip time
        self._storms: Dict[Tuple[str, str], int] = {}

    # -- wiring --------------------------------------------------------------

    def attach(
        self, *, registry=None, stats=None, storm_threshold: Optional[int] = None
    ) -> None:
        """Point the tracker at a daemon's registry + event stream.  A
        re-attach (tests boot many daemons per process) replaces both and
        replays accumulated counts into the new registry so /metrics
        never starts behind the tracker."""
        with self._lock:
            self._registry = registry
            self._stats = stats
            if storm_threshold is not None:
                self.storm_threshold = storm_threshold
            if registry is not None:
                self._replay_into_registry()

    def _replay_into_registry(self) -> None:
        # Caller holds the lock.
        for (site, shape), n in self._compiles.items():
            self._metric("verifyd_jit_compiles_total", ("site", "shape")).inc(
                n, site=site, shape=shape
            )
        for (site, shape), n in self._retraces.items():
            self._metric("verifyd_jit_retraces_total", ("site", "shape")).inc(
                n, site=site, shape=shape
            )
        for shape, n in self._hits.items():
            self._metric("verifyd_jit_cache_hits_total", ("shape",)).inc(
                n, shape=shape
            )
        for shape, n in self._misses.items():
            self._metric("verifyd_jit_cache_misses_total", ("shape",)).inc(
                n, shape=shape
            )

    def _metric(self, name: str, labelnames: Tuple[str, ...]):
        # The registry factory is idempotent: ServiceStats pre-registers
        # these families (with HELP text) so headers render even before
        # the first compile; this lookup just returns the same objects.
        return self._registry.counter(name, labelnames=labelnames)

    # -- the hot path --------------------------------------------------------

    def record_call(self, site: str, sig: str) -> bool:
        """Account one call at ``site`` under abstract signature ``sig``;
        returns True when the executable is already cached (a hit)."""
        ctx = get_job_context()
        shape = ctx.shape
        with self._lock:
            seen = self._sigs.setdefault(site, set())
            hit = sig in seen
            if hit:
                self._hits[shape] = self._hits.get(shape, 0) + 1
                if self._registry is not None:
                    self._metric("verifyd_jit_cache_hits_total", ("shape",)).inc(
                        shape=shape
                    )
            else:
                self._misses[shape] = self._misses.get(shape, 0) + 1
                if self._registry is not None:
                    self._metric("verifyd_jit_cache_misses_total", ("shape",)).inc(
                        shape=shape
                    )
        return hit

    def record_compile(self, site: str, sig: str, wall_s: float) -> None:
        """Account the timed first call for a fresh signature; trips the
        latched retrace storm when a shape keeps recompiling one site."""
        ctx = get_job_context()
        shape = ctx.shape
        storm: Optional[Tuple[str, str, int]] = None
        with self._lock:
            seen = self._sigs.setdefault(site, set())
            retrace = bool(seen)  # site already had a compiled signature
            seen.add(sig)
            key = (site, shape)
            self._compiles[key] = self._compiles.get(key, 0) + 1
            self._compile_wall[site] = self._compile_wall.get(site, 0.0) + wall_s
            if self._registry is not None:
                self._metric("verifyd_jit_compiles_total", ("site", "shape")).inc(
                    site=site, shape=shape
                )
                self._registry.histogram(
                    "verifyd_jit_compile_seconds", labelnames=("site",)
                ).observe(wall_s, site=site)
            if retrace:
                self._retraces[key] = self._retraces.get(key, 0) + 1
                if self._registry is not None:
                    self._metric(
                        "verifyd_jit_retraces_total", ("site", "shape")
                    ).inc(site=site, shape=shape)
            if (
                self._compiles[key] > self.storm_threshold
                and key not in self._storms
            ):
                self._storms[key] = self._compiles[key]
                storm = (site, shape, self._compiles[key])
        if storm is not None:
            self._emit_storm(*storm)

    def _emit_storm(self, site: str, shape: str, count: int) -> None:
        stats = self._stats
        if stats is not None:
            ctx = get_job_context()
            stats.emit(
                "retrace_storm",
                site=site,
                shape=shape,
                compiles=count,
                threshold=self.storm_threshold,
                job=ctx.job,
                trace_id=ctx.trace_id,
            )

    # -- harvest / fold ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable view for the stats op and the child harvest.
        Keys are ``site\\tshape`` joins (both are free of tabs)."""
        with self._lock:
            return {
                "compiles": {
                    f"{s}\t{sh}": n for (s, sh), n in self._compiles.items()
                },
                "retraces": {
                    f"{s}\t{sh}": n for (s, sh), n in self._retraces.items()
                },
                "hits": dict(self._hits),
                "misses": dict(self._misses),
                "compile_wall_s": {
                    s: round(w, 6) for s, w in self._compile_wall.items()
                },
                "signatures": {s: len(v) for s, v in self._sigs.items()},
                "storms": [
                    {"site": s, "shape": sh, "compiles": n}
                    for (s, sh), n in self._storms.items()
                ],
                "storm_threshold": self.storm_threshold,
            }

    def snapshot_and_reset(self) -> Dict[str, Any]:
        """Harvest for the child→parent side channel: everything counted
        so far, then a clean slate (a restarted attempt reports only its
        own compiles)."""
        snap = self.snapshot()
        with self._lock:
            self._sigs.clear()
            self._compiles.clear()
            self._retraces.clear()
            self._hits.clear()
            self._misses.clear()
            self._compile_wall.clear()
            self._storms.clear()
        return snap

    def fold(self, snap: Dict[str, Any]) -> None:
        """Merge a child's harvested snapshot into this (parent) tracker:
        counts add, compile wall lands in the histogram as one aggregate
        observation per site, and child storms re-trip the latch here so
        the alert engine sees them exactly once."""
        if not isinstance(snap, dict):
            return
        storms: List[Tuple[str, str, int]] = []

        def _pairs(key: str):
            for joined, n in (snap.get(key) or {}).items():
                site, _, shape = str(joined).partition("\t")
                try:
                    yield site, (shape or _UNKNOWN_SHAPE), int(n)
                except (TypeError, ValueError):
                    continue

        with self._lock:
            for site, shape, n in _pairs("compiles"):
                key = (site, shape)
                self._compiles[key] = self._compiles.get(key, 0) + n
                if self._registry is not None:
                    self._metric(
                        "verifyd_jit_compiles_total", ("site", "shape")
                    ).inc(n, site=site, shape=shape)
                if (
                    self._compiles[key] > self.storm_threshold
                    and key not in self._storms
                ):
                    self._storms[key] = self._compiles[key]
                    storms.append((site, shape, self._compiles[key]))
            for site, shape, n in _pairs("retraces"):
                key = (site, shape)
                self._retraces[key] = self._retraces.get(key, 0) + n
                if self._registry is not None:
                    self._metric(
                        "verifyd_jit_retraces_total", ("site", "shape")
                    ).inc(n, site=site, shape=shape)
            for shape, n in (snap.get("hits") or {}).items():
                self._hits[shape] = self._hits.get(shape, 0) + int(n)
                if self._registry is not None:
                    self._metric("verifyd_jit_cache_hits_total", ("shape",)).inc(
                        int(n), shape=shape
                    )
            for shape, n in (snap.get("misses") or {}).items():
                self._misses[shape] = self._misses.get(shape, 0) + int(n)
                if self._registry is not None:
                    self._metric(
                        "verifyd_jit_cache_misses_total", ("shape",)
                    ).inc(int(n), shape=shape)
            for site, wall in (snap.get("compile_wall_s") or {}).items():
                w = float(wall)
                self._compile_wall[site] = self._compile_wall.get(site, 0.0) + w
                if self._registry is not None and w > 0:
                    self._registry.histogram(
                        "verifyd_jit_compile_seconds", labelnames=("site",)
                    ).observe(w, site=site)
        for storm in storms:
            self._emit_storm(*storm)


#: The process-global tracker every build site reports to.
INTROSPECTOR = JitIntrospector()


def record_build(site: str, sig: str, wall_s: float) -> None:
    """Account one library build that ran its compiler: ``site`` names the
    compiler and source (``"nvcc:fold_lanes.cu"``), ``sig`` the source hash
    that names the ``.so``, ``wall_s`` the compiler's wall.  Also records a
    ``build`` span on the job context's tracer, ending now."""
    INTROSPECTOR.record_compile(site, sig, wall_s)
    ctx = get_job_context()
    tracer = ctx.tracer
    if tracer is not None and getattr(tracer, "enabled", False):
        t1 = tracer.now()
        tracer.add_span(
            "build",
            t1 - wall_s,
            t1,
            tid=ctx.job,
            cat="build",
            args={"site": site, "sig": sig, "shape": ctx.shape, "trace_id": ctx.trace_id},
        )


# --------------------------------------------------------------- resources


def _read_rss_bytes() -> int:
    """Resident set size from /proc (Linux); ru_maxrss (high-water, kB on
    Linux) as the portable fallback."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return 0


def _read_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def _device_memory() -> Dict[str, int]:
    """Per-card bytes allocated, best effort: only consults ``torch`` when
    the process already imported it and already initialised CUDA (a
    sampler must never create a CUDA context)."""
    mod = sys.modules.get("torch")
    if mod is None:
        return {}
    out: Dict[str, int] = {}
    try:
        if not mod.cuda.is_initialized():
            return {}
        for i in range(mod.cuda.device_count()):
            out[f"cuda:{i}"] = int(mod.cuda.memory_allocated(i))
    except Exception:
        return out
    return out


class ResourceSampler:
    """Bounded-ring resource sampler thread feeding gauges + flight."""

    def __init__(
        self,
        registry=None,
        *,
        interval_s: float = 1.0,
        capacity: int = 600,
        recorder=None,
        time_fn: Callable[[], float] = time.time,
    ) -> None:
        self.interval_s = max(0.05, float(interval_s))
        self.recorder = recorder
        self._time = time_fn
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples = 0
        self._gc_pause_s = 0.0
        self._gc_collections = 0
        self._gc_t0: Optional[float] = None
        self._gc_cb_installed = False

        self._g_rss = self._g_cpu = self._g_fds = None
        self._g_threads = self._g_gc = self._g_dev = None
        if registry is not None:
            self._g_rss = registry.gauge("verifyd_resource_rss_bytes")
            self._g_cpu = registry.gauge("verifyd_resource_cpu_seconds")
            self._g_fds = registry.gauge("verifyd_resource_open_fds")
            self._g_threads = registry.gauge("verifyd_resource_threads")
            self._g_gc = registry.gauge("verifyd_resource_gc_pause_seconds")
            self._g_dev = registry.gauge(
                "verifyd_resource_device_memory_bytes", labelnames=("device",)
            )

    # -- GC pause accounting (gc.callbacks fires around every collection)

    def _gc_callback(self, phase: str, info: Dict[str, Any]) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif phase == "stop" and self._gc_t0 is not None:
            dt = time.perf_counter() - self._gc_t0
            self._gc_t0 = None
            with self._lock:
                self._gc_pause_s += dt
                self._gc_collections += 1

    # -- sampling ------------------------------------------------------------

    def sample_once(self) -> Dict[str, Any]:
        """Take one sample: update gauges, append to the ring, and feed
        the flight recorder.  Also the test hook (no thread needed)."""
        times = os.times()
        with self._lock:
            gc_pause = self._gc_pause_s
            gc_n = self._gc_collections
        sample: Dict[str, Any] = {
            "t": round(self._time(), 3),
            "rss_bytes": _read_rss_bytes(),
            "cpu_s": round(times[0] + times[1], 3),
            "fds": _read_fds(),
            "threads": threading.active_count(),
            "gc_pause_s": round(gc_pause, 6),
            "gc_collections": gc_n,
        }
        dev = _device_memory()
        if dev:
            sample["devices"] = dev
        if self._g_rss is not None:
            self._g_rss.set(sample["rss_bytes"])
            self._g_cpu.set(sample["cpu_s"])
            self._g_fds.set(sample["fds"])
            self._g_threads.set(sample["threads"])
            self._g_gc.set(sample["gc_pause_s"])
            for name, used in dev.items():
                self._g_dev.set(used, device=name)
        with self._lock:
            self._ring.append(sample)
            self._samples += 1
        if self.recorder is not None:
            self.recorder.record_resource(sample)
        return sample

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # telemetry must never take the daemon down
                pass

    def start(self) -> "ResourceSampler":
        if self._thread is None:
            if not self._gc_cb_installed:
                gc.callbacks.append(self._gc_callback)
                self._gc_cb_installed = True
            self.sample_once()  # t=0 point: the ring is never empty while up
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="verifyd-resources", daemon=True
            )
            self._thread.start()
        return self

    def close(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._gc_cb_installed:
            try:
                gc.callbacks.remove(self._gc_callback)
            except ValueError:
                pass
            self._gc_cb_installed = False

    # -- read side -----------------------------------------------------------

    def ring(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            last = self._ring[-1] if self._ring else None
            return {
                "interval_s": self.interval_s,
                "samples": self._samples,
                "retained": len(self._ring),
                "last": last,
            }
