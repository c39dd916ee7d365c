"""Durable time-series store: the MetricsRegistry, with a memory.

The port's copy of the JAX package's ``obs/tsdb.py`` (plain Python,
unchanged in behaviour and on disk: each package reads the other's
rings).

Every telemetry surface before this one — the dashboard sample ring, the
PerfSentinel EWMA baselines, the SLO windows — is in-memory and
per-process: a rolling restart or SIGKILL erases all history, so a
post-deploy regression looks like a cold start and the doctor can only
narrate events, never metric *trajectories*.  The tsdb closes that gap
with the same storage discipline every other durable artifact in this
repo already uses (``utils/seglog.SegmentLog``: CRC-checked records,
flushed appends, torn-tail recovery, bounded retention).

Layout — one log per downsampling ring under the telemetry dir::

    <telemetry-dir>/raw/seg-*.log     every sample      (dashboard cadence)
    <telemetry-dir>/1m/seg-*.log      last sample per 60s bucket
    <telemetry-dir>/15m/seg-*.log     last sample per 900s bucket

Each record is one JSON object ``{"t": wall, "k": "b"|"d", "v": {...}}``
over the *flattened* registry snapshot (counters and gauges by their
rendered series key, histograms as ``<name>_count{...}`` /
``<name>_sum{...}``).  ``"b"`` is a base keyframe carrying every series;
``"d"`` is a delta carrying only the series whose value changed since
the previous record — values are **absolute**, so replay is a cumulative
``dict.update`` and a lost delta can only delay a series, never corrupt
it.  Every boot writes a fresh keyframe (the registry restarts from
zero, so no cross-boot writer state is needed), and a keyframe recurs
every ``keyframe_every`` records so retention eviction of old segments
bounds, rather than breaks, cold reads.

Retention is byte-bounded per ring (``max_segment_bytes`` ×
``max_segments``, oldest segment dropped on rotation); the coarse rings
hold the same byte budget and therefore proportionally longer history.

The **cold reader** (:func:`query`, :func:`last_values`,
:func:`telemetry_info`) never creates directories and never appends — it
is what ``tsq`` (cold mode), the doctor's telemetry-history section, and
PerfSentinel boot seeding use.  The **live** ``tsq`` op answers by cold-
reading the store's own directory: appends are flushed immediately, so
live and cold agree by construction.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.seglog import Recovery, SegmentLog
from .metrics import MetricsRegistry

__all__ = [
    "RESOLUTIONS",
    "TELEMETRY_SUBDIR",
    "TelemetryStore",
    "default_dir",
    "flatten_snapshot",
    "last_values",
    "parse_series_key",
    "query",
    "telemetry_info",
]

#: the downsampling rings: (name, bucket seconds); 0.0 = every sample
RESOLUTIONS: Tuple[Tuple[str, float], ...] = (
    ("raw", 0.0),
    ("1m", 60.0),
    ("15m", 900.0),
)

#: where the store lives under a daemon ``--state-dir`` by default
TELEMETRY_SUBDIR = "telemetry"


def default_dir(state_dir: str) -> str:
    """The conventional telemetry dir for a state dir — the doctor reads
    here when no explicit ``--telemetry-dir`` is given."""
    return os.path.join(state_dir, TELEMETRY_SUBDIR)


def flatten_snapshot(snap: Dict[str, Any]) -> Dict[str, float]:
    """``MetricsRegistry.snapshot()`` → flat ``{series_key: value}``.

    Counters and gauges keep their rendered key (``name{a="b"}``);
    histograms flatten to the two scrape-visible scalars per series,
    ``<name>_count{...}`` and ``<name>_sum{...}`` (bucket vectors are
    dashboard detail, not history).
    """
    out: Dict[str, float] = {}
    for key, v in (snap.get("counters") or {}).items():
        out[key] = float(v)
    for key, v in (snap.get("gauges") or {}).items():
        out[key] = float(v)
    for key, h in (snap.get("histograms") or {}).items():
        if not isinstance(h, dict):
            continue
        name, brace, rest = key.partition("{")
        suffix = brace + rest
        out[name + "_count" + suffix] = float(h.get("count", 0) or 0)
        out[name + "_sum" + suffix] = float(h.get("sum", 0.0) or 0.0)
    return out


def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``name{a="b",c="d"}`` → ``(name, {a: b, c: d})``; unescapes label
    values the way ``obs.metrics`` escaped them."""
    name, brace, rest = key.partition("{")
    if not brace:
        return name, {}
    labels: Dict[str, str] = {}
    i = 0
    n = len(rest)
    while i < n and rest[i] != "}":
        eq = rest.find('="', i)
        if eq < 0:
            break
        lname = rest[i:eq]
        i = eq + 2
        buf: List[str] = []
        while i < n:
            ch = rest[i]
            if ch == "\\" and i + 1 < n:
                nxt = rest[i + 1]
                buf.append("\n" if nxt == "n" else nxt)
                i += 2
                continue
            if ch == '"':
                i += 1
                break
            buf.append(ch)
            i += 1
        labels[lname.strip()] = "".join(buf)
        if i < n and rest[i] == ",":
            i += 1
    return name, labels


def _match(
    key: str, metric: Optional[str], labels: Optional[Dict[str, str]]
) -> bool:
    name, got = parse_series_key(key)
    if metric and metric not in name:
        return False
    for ln, lv in (labels or {}).items():
        if got.get(ln) != lv:
            return False
    return True


class TelemetryStore:
    """Sampler + writer for one process's metric history.

    Construction replays every ring read-only (recovery counts + the
    last cumulative values land in :attr:`recovery` / :meth:`boot_values`
    for the ``telemetry_loaded`` event and sentinel seeding), then arms
    the writer: the next sample per ring is a boot keyframe.
    """

    def __init__(
        self,
        directory: str,
        registry: MetricsRegistry,
        *,
        sample_s: float = 2.0,
        keyframe_every: int = 64,
        max_segment_bytes: int = 256 << 10,
        max_segments: int = 8,
        fsync: bool = False,
        time_fn: Callable[[], float] = time.time,
    ) -> None:
        self.dir = directory
        self.registry = registry
        self.sample_s = max(0.05, float(sample_s))
        self.keyframe_every = max(2, int(keyframe_every))
        self._time = time_fn
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        #: optional service.overload.DegradedWriter — history must never
        #: take the daemon down on a full disk
        self.writer = None
        self._logs: Dict[str, SegmentLog] = {}
        self._prev: Dict[str, Optional[Dict[str, float]]] = {}
        self._count: Dict[str, int] = {}
        self._pending: Dict[str, Optional[Tuple[float, Dict[str, float]]]] = {}
        #: per-resolution Recovery from the boot replay
        self.recovery: Dict[str, Recovery] = {}
        self._boot: Dict[str, Tuple[Optional[float], Dict[str, float]]] = {}
        for res, _step in RESOLUTIONS:
            log = SegmentLog(
                os.path.join(directory, res),
                max_segment_bytes=max_segment_bytes,
                max_segments=max_segments,
                fsync=fsync,
            )
            last_t: Optional[float] = None
            values: Dict[str, float] = {}
            for payload in log.replay():
                rec = _decode(payload)
                if rec is None:
                    continue
                last_t = rec[0]
                values.update(rec[2])
            self.recovery[res] = log.recovery
            self._boot[res] = (last_t, values)
            self._logs[res] = log
            self._prev[res] = None  # forces a boot keyframe
            self._count[res] = 0
            self._pending[res] = None
        self._m_points = registry.counter(
            "verifyd_telemetry_points_total",
            "Telemetry records appended, by resolution ring",
            labelnames=("res",),
        )
        self._m_bytes = registry.counter(
            "verifyd_telemetry_bytes_total",
            "Telemetry payload bytes appended across all rings",
        )
        self._m_store = registry.gauge(
            "verifyd_telemetry_store_bytes",
            "On-disk size of the telemetry store (all rings)",
        )

    # -- boot read side ------------------------------------------------------

    def boot_values(
        self, res: str = "raw"
    ) -> Tuple[Optional[float], Dict[str, float]]:
        """(last sample wall time, cumulative values) found at boot —
        what PerfSentinel seeds from.  ``(None, {})`` on a fresh dir."""
        t, values = self._boot.get(res, (None, {}))
        return t, dict(values)

    def recovery_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-ring recovery counts for the ``telemetry_loaded`` event."""
        return {
            res: {
                "records": rec.records,
                "segments": rec.segments,
                "torn_tail_bytes": rec.torn_tail_bytes,
                "bad_segments": rec.bad_segments,
            }
            for res, rec in self.recovery.items()
        }

    # -- write side ----------------------------------------------------------

    def sample_once(self) -> None:
        """Flatten the registry and feed every ring; public so tests and
        the shutdown path can force a sample with an injected clock."""
        if self._closed:
            return
        with self._lock:
            # Snapshot under the lock: two racing samplers must append in
            # the same order they observed the registry, or replayed
            # values could regress between adjacent records.
            t = self._time()
            values = flatten_snapshot(self.registry.snapshot())
            self._write("raw", t, values)
            for res, step in RESOLUTIONS:
                if step <= 0.0:
                    continue
                pending = self._pending[res]
                if pending is not None and int(t // step) > int(
                    pending[0] // step
                ):
                    # bucket advanced: the held sample was its bucket's last
                    self._write(res, pending[0], pending[1])
                self._pending[res] = (t, values)
            self._m_store.set(float(self._store_size()))

    def _write(self, res: str, t: float, values: Dict[str, float]) -> None:
        prev = self._prev[res]
        keyframe = prev is None or self._count[res] % self.keyframe_every == 0
        if keyframe:
            body: Dict[str, float] = values
            kind = "b"
        else:
            body = {k: v for k, v in values.items() if prev.get(k) != v}
            kind = "d"
        try:
            payload = json.dumps(
                {"t": round(t, 3), "k": kind, "v": body},
                separators=(",", ":"),
            ).encode("utf-8")
        except (TypeError, ValueError):
            return
        log = self._logs[res]
        try:
            if self.writer is not None:
                self.writer.run(lambda: log.append(payload))
            else:
                log.append(payload)
        except OSError:
            return  # history must never take the daemon down
        # Lock held by construction: _write's only callers are
        # sample_once() and close(), both inside `with self._lock`.
        self._prev[res] = dict(values)  # verifylint: disable=concurrency-unlocked-write
        self._count[res] += 1  # verifylint: disable=concurrency-unlocked-write
        if res not in ("raw", "1m", "15m"):
            res = "raw"
        self._m_points.inc(res=res)
        self._m_bytes.inc(len(payload))

    def _store_size(self) -> int:
        total = 0
        for res, _step in RESOLUTIONS:
            d = os.path.join(self.dir, res)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                try:
                    total += os.path.getsize(os.path.join(d, name))
                except OSError:
                    pass
        return total

    # -- sampler thread ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or self._closed:
            return
        self._thread = threading.Thread(
            target=self._run, name="verifyd-tsdb", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.sample_s):
            try:
                self.sample_once()
            except Exception:
                pass  # same contract as the flight ring: never crash

    def close(self) -> None:
        """Final sample, flush held coarse buckets, close the logs."""
        if self._closed:
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.sample_once()
        except Exception:
            pass
        with self._lock:
            self._closed = True
            for res, _step in RESOLUTIONS:
                pending = self._pending.get(res)
                if pending is not None:
                    self._write(res, pending[0], pending[1])
                    self._pending[res] = None
            for log in self._logs.values():
                log.close()


# --------------------------------------------------------------- cold reader


def _decode(payload: bytes) -> Optional[Tuple[float, str, Dict[str, float]]]:
    try:
        rec = json.loads(payload)
    except ValueError:
        return None
    if not isinstance(rec, dict):
        return None
    v = rec.get("v")
    if not isinstance(v, dict):
        return None
    try:
        t = float(rec.get("t", 0.0))
    except (TypeError, ValueError):
        return None
    kind = rec.get("k")
    out: Dict[str, float] = {}
    for key, val in v.items():
        try:
            out[str(key)] = float(val)
        except (TypeError, ValueError):
            continue
    return t, ("b" if kind == "b" else "d"), out


def _read_ring(
    telemetry_dir: str, res: str
) -> Tuple[List[Tuple[float, str, Dict[str, float]]], Recovery]:
    directory = os.path.join(telemetry_dir, res)
    if not os.path.isdir(directory):
        return [], Recovery()
    log = SegmentLog(directory)
    records: List[Tuple[float, str, Dict[str, float]]] = []
    try:
        for payload in log.replay():
            rec = _decode(payload)
            if rec is not None:
                records.append(rec)
    finally:
        log.close()
    return records, log.recovery


def query(
    telemetry_dir: str,
    *,
    res: str = "raw",
    metric: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    since: Optional[float] = None,
    until: Optional[float] = None,
    limit: Optional[int] = None,
) -> Dict[str, Any]:
    """Cold range query: dense per-sample points for every matched series.

    ``metric`` is a substring match on the series *name* (before the
    label braces); ``labels`` are exact equality filters; ``since`` /
    ``until`` bound the wall-clock range; ``limit`` keeps the last N
    points per series (default 720).  Records outside the range still
    fold into the cumulative state, so a range query enters with correct
    values even when its window starts on a delta record.
    """
    cap = 720 if limit is None else max(1, int(limit))
    records, recovery = _read_ring(telemetry_dir, res)
    cur: Dict[str, float] = {}
    matched: List[str] = []
    series: Dict[str, List[List[float]]] = {}
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    for t, _kind, v in records:
        for key in v:
            if key not in cur and _match(key, metric, labels):
                matched.append(key)
                series[key] = []
        cur.update(v)
        if since is not None and t < since:
            continue
        if until is not None and t > until:
            continue
        first_t = t if first_t is None else first_t
        last_t = t
        for key in matched:
            pts = series[key]
            pts.append([t, cur[key]])
            if len(pts) > cap:
                del pts[0 : len(pts) - cap]
    points = sum(len(p) for p in series.values())
    return {
        "res": res,
        "series": {k: series[k] for k in sorted(series) if series[k]},
        "points": points,
        "range": [first_t, last_t],
        "recovery": {
            "records": recovery.records,
            "segments": recovery.segments,
            "torn_tail_bytes": recovery.torn_tail_bytes,
            "bad_segments": recovery.bad_segments,
        },
    }


def last_values(
    telemetry_dir: str, res: str = "raw"
) -> Tuple[Optional[float], Dict[str, float]]:
    """(last sample wall time, final cumulative values) — the seed the
    sentinel restores baselines from.  ``(None, {})`` when no history."""
    records, _recovery = _read_ring(telemetry_dir, res)
    last_t: Optional[float] = None
    cur: Dict[str, float] = {}
    for t, _kind, v in records:
        last_t = t
        cur.update(v)
    return last_t, cur


def telemetry_info(telemetry_dir: str) -> Dict[str, Any]:
    """Per-ring shape of a store (doctor / ``tsq --info``): record and
    series counts, recovery verdicts, byte sizes, covered range."""
    rings: Dict[str, Any] = {}
    for res, _step in RESOLUTIONS:
        records, recovery = _read_ring(telemetry_dir, res)
        cur: Dict[str, float] = {}
        for _t, _kind, v in records:
            cur.update(v)
        size = 0
        d = os.path.join(telemetry_dir, res)
        try:
            for name in os.listdir(d):
                try:
                    size += os.path.getsize(os.path.join(d, name))
                except OSError:
                    pass
        except OSError:
            pass
        rings[res] = {
            "records": len(records),
            "series": len(cur),
            "bytes": size,
            "first_t": records[0][0] if records else None,
            "last_t": records[-1][0] if records else None,
            "recovery": {
                "records": recovery.records,
                "segments": recovery.segments,
                "torn_tail_bytes": recovery.torn_tail_bytes,
                "bad_segments": recovery.bad_segments,
            },
        }
    return {"dir": telemetry_dir, "resolutions": rings}


def tsq_request(
    telemetry_dir: str,
    req: Dict[str, Any],
    store: Optional[TelemetryStore] = None,
) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
    """Shared ``tsq`` op semantics for the daemon and router dispatchers.

    Validates the request's optional selectors and answers from the
    given directory — ``(payload, None)`` on success, ``(None, reason)``
    on a malformed request.  When the live ``store`` is passed, a fresh
    sample is forced first: appends flush as they land, so a cold read
    of the live directory IS the live view — by construction, not copy.
    """
    if store is not None:
        store.sample_once()
    if req.get("info"):
        return telemetry_info(telemetry_dir), None
    res = str(req.get("res") or "raw")
    if res not in {name for name, _step in RESOLUTIONS}:
        return None, "res must be one of raw, 1m, 15m"
    kwargs: Dict[str, Any] = {"res": res}
    if req.get("metric") is not None:
        kwargs["metric"] = str(req["metric"])
    labels = req.get("labels")
    if labels is not None:
        if not isinstance(labels, dict):
            return None, "labels must be an object of {label: value}"
        kwargs["labels"] = {str(k): str(v) for k, v in labels.items()}
    for key in ("since", "until"):
        if req.get(key) is not None:
            try:
                kwargs[key] = float(req[key])
            except (TypeError, ValueError):
                return None, f"{key} must be a number"
    if req.get("limit") is not None:
        try:
            kwargs["limit"] = int(req["limit"])
        except (TypeError, ValueError):
            return None, "limit must be an int"
    else:
        # Bound the reply frame unless the caller chose a cut.
        kwargs["limit"] = 360
    return query(telemetry_dir, **kwargs), None
