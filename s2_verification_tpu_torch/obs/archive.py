"""Durable per-job profile archive: the daemon's recorded-traffic corpus.

The port's copy of the JAX package's ``obs/archive.py`` (plain Python,
unchanged in behaviour and on disk: each package reads the other's
archive).

The richest exhaust the service produces — per-job profiles, queue and
lease waits, per-shard skew, deciding backend, verdict — used to
evaporate when the JSONL stats sink rotated.  The archive makes it
durable: every ``done`` event becomes one compact record in a
CRC-checked :class:`~..utils.seglog.SegmentLog` under
``<state_dir>/profiles/records/``, and every admitted history's text is
stored once (deduplicated by fingerprint) under
``<state_dir>/profiles/corpus/``.  Together they are a replayable
workload: the corpus can be re-submitted against a live daemon to
check verdict parity, and the record stream maps job features to
observed cost.

Record shape (one JSON object per job)::

    {"t": 1722.5, "job": 3, "client": "loadgen", "fp": "9f3a…",
     "shape": "64x5x8", "backend": "native", "verdict": 0,
     "wall_s": 0.012, "queue_wait_s": 0.003, "lease_wait_s": 0.4,
     "ops": 40, "shape_warm": true, "trace_id": "…",
     "shards": […], "profile": {…}}

Write discipline mirrors the flight recorder: appends are flushed (the
archive survives SIGKILL up to the last OS write) and every failure is
swallowed — archival must never take a job down.  Unlike the flight
ring the record log is *unbounded by default* (it is the training set;
``max_segments`` bounds it when an operator wants a ring).

The read side (:func:`read_archive` / :func:`read_corpus`) is pure —
point it at a dead daemon's ``--state-dir`` and it never creates
directories, which is what the ``profiles`` CLI subcommand, the doctor,
and the replay harness use cold.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterable, List, Optional

from ..utils.seglog import SegmentLog

__all__ = [
    "ARCHIVE_SUBDIR",
    "ProfileArchive",
    "filter_records",
    "read_archive",
    "read_corpus",
]

ARCHIVE_SUBDIR = "profiles"
_RECORDS = "records"
_CORPUS = "corpus"

#: done-event fields copied verbatim into the archived record
_COPY_FIELDS = (
    "t",
    "job",
    "client",
    "shape",
    "backend",
    "verdict",
    "wall_s",
    "queue_wait_s",
    "ops",
    "shape_warm",
    "trace_id",
)


def _records_dir(root: str) -> str:
    return os.path.join(root, _RECORDS)


def _corpus_dir(root: str) -> str:
    return os.path.join(root, _CORPUS)


class ProfileArchive:
    """Write side: lives inside the daemon, fed from the event stream."""

    def __init__(
        self,
        directory: str,
        *,
        fsync: bool = False,
        max_segment_bytes: int = 1 << 20,
        max_segments: Optional[int] = None,
    ) -> None:
        self.dir = directory
        self._lock = threading.Lock()
        self._records_log = SegmentLog(
            _records_dir(directory),
            max_segment_bytes=max_segment_bytes,
            max_segments=max_segments,
            fsync=fsync,
        )
        self._corpus_log = SegmentLog(
            _corpus_dir(directory), max_segment_bytes=4 << 20, fsync=fsync
        )
        # Both logs replay into memory at open: records for the query API,
        # the corpus for fingerprint dedup.  Records are compact (no
        # history text); RAM cost is linear in archived jobs, bounded by
        # max_segments when configured.
        self._records: List[Dict[str, Any]] = _parse_json_records(
            self._records_log.replay()
        )
        self._histories: Dict[str, str] = {}
        for rec in _parse_json_records(self._corpus_log.replay()):
            fp, text = rec.get("fp"), rec.get("history")
            if isinstance(fp, str) and isinstance(text, str):
                self._histories[fp] = text
        #: job id → lease wait, correlated from lease_grant to done
        self._pending_lease: Dict[Any, float] = {}
        self._closed = False
        #: optional service.overload.DegradedWriter: ENOSPC drops records
        #: cheaply (counted, evented) and re-arms when the disk recovers
        self.writer = None

    def _append(self, seg_log: SegmentLog, payload: bytes) -> bool:
        """One append, through the degradation policy when armed."""
        if self.writer is not None:
            _, landed = self.writer.run(lambda: seg_log.append(payload))
            return landed
        try:
            seg_log.append(payload)
            return True
        except (OSError, ValueError, TypeError):
            return False  # archival must never take a job down

    # -- write side ---------------------------------------------------------

    def observe_event(self, ev: Dict[str, Any]) -> None:
        """Absorb one ServiceStats event line (fed outside the sink lock)."""
        name = ev.get("ev") or ev.get("event")
        if name == "lease_grant":
            with self._lock:
                if len(self._pending_lease) < 4096:  # leak guard
                    self._pending_lease[ev.get("job")] = float(
                        ev.get("wait_s", 0.0) or 0.0
                    )
            return
        if name != "done":
            return
        rec: Dict[str, Any] = {
            k: ev[k] for k in _COPY_FIELDS if ev.get(k) is not None
        }
        if ev.get("fingerprint") is not None:
            rec["fp"] = ev["fingerprint"]
        if isinstance(ev.get("profile"), dict):
            rec["profile"] = ev["profile"]
        if ev.get("shards"):
            rec["shards"] = ev["shards"]
        with self._lock:
            lease = self._pending_lease.pop(ev.get("job"), None)
            if lease is not None:
                rec["lease_wait_s"] = lease
            if self._closed:
                return
            try:
                payload = json.dumps(
                    rec, separators=(",", ":"), default=str
                ).encode("utf-8")
            except (ValueError, TypeError):
                return  # archival must never take a job down
            if not self._append(self._records_log, payload):
                return
            self._records.append(rec)

    def add_history(self, fp: str, text: str) -> bool:
        """Store an admitted history once per fingerprint; True when new."""
        with self._lock:
            if self._closed or fp in self._histories:
                return False
            payload = json.dumps(
                {"fp": fp, "history": text}, separators=(",", ":")
            ).encode("utf-8")
            if not self._append(self._corpus_log, payload):
                return False
            self._histories[fp] = text
            return True

    # -- read side ----------------------------------------------------------

    def query(self, **filters: Any) -> List[Dict[str, Any]]:
        """Filtered record copies; see :func:`filter_records` for keys."""
        with self._lock:
            records = list(self._records)
        return filter_records(records, **filters)

    def history(self, fp: str) -> Optional[str]:
        with self._lock:
            return self._histories.get(fp)

    def histories(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._histories)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "dir": self.dir,
                "records": len(self._records),
                "histories": len(self._histories),
            }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._records_log.close()
            self._corpus_log.close()


# ------------------------------------------------------------- pure readers


def _parse_json_records(payloads: Iterable[bytes]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for payload in payloads:
        try:
            rec = json.loads(payload)
        except ValueError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def read_archive(state_dir: str) -> List[Dict[str, Any]]:
    """Replay ``<state_dir>/profiles/records`` cold, oldest first.
    Read-only: tolerates a missing archive (old daemon) by returning []."""
    directory = _records_dir(os.path.join(state_dir, ARCHIVE_SUBDIR))
    if not os.path.isdir(directory):
        return []
    log = SegmentLog(directory)
    try:
        return _parse_json_records(log.replay())
    finally:
        log.close()


def read_corpus(state_dir: str) -> Dict[str, str]:
    """Replay the deduplicated history corpus cold: {fingerprint: text}."""
    directory = _corpus_dir(os.path.join(state_dir, ARCHIVE_SUBDIR))
    if not os.path.isdir(directory):
        return {}
    log = SegmentLog(directory)
    out: Dict[str, str] = {}
    try:
        for rec in _parse_json_records(log.replay()):
            fp, text = rec.get("fp"), rec.get("history")
            if isinstance(fp, str) and isinstance(text, str):
                out[fp] = text
    finally:
        log.close()
    return out


def filter_records(
    records: List[Dict[str, Any]],
    *,
    shape: Optional[str] = None,
    backend: Optional[str] = None,
    verdict: Optional[int] = None,
    client: Optional[str] = None,
    since: Optional[float] = None,
    slowest: Optional[int] = None,
    limit: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """One filter implementation shared by the live ``profiles`` protocol
    op and the cold CLI path.  ``slowest=N`` sorts by wall time
    descending and wins over ``limit`` (which keeps the newest N)."""
    out = records
    if shape is not None:
        out = [r for r in out if r.get("shape") == shape]
    if backend is not None:
        out = [r for r in out if str(r.get("backend", "")).startswith(backend)]
    if verdict is not None:
        out = [r for r in out if r.get("verdict") == verdict]
    if client is not None:
        out = [r for r in out if r.get("client") == client]
    if since is not None:
        out = [r for r in out if float(r.get("t", 0.0) or 0.0) >= since]
    if slowest is not None:
        out = sorted(
            out, key=lambda r: -float(r.get("wall_s", 0.0) or 0.0)
        )[: max(0, slowest)]
    elif limit is not None:
        out = out[-max(0, limit):]
    return [dict(r) for r in out]
