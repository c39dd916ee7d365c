"""Per-job progress table: heartbeats in, watchable rows + ETA out.

The scheduler gives every running job a :class:`~..checker.progress.
ProgressSink` built here; each heartbeat folds into one row per job —
monotone ``ops_committed``, EWMA-smoothed layer/ops rates, and an ETA
derived from the smoothed ops rate.  The table is the single source the
``watch`` protocol op, the ``stats`` snapshot, the dashboard panel, and
the ``search_progress`` event stream all read from.

Locking discipline: row folds happen under the table lock; the
``on_heartbeat`` callback (the daemon's event-emission hook) runs
*outside* it with a snapshot copy, mirroring ServiceStats' sink rule —
a slow consumer must never serialize the engines' layer loops.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..checker.progress import ProgressSink

__all__ = ["JobProgress"]

#: progress rows remembered after a job finishes (watch on a just-done
#: job answers from here instead of UnknownJob)
_DONE_KEEP = 64


class JobProgress:
    """Fold per-engine heartbeats into watchable per-job progress rows.

    ``interval_s`` is the sink cadence handed to every job (0 disables
    heartbeats entirely — :meth:`sink_for` returns ``None``).
    ``ewma_alpha`` smooths the instantaneous rates; ``time_fn`` is
    injectable for deterministic ETA tests.  ``on_heartbeat`` is called
    with a row snapshot after each fold, outside the table lock.
    """

    def __init__(
        self,
        *,
        interval_s: float = 0.5,
        ewma_alpha: float = 0.3,
        time_fn=time.monotonic,
        on_heartbeat=None,
    ) -> None:
        self.interval_s = interval_s
        self.alpha = ewma_alpha
        self._time = time_fn
        self.on_heartbeat = on_heartbeat
        self._lock = threading.Lock()
        self._rows: dict[int, dict] = {}
        self._done: OrderedDict[int, dict] = OrderedDict()

    # -- producer side ------------------------------------------------------

    def sink_for(
        self,
        job_id: int,
        *,
        fingerprint: str = "",
        shape: str = "",
        trace_id: str | None = None,
    ) -> ProgressSink | None:
        """Register a row for a starting job and return its sink (``None``
        when heartbeats are disabled).  The row exists from job start, so
        ``watch`` sees active jobs before their first heartbeat."""
        if self.interval_s <= 0:
            return None
        now = self._time()
        row = {
            "job": job_id,
            "fingerprint": fingerprint,
            "shape": shape,
            "trace_id": trace_id,
            "engine": "other",
            "ops_committed": 0,
            "total_ops": 0,
            "frontier_width": 0,
            "states_expanded": 0,
            "layer": 0,
            "layer_rate": 0.0,
            "ops_rate": 0.0,
            "progress_ratio": 0.0,
            "eta_s": None,
            "heartbeats": 0,
            "started_at": now,
            "updated_at": now,
            "done": False,
            "outcome": None,
        }
        with self._lock:
            self._rows[job_id] = row
        return ProgressSink(
            lambda rec: self._fold(job_id, rec),
            min_interval_s=self.interval_s,
            time_fn=self._time,
        )

    def _fold(self, job_id: int, rec: dict) -> None:
        now = self._time()
        with self._lock:
            row = self._rows.get(job_id)
            if row is None:
                return
            ops = max(int(rec.get("ops_committed", 0)), row["ops_committed"])
            dt = max(now - row["updated_at"], 1e-9)
            inst_ops_rate = (ops - row["ops_committed"]) / dt
            a = self.alpha
            if row["heartbeats"] == 0:
                row["layer_rate"] = float(rec.get("layer_rate", 0.0))
                row["ops_rate"] = inst_ops_rate
            else:
                row["layer_rate"] = (
                    a * float(rec.get("layer_rate", 0.0))
                    + (1 - a) * row["layer_rate"]
                )
                row["ops_rate"] = a * inst_ops_rate + (1 - a) * row["ops_rate"]
            row["ops_committed"] = ops
            row["total_ops"] = max(
                int(rec.get("total_ops", 0)), row["total_ops"]
            )
            row["frontier_width"] = int(rec.get("frontier_width", 0))
            row["states_expanded"] = max(
                int(rec.get("states_expanded", 0)), row["states_expanded"]
            )
            if rec.get("layer") is not None:
                row["layer"] = int(rec["layer"])
            row["engine"] = str(rec.get("engine") or "other")
            total = row["total_ops"]
            row["progress_ratio"] = (
                round(min(ops / total, 1.0), 4) if total > 0 else 0.0
            )
            remaining = max(total - ops, 0)
            row["eta_s"] = (
                round(remaining / row["ops_rate"], 2)
                if row["ops_rate"] > 1e-9 and total > 0
                else None
            )
            row["heartbeats"] += 1
            row["updated_at"] = now
            snap = dict(row)
        if self.on_heartbeat is not None:
            self.on_heartbeat(snap)

    def finish(self, job_id: int, outcome: str | None = None) -> None:
        """Close a job's row (idempotent; unknown ids are a no-op).  The
        row moves to a bounded done-ring so a watch racing the finish
        still answers."""
        with self._lock:
            row = self._rows.pop(job_id, None)
            if row is None:
                return
            row["done"] = True
            row["outcome"] = outcome
            row["updated_at"] = self._time()
            self._done[job_id] = row
            while len(self._done) > _DONE_KEEP:
                self._done.popitem(last=False)

    # -- consumer side ------------------------------------------------------

    def _age(self, row: dict, now: float) -> dict:
        out = dict(row)
        out["age_s"] = round(now - row["updated_at"], 3)
        return out

    def rows(self) -> list[dict]:
        """Snapshot of every active row, job order."""
        now = self._time()
        with self._lock:
            return [self._age(self._rows[j], now) for j in sorted(self._rows)]

    def get(self, job_id: int) -> dict | None:
        now = self._time()
        with self._lock:
            row = self._rows.get(job_id) or self._done.get(job_id)
            return self._age(row, now) if row is not None else None

    def find(self, fingerprint: str, prefix: bool = False) -> list[dict]:
        """Rows whose fingerprint matches exactly — or, with
        ``prefix=True``, starts with ``fingerprint`` (how a distributed
        search's ``ppart:<search16>/`` partitions are collected)."""
        now = self._time()

        def hit(fp: str) -> bool:
            return fp.startswith(fingerprint) if prefix else fp == fingerprint

        with self._lock:
            out = [
                self._age(row, now)
                for j, row in sorted(self._rows.items())
                if hit(row["fingerprint"])
            ]
            if not out:
                out = [
                    self._age(row, now)
                    for j, row in sorted(self._done.items())
                    if hit(row["fingerprint"])
                ]
            return out
