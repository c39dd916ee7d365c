"""Admission-queue journal: a write-ahead record of accepted jobs.

An accepted submission is a promise — the client got no reject, so it is
entitled to a verdict.  Before this journal, a daemon killed mid-job
silently broke that promise: the queue and every in-flight job lived only
in memory.  Now admission appends an ``accept`` record (fingerprint,
client, priority, *and the history text itself* — the journal is the
re-run source) before the job enters the queue, and completion appends a
``done`` record; a queue-full reject after the accept was already written
appends ``reject`` so the record is closed (the client got the
backpressure reply, nothing was lost).

On restart, :meth:`orphans` replays the log: any ``accept`` without a
matching ``done``/``reject`` *from the same daemon boot* is an orphaned
job — accepted, never answered.  The daemon re-admits each orphan through
the normal path (its verdict lands in the durable cache, so the original
submitter's retry answers warm) and emits an ``orphan`` stats event, then
:meth:`compact` rewrites the log down to the current boot's records.
Semantics are at-least-once: a crash during recovery re-runs an orphan
twice, which the verdict cache dedupes; a job is never silently dropped.

Records ride the CRC-checked segment log (``utils/seglog.py``), so torn
writes and corrupted segments recover to a valid prefix — an orphan whose
accept record itself was torn is the one row this design cannot resurrect
(the write-ahead append had not completed, so the client never got past
admission either).

The port's copy of the JobJournal half of the JAX package's
``service/journal.py``: the same records in the same segment log, so a
journal either package's daemon wrote replays in the other's.  The
distributed search's ``GrantLedger`` and ``read_grants_cold`` wait for the
fleet tier with their callers (ROADMAP.md, queue 1 item 6).
"""

from __future__ import annotations

import json
import os
import threading

from ..utils.seglog import SegmentLog

__all__ = ["JobJournal"]


class JobJournal:
    def __init__(self, directory: str, *, fsync: bool = False) -> None:
        self._log = SegmentLog(directory, fsync=fsync)
        #: distinguishes this daemon run's records from prior boots'
        #: (job ids restart at 1 every boot, so (boot, job) is the key)
        self.boot = os.urandom(8).hex()
        self._lock = threading.Lock()

    # -- write-ahead records -------------------------------------------------

    def _append(self, rec: dict) -> None:
        rec["boot"] = self.boot
        self._log.append(json.dumps(rec, separators=(",", ":")).encode("utf-8"))

    def accept(
        self,
        *,
        job: int,
        fingerprint: str,
        client: str,
        priority: int,
        history: str,
    ) -> None:
        """Must land before the job enters the queue — the crash window
        between queue admission and journaling would otherwise lose it."""
        with self._lock:
            self._append(
                {
                    "rec": "accept",
                    "job": job,
                    "fp": fingerprint,
                    "client": client,
                    "priority": priority,
                    "history": history,
                }
            )

    def started(self, *, job: int, fingerprint: str) -> None:
        """A worker picked the job up.  The record is what separates a
        *poison* orphan (started, then the process died — chargeable to
        the job) from an innocent one that merely sat in the queue; the
        quarantine ledger only counts the former."""
        with self._lock:
            self._append({"rec": "run", "job": job, "fp": fingerprint})

    def reject(self, job: int) -> None:
        """Close an accept whose queue admission was refused (the client
        got the backpressure reply; nothing is owed)."""
        with self._lock:
            self._append({"rec": "reject", "job": job})

    def done(
        self,
        *,
        job: int,
        fingerprint: str,
        verdict: int | None,
        outcome: str,
    ) -> None:
        with self._lock:
            self._append(
                {
                    "rec": "done",
                    "job": job,
                    "fp": fingerprint,
                    "verdict": verdict,
                    "outcome": outcome,
                }
            )

    # -- recovery ------------------------------------------------------------

    def orphans(self) -> list[dict]:
        """Replay the log; return accept records (any boot) that were
        never closed by a done/reject of the same (boot, job).  Duplicate
        fingerprints collapse to one re-run (the cache answers the rest).
        Each record carries ``started``: whether a worker had picked the
        job up before the death (the quarantine ledger's poison signal)."""
        open_jobs: dict[tuple[str, int], dict] = {}
        runs: set[tuple[str, int]] = set()
        for payload in self._log.replay():
            try:
                rec = json.loads(payload)
            except ValueError:
                continue  # CRC-clean but not JSON: treat as foreign, skip
            key = (rec.get("boot", ""), int(rec.get("job", 0)))
            kind = rec.get("rec")
            if kind == "accept":
                open_jobs[key] = rec
            elif kind == "run":
                runs.add(key)
            elif kind in ("done", "reject"):
                open_jobs.pop(key, None)
        started_fp = {
            rec.get("fp", "")
            for key, rec in open_jobs.items()
            if key in runs
        }
        seen_fp: set[str] = set()
        out = []
        for rec in open_jobs.values():
            fp = rec.get("fp", "")
            # any open duplicate of this fp having started marks them all
            rec["started"] = fp in started_fp
            if fp in seen_fp:
                continue
            seen_fp.add(fp)
            out.append(rec)
        return out

    @property
    def recovery(self):
        return self._log.recovery

    def compact(self) -> None:
        """Drop prior boots' records (their orphans have been re-accepted
        under this boot by the time this runs)."""
        keep = []
        for payload in self._log.replay():
            try:
                if json.loads(payload).get("boot") == self.boot:
                    keep.append(payload)
            except ValueError:
                continue
        self._log.rewrite(keep)

    def close(self) -> None:
        self._log.close()
