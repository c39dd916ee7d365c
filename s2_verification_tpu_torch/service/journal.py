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

The port's copy of the JAX package's ``service/journal.py``: the same
records in the same segment logs, so a journal or a grant ledger either
package wrote replays in the other's.

:class:`GrantLedger` applies the same write-ahead discipline to
fleet-distributed frontier search (service/distsearch.py): partition
grants land on disk before they ship, deltas and closures append behind
them, and recovery surfaces the ranges whose ownership was open at death
plus the epoch floor a restarted coordinator must fence from.
"""

from __future__ import annotations

import json
import os
import threading

from ..utils.seglog import SegmentLog

__all__ = ["GRANTS_SUBDIR", "GrantLedger", "JobJournal", "read_grants_cold"]

#: subdirectory of the router's ``--state-dir`` holding the grant ledger
GRANTS_SUBDIR = "distsearch"


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


# --------------------------------------------------------------------------
# Distributed-search grant ledger (service/distsearch.py)
# --------------------------------------------------------------------------


def _fold_grant_records(payloads) -> dict:
    """Replay grant-ledger payloads into per-search ownership state.

    Shared by the live ledger's recovery and the doctor's cold read, so
    both derive the identical view: ``grants`` holds, per partition, the
    newest-epoch grant not yet closed by a ``done`` of an equal-or-newer
    epoch; ``deltas`` the last delta seen per partition; ``max_epoch``
    the fencing floor any future coordinator of the search must exceed.
    """
    searches: dict[str, dict] = {}
    for payload in payloads:
        try:
            rec = json.loads(payload)
        except ValueError:
            continue  # CRC-clean but not JSON: foreign, skip
        search = rec.get("search")
        if not isinstance(search, str) or not search:
            continue
        s = searches.setdefault(
            search,
            {
                "verdict": None,
                "outcome": None,
                "max_epoch": 0,
                "segs": None,
                "parts": None,
                "grants": {},
                "deltas": {},
                "fences": 0,
            },
        )
        try:
            epoch = int(rec.get("epoch") or 0)
        except (TypeError, ValueError):
            epoch = 0
        s["max_epoch"] = max(s["max_epoch"], epoch)
        part = rec.get("part")
        kind = rec.get("rec")
        if kind == "search":
            s["segs"] = rec.get("segs")
            s["parts"] = rec.get("parts")
        elif kind == "grant":
            cur = s["grants"].get(part)
            if cur is None or epoch >= int(cur.get("epoch") or 0):
                s["grants"][part] = rec
        elif kind == "done":
            cur = s["grants"].get(part)
            if cur is not None and epoch >= int(cur.get("epoch") or 0):
                s["grants"].pop(part, None)
        elif kind == "delta":
            s["deltas"][part] = rec
        elif kind == "fence":
            s["fences"] += 1
        elif kind == "verdict":
            s["verdict"] = rec.get("verdict")
            s["outcome"] = rec.get("outcome")
    return searches


class GrantLedger:
    """Write-ahead ledger of frontier-partition ownership.

    The distributed-search analogue of :class:`JobJournal`: the
    coordinator appends a ``grant`` record *before* shipping a partition
    to a backend (grant-before-ship), a ``delta`` record when the
    partition's verdict merges, and a ``done`` when the grant closes —
    so a coordinator killed mid-search leaves, on disk, exactly the set
    of ranges whose ownership was open at death.  At the next boot
    :meth:`recover` surfaces those orphans and, per search, the highest
    epoch ever issued: a re-run of the search starts its epochs *above*
    that floor, which is what makes a zombie node's stale deltas
    detectable (epoch fencing) rather than merely unlikely.

    Same durability substrate as everything else: CRC-checked segment
    log, torn tails recover to a valid prefix, one JSON record per line.
    """

    def __init__(self, directory: str, *, fsync: bool = False) -> None:
        self._log = SegmentLog(directory, fsync=fsync)
        self.boot = os.urandom(8).hex()
        self._lock = threading.Lock()

    def _append(self, rec: dict) -> None:
        rec["boot"] = self.boot
        self._log.append(json.dumps(rec, separators=(",", ":")).encode("utf-8"))

    def search(self, *, search: str, segs: int, parts: int) -> None:
        """Register a search before its first grant (sizing for doctor)."""
        with self._lock:
            self._append(
                {"rec": "search", "search": search, "segs": segs, "parts": parts}
            )

    def grant(
        self,
        *,
        search: str,
        seg: str,
        part: str,
        epoch: int,
        node: str,
        reason: str,
    ) -> None:
        """Must land before the grant frame is sent — the crash window
        between shipping and journaling would otherwise orphan the range
        invisibly.  ``reason`` is ``grant`` / ``regrant`` / ``steal``."""
        with self._lock:
            self._append(
                {
                    "rec": "grant",
                    "search": search,
                    "seg": seg,
                    "part": part,
                    "epoch": epoch,
                    "node": node,
                    "reason": reason,
                }
            )

    def delta(
        self,
        *,
        search: str,
        seg: str,
        part: str,
        epoch: int,
        node: str,
        verdict,
        states: int,
        size: int,
    ) -> None:
        """An accepted (fence-passing) delta merged into the search."""
        with self._lock:
            self._append(
                {
                    "rec": "delta",
                    "search": search,
                    "seg": seg,
                    "part": part,
                    "epoch": epoch,
                    "node": node,
                    "verdict": verdict,
                    "states": states,
                    "bytes": size,
                }
            )

    def done(
        self, *, search: str, seg: str, part: str, epoch: int, reason: str
    ) -> None:
        """Close a grant (``reason`` = ``done`` / ``revoked`` / ``failed``)."""
        with self._lock:
            self._append(
                {
                    "rec": "done",
                    "search": search,
                    "seg": seg,
                    "part": part,
                    "epoch": epoch,
                    "reason": reason,
                }
            )

    def fence(
        self, *, search: str, seg: str, part: str, epoch: int, op: str
    ) -> None:
        """A stale-epoch frame was rejected (the zombie-delta audit trail)."""
        with self._lock:
            self._append(
                {
                    "rec": "fence",
                    "search": search,
                    "seg": seg,
                    "part": part,
                    "epoch": epoch,
                    "op": op,
                }
            )

    def verdict(self, *, search: str, verdict, outcome: str) -> None:
        """The merged search verdict — closes every record of the search."""
        with self._lock:
            self._append(
                {
                    "rec": "verdict",
                    "search": search,
                    "verdict": verdict,
                    "outcome": outcome,
                }
            )

    # -- recovery ------------------------------------------------------------

    def recover(self) -> tuple[list[dict], dict[str, int]]:
        """Replay the ledger: ``(open grants, per-search epoch floor)``.

        Open grants are grants (any boot) never closed by a ``done`` of an
        equal-or-newer epoch, for searches that never reached a verdict —
        the ranges whose ownership was live when the coordinator died.
        The epoch floor is the highest epoch ever issued per search; a new
        coordinator run of the same search must start above it so any
        still-running zombie owner is fenced, never merged.
        """
        searches = _fold_grant_records(self._log.replay())
        orphans = []
        floors: dict[str, int] = {}
        for search, s in searches.items():
            floors[search] = s["max_epoch"]
            if s["verdict"] is not None:
                continue
            for rec in s["grants"].values():
                orphans.append(dict(rec, search=search))
        return orphans, floors

    @property
    def recovery(self):
        return self._log.recovery

    def compact(self) -> None:
        """Drop prior boots' records (their orphans have been re-granted
        under this boot's epochs by the time this runs)."""
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


def read_grants_cold(state_dir: str) -> dict | None:
    """Post-mortem view of a dead coordinator's grant ledger (doctor).

    Replays the segment log read-only; returns ``None`` when the state
    dir has no distsearch ledger at all.  Per search: the verdict (or
    None — the search was live at death), open grants with their owner
    node and epoch, the last delta per range, and the epoch floor a
    restarted coordinator will fence from.
    """
    directory = os.path.join(state_dir, GRANTS_SUBDIR)
    if not os.path.isdir(directory):
        return None
    slog = SegmentLog(directory)
    searches = _fold_grant_records(slog.replay())
    out_searches = {}
    for search, s in searches.items():
        out_searches[search] = {
            "verdict": s["verdict"],
            "outcome": s["outcome"],
            "segs": s["segs"],
            "parts": s["parts"],
            "max_epoch": s["max_epoch"],
            "fences": s["fences"],
            "open_grants": [
                {
                    "part": rec.get("part"),
                    "seg": rec.get("seg"),
                    "node": rec.get("node"),
                    "epoch": rec.get("epoch"),
                    "reason": rec.get("reason"),
                }
                for rec in sorted(
                    s["grants"].values(), key=lambda r: str(r.get("part"))
                )
            ],
            "last_delta": {
                str(part): {
                    "node": rec.get("node"),
                    "epoch": rec.get("epoch"),
                    "verdict": rec.get("verdict"),
                    "states": rec.get("states"),
                    "bytes": rec.get("bytes"),
                }
                for part, rec in sorted(s["deltas"].items(), key=lambda kv: str(kv[0]))
            },
        }
    rec = slog.recovery
    return {
        "searches": out_searches,
        "open_total": sum(
            len(s["open_grants"]) for s in out_searches.values()
        ),
        "recovery": {
            "records": rec.records,
            "segments": rec.segments,
            "torn_tail_bytes": rec.torn_tail_bytes,
            "bad_segments": rec.bad_segments,
        },
    }
