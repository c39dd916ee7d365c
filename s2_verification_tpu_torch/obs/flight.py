"""Flight recorder: bounded on-disk ring of recent events + spans.

An in-memory span ring and a JSONL stats sink are great while the daemon
is alive — and worthless the moment it is SIGKILLed, OOMed, or wedged.
The flight recorder is the black box: a small, *bounded* on-disk ring
(``utils/seglog.SegmentLog`` with ``max_segments``, the same CRC-checked
storage discipline as the verdict cache) under
``<state_dir>/flight/`` that continuously absorbs

- every ServiceStats event (fed by ServiceStats outside its sink lock),
- every completed tracer span (via ``Tracer.span_hook``),
- every alert the AlertEngine fires (``{"k": "alert"}`` records;
  abandoned deliveries additionally leave an ``alert_failed`` dump
  marker),
- explicit **dump** records on SIGTERM / daemon close / SLO breach,
  carrying a full SLO snapshot at that instant,
- periodic resource samples from the ResourceSampler (``{"k": "res"}``
  records: RSS, CPU seconds, fds, threads, GC pauses), so the doctor can
  show the resource timeline *before* a death — an OOM kill reads as a
  climbing RSS line ending mid-flight.

Each record is one JSON object ``{"k": "ev"|"span"|"alert"|"dump"|"res",
"t": wall, ...}``.  Because every append is flushed, the tail survives SIGKILL up
to the last OS write — exactly the property the doctor needs.

:func:`postmortem` is the read side: point it at a dead daemon's
``--state-dir`` and it reconstructs the story — last events, orphaned
journal entries, device-pool leases still open at death, slowest spans,
the SLO picture (replayed from recorded events, which carry their own
timestamps), and whether the death looks clean (last record is a
shutdown dump) or not.  The ``doctor`` CLI subcommand is a thin wrapper
over it.

The port's copy of the JAX package's ``obs/flight.py``: the same records
in the same ring, and the same post-mortem of a state dir either
package's daemon wrote, the prefix store's included
(``service/prefixstore.read_cold``).  One section reads a store whose
writer the port does not have yet: the distributed search's grant ledger
(``<state_dir>/distsearch``, ROADMAP.md queue 1 item 6).  Its key stays,
``None`` as in a state dir without one, and a state dir that holds one
lists it under ``unread``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..utils.seglog import SegmentLog
from .health import SLOConfig, SLOHealth

__all__ = ["FlightRecorder", "read_flight", "postmortem", "render_postmortem"]

FLIGHT_SUBDIR = "flight"


class FlightRecorder:
    """Continuously-flushed bounded ring of observability records."""

    def __init__(
        self,
        directory: str,
        *,
        max_segment_bytes: int = 256 << 10,
        max_segments: int = 8,
        fsync: bool = False,
    ) -> None:
        self._log = SegmentLog(
            directory,
            max_segment_bytes=max_segment_bytes,
            max_segments=max_segments,
            fsync=fsync,
        )
        self._closed = False
        #: optional service.overload.DegradedWriter: on ENOSPC the ring
        #: drops records cheaply (counted, evented) and re-arms when the
        #: disk recovers, instead of paying a failing syscall per record
        self.writer = None

    def _append(self, rec: Dict[str, Any]) -> None:
        if self._closed:
            return
        try:
            payload = json.dumps(rec, separators=(",", ":"), default=str).encode(
                "utf-8"
            )
            if self.writer is not None:
                self.writer.run(lambda: self._log.append(payload))
                return
            self._log.append(payload)
        except (OSError, ValueError, TypeError):
            pass  # the black box must never take the plane down

    def record_event(self, ev: Dict[str, Any]) -> None:
        """Absorb one ServiceStats event line (already has ``t``/``event``)."""
        self._append({"k": "ev", **ev})

    def record_span(self, span: Dict[str, Any]) -> None:
        """Absorb one completed tracer span (Tracer.span_hook target)."""
        if span.get("ph") != "X":
            return
        self._append({"k": "span", "t": round(time.time(), 6), **span})

    def record_alert(self, alert: Dict[str, Any]) -> None:
        """Absorb one fired alert (AlertEngine target); delivery failures
        arrive separately as ``alert_failed`` dump markers."""
        self._append({"k": "alert", "t": round(time.time(), 6), **alert})

    def record_resource(self, sample: Dict[str, Any]) -> None:
        """Absorb one ResourceSampler sample (already has ``t``)."""
        self._append({"k": "res", **sample})

    def dump(self, reason: str, **extra: Any) -> None:
        """Write a marker record (shutdown / sigterm / slo_breach) with
        whatever context the caller attaches (usually ``slo=snapshot``)."""
        self._append({"k": "dump", "t": round(time.time(), 6), "reason": reason, **extra})

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._log.close()


# --------------------------------------------------------------- read side


def read_flight(state_dir: str) -> List[Dict[str, Any]]:
    """Replay a state dir's flight ring → record dicts, oldest first.
    Read-only: tolerates a missing ring (old daemon) by returning []."""
    directory = os.path.join(state_dir, FLIGHT_SUBDIR)
    if not os.path.isdir(directory):
        return []
    log = SegmentLog(directory)
    out: List[Dict[str, Any]] = []
    try:
        for payload in log.replay():
            try:
                rec = json.loads(payload)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    finally:
        log.close()
    return out


def _journal_orphans(state_dir: str) -> List[Dict[str, Any]]:
    journal_dir = os.path.join(state_dir, "journal")
    if not os.path.isdir(journal_dir):
        return []
    # local import: journal pulls in the service package; doctor must not
    # need a running daemon's deps beyond stdlib + seglog
    from ..service.journal import JobJournal

    j = JobJournal(journal_dir)
    try:
        return j.orphans()
    finally:
        j.close()


def postmortem(
    state_dir: str,
    *,
    tail: int = 40,
    slow: int = 10,
    slo_config: Optional[SLOConfig] = None,
) -> Dict[str, Any]:
    """Reconstruct a dead daemon's last moments from its state dir.

    Pure read: never creates directories, never appends.  Returns a dict
    with the flight tail, orphaned journal entries, open leases, slowest
    spans, breach dumps, the replayed SLO picture at death, and a
    clean/unclean verdict.
    """
    records = read_flight(state_dir)
    events = [r for r in records if r.get("k") == "ev"]
    spans = [r for r in records if r.get("k") == "span"]
    dumps = [r for r in records if r.get("k") == "dump"]
    alerts = [r for r in records if r.get("k") == "alert"]
    resources = [r for r in records if r.get("k") == "res"]

    # Open leases: grants never matched by a release/timeout of the same job.
    open_leases: Dict[Any, Dict[str, Any]] = {}
    # Degraded writers: writer_degraded events not healed by a later
    # writer_recovered for the same writer.  Cancellations: counts by
    # reason, so "deadline ×12" reads at a glance.
    degraded_writers: Dict[str, Dict[str, Any]] = {}
    cancellations: Dict[str, int] = {}
    for ev in events:
        name = ev.get("ev") or ev.get("event")
        if name == "lease_grant":
            open_leases[ev.get("job")] = ev
        elif name in ("lease_release", "lease_timeout"):
            open_leases.pop(ev.get("job"), None)
        elif name == "writer_degraded":
            degraded_writers[str(ev.get("writer", "?"))] = ev
        elif name == "writer_recovered":
            degraded_writers.pop(str(ev.get("writer", "?")), None)
        elif name == "job_cancelled":
            reason = str(ev.get("reason", "other"))
            cancellations[reason] = cancellations.get(reason, 0) + 1

    # SLO at death: replay recorded request-outcome events (each carries
    # its own wall ``t``) into a fresh engine, evaluated at the last
    # recorded instant so the windows reflect the moment of death rather
    # than "now".
    last_t = max((float(r.get("t", 0.0)) for r in records), default=time.time())
    engine = SLOHealth(slo_config, time_fn=lambda: last_t)
    for ev in events:
        engine.observe_event(ev)
    slo_at_death = engine.snapshot()

    slowest = sorted(
        (s for s in spans if isinstance(s.get("dur"), (int, float))),
        key=lambda s: -float(s["dur"]),
    )[:slow]

    breaches = [d for d in dumps if d.get("reason") == "slo_breach"]
    alert_failures = [d for d in dumps if d.get("reason") == "alert_failed"]

    # Slowest archived jobs: the profile archive shares the state dir; a
    # pre-archive daemon simply has none.
    from .archive import filter_records, read_archive

    slowest_jobs = filter_records(read_archive(state_dir), slowest=slow)

    last = records[-1] if records else None
    clean = bool(
        last
        and last.get("k") == "dump"
        and last.get("reason") in ("shutdown", "sigterm", "sigint")
    )

    # Quarantine ledger: cold read of the store file — the dead daemon's
    # poison history is part of the story (a crash loop often IS a poison
    # job the threshold never caught).
    quarantine: Dict[str, Any] = {}
    qpath = os.path.join(state_dir, "quarantine", "quarantine.json")
    try:
        with open(qpath, encoding="utf-8") as f:
            qdata = json.load(f)
        if isinstance(qdata, dict):
            quarantine = {
                "quarantined": qdata.get("quarantined", {}) or {},
                "crashes": qdata.get("crashes", {}) or {},
            }
    except (OSError, ValueError):
        pass

    # Prefix store: cold replay of the chain-hash frontier log, plus the
    # hit/miss picture from the flight events — together they answer
    # "was incremental verification pulling its weight when it died?".
    from ..service.prefixstore import read_cold as read_prefix_cold

    prefix_store = read_prefix_cold(state_dir)

    # The grant ledger waits for its writer (see the module docstring):
    # reported as absent, and named when on disk.
    distsearch = None
    unread = [
        sub for sub in ("distsearch",) if os.path.isdir(os.path.join(state_dir, sub))
    ]

    # Telemetry history (obs/tsdb.py): cold read of the durable metric
    # rings under <state_dir>/telemetry — the trajectory of the load
    # picture in the daemon's final stretch, plus the sentinel baselines
    # the *next* boot will seed from.  Pre-telemetry state dirs simply
    # have no rings.
    from .tsdb import default_dir as _telemetry_default_dir
    from .tsdb import last_values as _telemetry_last
    from .tsdb import query as _telemetry_query
    from .tsdb import telemetry_info as _telemetry_info

    telemetry: Optional[Dict[str, Any]] = None
    tdir = _telemetry_default_dir(state_dir)
    if os.path.isdir(tdir):
        info = _telemetry_info(tdir)
        tel_last_t, finals = _telemetry_last(tdir)
        kept = {
            key: val
            for key, val in finals.items()
            if key.startswith(
                (
                    "verifyd_jobs_completed_total",
                    "verifyd_queue_depth",
                    "verifyd_resource_rss_bytes",
                    "verifyd_perf_baseline_wall_seconds",
                    "verifyd_perf_regression_fired",
                    "verifyd_slo_healthy",
                )
            )
        }
        trajectories: Dict[str, Any] = {}
        for metric in ("verifyd_queue_depth", "verifyd_resource_rss_bytes"):
            q = _telemetry_query(tdir, metric=metric, limit=tail)
            trajectories.update(q["series"])
        telemetry = {
            "dir": tdir,
            "resolutions": info["resolutions"],
            "last_t": tel_last_t,
            "final_values": kept,
            "trajectories": trajectories,
        }

    prefix_activity: Dict[str, int] = {}
    for ev in events:
        name = ev.get("ev") or ev.get("event")
        if name in (
            "prefix_hit",
            "prefix_miss",
            "prefix_snapshot",
            "prefix_refused",
            "window_done",
        ):
            prefix_activity[name] = prefix_activity.get(name, 0) + 1

    # Search progress: the last heartbeat per job from the ring.  A job
    # with a heartbeat but no later terminal event (done / job_error /
    # job_cancelled) was mid-search when the daemon died — its last
    # reported ratio and ETA are the honest "how far did it get".
    progress_last: Dict[Any, Dict[str, Any]] = {}
    progress_beats = 0
    progress_finished: set = set()
    for ev in events:
        name = ev.get("ev") or ev.get("event")
        if name == "search_progress":
            progress_beats += 1
            progress_last[ev.get("job")] = ev
        elif name in ("done", "job_error", "job_cancelled"):
            progress_finished.add(ev.get("job"))
    at_death = [
        {
            "job": job,
            "engine": ev.get("engine"),
            "ops_committed": ev.get("ops_committed"),
            "total_ops": ev.get("total_ops"),
            "progress_ratio": ev.get("progress_ratio"),
            "eta_s": ev.get("eta_s"),
            "fingerprint": ev.get("fingerprint"),
            "t": ev.get("t"),
        }
        for job, ev in sorted(
            progress_last.items(), key=lambda kv: str(kv[0])
        )
        if job not in progress_finished
    ]
    search_progress = {
        "heartbeats": progress_beats,
        "jobs": len(progress_last),
        "in_flight_at_death": at_death,
    }

    out = {
        "state_dir": state_dir,
        "records": len(records),
        "events": len(events),
        "spans": len(spans),
        "dumps": dumps,
        "breaches": breaches,
        "alerts": alerts,
        "alert_failures": alert_failures,
        "slowest_jobs": slowest_jobs,
        "clean_shutdown": clean,
        "last_record": last,
        "tail": records[-tail:],
        "orphans": _journal_orphans(state_dir),
        "open_leases": list(open_leases.values()),
        "quarantine": quarantine,
        "degraded_writers": list(degraded_writers.values()),
        "cancellations": cancellations,
        "slowest_spans": slowest,
        "slo_at_death": slo_at_death,
        "prefix_store": prefix_store,
        "prefix_activity": prefix_activity,
        "telemetry": telemetry,
        "search_progress": search_progress,
        "distsearch": distsearch,
        # Resource timeline before death: keep the tail — the interesting
        # part of an OOM story is the last few minutes, not the first.
        "resources": resources[-tail:],
        "resource_samples": len(resources),
    }
    if unread:
        out["unread"] = unread
    return out


def _fmt_t(t: Any) -> str:
    try:
        return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(float(t)))
    except (TypeError, ValueError, OverflowError):
        return "?"


def render_postmortem(pm: Dict[str, Any], *, tail: int = 20) -> str:
    """Human-readable doctor report (the --json flag skips this)."""
    lines: List[str] = []
    add = lines.append
    add("== verifyd doctor: %s ==" % pm["state_dir"])
    add(
        "flight ring: %d records (%d events, %d spans, %d dumps)"
        % (pm["records"], pm["events"], pm["spans"], len(pm["dumps"]))
    )
    verdict = "clean shutdown" if pm["clean_shutdown"] else "UNCLEAN DEATH"
    last = pm["last_record"]
    if last is not None:
        add(
            "last record: %s %s at %s  -> %s"
            % (
                last.get("k"),
                last.get("reason") or last.get("ev") or last.get("name", ""),
                _fmt_t(last.get("t")),
                verdict,
            )
        )
    else:
        add("last record: none (empty or missing flight ring) -> %s" % verdict)

    if pm["breaches"]:
        add("")
        add("-- SLO breaches recorded (%d) --" % len(pm["breaches"]))
        for b in pm["breaches"][-5:]:
            reasons = b.get("breach", {}).get("reasons") or b.get("reasons") or []
            why = "; ".join(
                "%s burn=%.1f on %s"
                % (r.get("kind"), r.get("burn_rate", 0.0), r.get("window"))
                for r in reasons
            )
            add("  %s  %s" % (_fmt_t(b.get("t")), why or "(no detail)"))

    if pm.get("alerts"):
        add("")
        add("-- alerts fired (last %d) --" % min(10, len(pm["alerts"])))
        for a in pm["alerts"][-10:]:
            add(
                "  %s  %-16s rule=%s severity=%s"
                % (
                    _fmt_t(a.get("t")),
                    a.get("event", "?"),
                    a.get("rule"),
                    a.get("severity", "?"),
                )
            )

    if pm.get("alert_failures"):
        add("")
        add(
            "-- alert deliveries abandoned: %d --" % len(pm["alert_failures"])
        )
        for d in pm["alert_failures"][-5:]:
            add(
                "  %s  rule=%s attempts=%s error=%s"
                % (
                    _fmt_t(d.get("t")),
                    d.get("rule"),
                    d.get("attempts"),
                    d.get("error"),
                )
            )

    slo = pm["slo_at_death"]
    add("")
    add(
        "-- SLO at death (target %.3f) --  %s"
        % (
            slo["availability_target"],
            "healthy" if slo["healthy"] else "DEGRADED: %s" % json.dumps(slo["reasons"]),
        )
    )
    for wname, w in slo["windows"].items():
        add(
            "  %-4s avail=%.4f burn=%.1f good=%d bad=%d p95=%s"
            % (
                wname,
                w["availability"],
                w["burn_rate"],
                w["good"],
                w["bad"],
                w["latency"].get("p95"),
            )
        )

    if pm["orphans"]:
        add("")
        add("-- orphaned journal entries (accepted, never closed): %d --" % len(pm["orphans"]))
        for rec in pm["orphans"][:10]:
            add(
                "  job=%s fp=%s client=%s"
                % (rec.get("job"), str(rec.get("fp", ""))[:16], rec.get("client"))
            )

    q = pm.get("quarantine") or {}
    if q.get("quarantined") or q.get("crashes"):
        add("")
        add(
            "-- quarantine: %d fingerprint(s) held, %d with crash history --"
            % (len(q.get("quarantined", {})), len(q.get("crashes", {})))
        )
        for fp, ent in sorted(q.get("quarantined", {}).items())[:10]:
            add(
                "  HELD %s  crashes=%s kinds=%s since=%s"
                % (
                    fp[:16],
                    ent.get("crashes"),
                    json.dumps(ent.get("kinds", {}), sort_keys=True),
                    _fmt_t(ent.get("since")),
                )
            )
        for fp, ent in sorted(q.get("crashes", {}).items())[:10]:
            if fp not in q.get("quarantined", {}):
                add("  warm %s  crashes=%s" % (fp[:16], ent.get("count")))

    if pm.get("degraded_writers"):
        add("")
        add(
            "-- writers degraded at death: %d --" % len(pm["degraded_writers"])
        )
        for ev in pm["degraded_writers"]:
            add(
                "  %s  writer=%s error=%s"
                % (_fmt_t(ev.get("t")), ev.get("writer"), ev.get("error"))
            )

    if pm.get("cancellations"):
        add("")
        add(
            "-- cancellations --  "
            + "  ".join(
                "%s=%d" % (r, n)
                for r, n in sorted(pm["cancellations"].items())
            )
        )

    if pm["open_leases"]:
        add("")
        add("-- device-pool leases open at death: %d --" % len(pm["open_leases"]))
        for ev in pm["open_leases"]:
            add(
                "  job=%s devices=%s granted at %s"
                % (ev.get("job"), ev.get("devices"), _fmt_t(ev.get("t")))
            )

    if pm["slowest_spans"]:
        add("")
        add("-- slowest spans --")
        for s in pm["slowest_spans"]:
            add(
                "  %8.1f ms  %-20s tid=%s %s"
                % (
                    float(s.get("dur", 0.0)) / 1000.0,
                    s.get("name"),
                    s.get("tid"),
                    json.dumps(s.get("args", {}), sort_keys=True) if s.get("args") else "",
                )
            )

    if pm.get("slowest_jobs"):
        add("")
        add("-- slowest archived jobs --")
        for r in pm["slowest_jobs"]:
            add(
                "  %8.1f ms  job=%s shape=%s backend=%s verdict=%s client=%s"
                % (
                    float(r.get("wall_s", 0.0) or 0.0) * 1000.0,
                    r.get("job"),
                    r.get("shape"),
                    r.get("backend"),
                    r.get("verdict"),
                    r.get("client"),
                )
            )

    ps = pm.get("prefix_store")
    activity = pm.get("prefix_activity") or {}
    if ps is not None or activity:
        add("")
        if ps is None:
            add("-- prefix store: no on-disk log (in-memory only) --")
        else:
            rec = ps.get("recovery") or {}
            add(
                "-- prefix store: %d frontier(s), %d bytes, deepest %d ops --"
                % (ps.get("entries", 0), ps.get("bytes", 0), ps.get("deepest_ops", 0))
            )
            add(
                "  log: %s segment(s), %s record(s) replayed, "
                "torn tail %sB, %s bad segment(s)"
                % (
                    rec.get("segments", "?"),
                    rec.get("records", "?"),
                    rec.get("torn_tail_bytes", "?"),
                    rec.get("bad_segments", "?"),
                )
            )
            for stream, info in sorted(ps.get("streams", {}).items())[:10]:
                add(
                    "  stream %-20s frontier at %d ops (window %s, %d events)"
                    % (
                        stream,
                        info.get("ops", 0),
                        info.get("window", "?"),
                        info.get("events", 0),
                    )
                )
        hits = activity.get("prefix_hit", 0)
        misses = activity.get("prefix_miss", 0)
        if hits or misses:
            add(
                "  probes: %d hit / %d miss (%.0f%% warm), %d snapshot(s), "
                "%d refused, %d window(s)"
                % (
                    hits,
                    misses,
                    100.0 * hits / (hits + misses),
                    activity.get("prefix_snapshot", 0),
                    activity.get("prefix_refused", 0),
                    activity.get("window_done", 0),
                )
            )
        elif activity:
            add(
                "  probes: none recorded; %d snapshot(s), %d refused, "
                "%d window(s)"
                % (
                    activity.get("prefix_snapshot", 0),
                    activity.get("prefix_refused", 0),
                    activity.get("window_done", 0),
                )
            )

    sp = pm.get("search_progress") or {}
    if sp.get("heartbeats"):
        add("")
        add(
            "-- search progress: %d heartbeat(s) across %d job(s) --"
            % (sp.get("heartbeats", 0), sp.get("jobs", 0))
        )
        stuck = sp.get("in_flight_at_death") or []
        if not stuck:
            add("  every heartbeating job reached a terminal event")
        for row in stuck[:10]:
            ratio = row.get("progress_ratio")
            eta = row.get("eta_s")
            add(
                "  MID-SEARCH job=%s engine=%s %s/%s ops (%s) eta %s  "
                "fp=%s  last beat %s"
                % (
                    row.get("job"),
                    row.get("engine"),
                    row.get("ops_committed"),
                    row.get("total_ops"),
                    "%.0f%%" % (100.0 * float(ratio))
                    if ratio is not None
                    else "?",
                    "%.1fs" % float(eta) if eta is not None else "?",
                    str(row.get("fingerprint") or "")[:20],
                    _fmt_t(row.get("t")),
                )
            )

    ds = pm.get("distsearch")
    if ds is not None:
        rec = ds.get("recovery") or {}
        add("")
        add(
            "-- distributed search: %d search(es), %d grant(s) open at "
            "death --"
            % (len(ds.get("searches", {})), ds.get("open_total", 0))
        )
        add(
            "  ledger: %s record(s) in %s segment(s), torn tail %sB, "
            "%s bad segment(s)"
            % (
                rec.get("records", "?"),
                rec.get("segments", "?"),
                rec.get("torn_tail_bytes", "?"),
                rec.get("bad_segments", "?"),
            )
        )
        for search, info in sorted(ds.get("searches", {}).items())[:10]:
            verdict = info.get("verdict")
            add(
                "  search %s  %s  segs=%s parts=%s max_epoch=%s fences=%s"
                % (
                    search[:16],
                    (
                        "UNDECIDED AT DEATH"
                        if verdict is None
                        else "verdict=%s (%s)" % (verdict, info.get("outcome"))
                    ),
                    info.get("segs", "?"),
                    info.get("parts", "?"),
                    info.get("max_epoch", 0),
                    info.get("fences", 0),
                )
            )
            for g in (info.get("open_grants") or [])[:8]:
                add(
                    "    OPEN range %s  node=%s epoch=%s (%s) seg=%s"
                    % (
                        g.get("part"),
                        g.get("node"),
                        g.get("epoch"),
                        g.get("reason"),
                        str(g.get("seg", ""))[:20],
                    )
                )
            for part, d in sorted((info.get("last_delta") or {}).items())[:8]:
                add(
                    "    last delta range %s  node=%s epoch=%s verdict=%s "
                    "states=%s bytes=%s"
                    % (
                        part,
                        d.get("node"),
                        d.get("epoch"),
                        d.get("verdict"),
                        d.get("states"),
                        d.get("bytes"),
                    )
                )

    tel = pm.get("telemetry")
    if tel is not None:
        add("")
        add("-- telemetry history: %s --" % tel.get("dir"))
        for res, info in sorted((tel.get("resolutions") or {}).items()):
            rec = info.get("recovery") or {}
            add(
                "  %-3s %6s record(s) %4s series %9sB  last %s  "
                "torn tail %sB, %s bad segment(s)"
                % (
                    res,
                    info.get("records", 0),
                    info.get("series", 0),
                    info.get("bytes", 0),
                    _fmt_t(info.get("last_t")),
                    rec.get("torn_tail_bytes", "?"),
                    rec.get("bad_segments", "?"),
                )
            )
        finals = tel.get("final_values") or {}
        baselines = sorted(
            k
            for k in finals
            if k.startswith("verifyd_perf_baseline_wall_seconds")
        )
        if baselines:
            add("  sentinel baselines at death (the next boot seeds these):")
            for k in baselines[:10]:
                fired_key = k.replace(
                    "verifyd_perf_baseline_wall_seconds",
                    "verifyd_perf_regression_fired",
                )
                add(
                    "    %s = %.4fs%s"
                    % (
                        k,
                        finals[k],
                        "  LATCHED"
                        if finals.get(fired_key, 0.0) >= 0.5
                        else "",
                    )
                )
        for key, pts in sorted((tel.get("trajectories") or {}).items()):
            if not pts:
                continue
            vals = [p[1] for p in pts]
            add(
                "  %s: last %d point(s)  min=%.1f max=%.1f final=%.1f"
                % (key, len(pts), min(vals), max(vals), vals[-1])
            )

    if pm.get("resources"):
        add("")
        add(
            "-- resource timeline (last %d of %d samples) --"
            % (len(pm["resources"]), pm.get("resource_samples", len(pm["resources"])))
        )
        for r in pm["resources"]:
            add(
                "  %s  rss=%7.1fMiB cpu=%8.1fs fds=%-4s threads=%-3s gc=%.3fs"
                % (
                    _fmt_t(r.get("t")),
                    float(r.get("rss_bytes", 0) or 0) / (1 << 20),
                    float(r.get("cpu_s", 0.0) or 0.0),
                    r.get("fds", "?"),
                    r.get("threads", "?"),
                    float(r.get("gc_pause_s", 0.0) or 0.0),
                )
            )

    if pm.get("unread"):
        add("")
        add(
            "-- not read (this package has no reader yet): %s --"
            % ", ".join(pm["unread"])
        )

    if pm["tail"]:
        add("")
        add("-- flight tail (last %d of %d) --" % (min(tail, len(pm["tail"])), pm["records"]))
        for rec in pm["tail"][-tail:]:
            kind = rec.get("k")
            if kind == "ev":
                body = rec.get("ev") or rec.get("event") or "?"
                detail = {
                    k: v
                    for k, v in rec.items()
                    if k not in ("k", "t", "ev", "event")
                    and not isinstance(v, (dict, list))
                }
                add(
                    "  %s ev   %-14s %s"
                    % (_fmt_t(rec.get("t")), body, json.dumps(detail, sort_keys=True, default=str))
                )
            elif kind == "span":
                add(
                    "  %s span %-14s dur=%.1fms tid=%s"
                    % (
                        _fmt_t(rec.get("t")),
                        rec.get("name", "?"),
                        float(rec.get("dur", 0.0)) / 1000.0,
                        rec.get("tid"),
                    )
                )
            elif kind == "alert":
                add(
                    "  %s ALRT %-14s rule=%s"
                    % (
                        _fmt_t(rec.get("t")),
                        rec.get("event", "?"),
                        rec.get("rule"),
                    )
                )
            elif kind == "res":
                add(
                    "  %s res  rss=%.1fMiB threads=%s"
                    % (
                        _fmt_t(rec.get("t")),
                        float(rec.get("rss_bytes", 0) or 0) / (1 << 20),
                        rec.get("threads", "?"),
                    )
                )
            else:
                add(
                    "  %s DUMP %s"
                    % (_fmt_t(rec.get("t")), rec.get("reason", "?"))
                )
    return "\n".join(lines) + "\n"
