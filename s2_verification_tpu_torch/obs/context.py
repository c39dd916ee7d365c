"""Distributed trace context: ids, frame propagation, and clock rebasing.

The port's own copy of the JAX package's ``obs/context.py`` (plain Python,
unchanged in behaviour; ``tests/test_torch_obs.py`` runs the two side by
side).

A served job crosses three process boundaries — submit client → TCP/unix
daemon → supervised (possibly mesh-sharded) child — and each hop keeps
its own monotonic clock.  This module is the glue that lets one
``trace_id`` follow the job across all three and lets the daemon stitch
the children's span rings into its own timeline:

- **Trace ids** are W3C trace-context style: 16 random bytes as 32 lower
  hex chars, never all-zero (the W3C invalid value).  The submit client
  mints one per request; an old client that sends none gets a
  daemon-minted id, so every job has exactly one.
- **Frame propagation**: the id rides the submit frame in an *optional*
  ``"trace"`` field (:data:`TRACE_FIELD`) together with the client's
  wall-clock send instant — old daemons ignore the field, old clients
  simply never send it, and the HMAC covers it like any other field, so
  the protocol stays backward-compatible in both directions.
- **Child propagation**: supervised children receive the id via a
  ``trace=<id>`` argv extra (:data:`ENV_TRACE` is the env fallback) and
  ship their own span ring back inside the result JSON.
- **Clock rebasing**: span timestamps are microseconds relative to each
  tracer's construction instant.  Every :class:`~.trace.Tracer` records
  the wall-clock time of that instant (``wall_base``), so two rings on
  the same host rebase with ``offset_us = (child.wall_base -
  parent.wall_base) * 1e6`` — the clock-offset handshake.  Residual skew
  (NTP steps, coarse wall clocks) is killed by clamping the rebased
  spans into the parent's observed escalation window, which is what
  guarantees *no negative durations and no child span outside its
  parent* regardless of what the clocks did.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "TRACE_FIELD",
    "ENV_TRACE",
    "new_trace_id",
    "valid_trace_id",
    "trace_frame",
    "parse_trace_frame",
    "rebase_spans",
]

#: optional submit-frame field carrying ``{"trace_id", "sent_wall"}``
TRACE_FIELD = "trace"

#: environment fallback for child trace-id propagation (argv wins)
ENV_TRACE = "S2VTPU_TRACE"


def new_trace_id() -> str:
    """A fresh W3C-style trace id: 32 lower hex chars, never all-zero."""
    while True:
        tid = os.urandom(16).hex()
        if any(c != "0" for c in tid):
            return tid


def valid_trace_id(value: Any) -> bool:
    return (
        isinstance(value, str)
        and len(value) == 32
        and all(c in "0123456789abcdef" for c in value)
        and any(c != "0" for c in value)
    )


def trace_frame(trace_id: str) -> Dict[str, Any]:
    """The submit-frame ``trace`` field a client sends: the id plus the
    wall-clock send instant (lets the daemon reconstruct client wait)."""
    return {"trace_id": trace_id, "sent_wall": round(time.time(), 6)}


def parse_trace_frame(obj: Any) -> Tuple[Optional[str], Optional[float]]:
    """Validate an incoming ``trace`` field → ``(trace_id, sent_wall)``.

    Both come back ``None``-able: a malformed id is treated as absent
    (the daemon mints its own) rather than an error — trace context is
    best-effort metadata, never a reason to refuse a job.
    """
    if not isinstance(obj, dict):
        return None, None
    tid = obj.get("trace_id")
    if not valid_trace_id(tid):
        tid = None
    wall = obj.get("sent_wall")
    try:
        wall = float(wall) if wall is not None else None
    except (TypeError, ValueError):
        wall = None
    return tid, wall


def rebase_spans(
    spans: Sequence[Dict[str, Any]],
    *,
    offset_us: float,
    tid: int,
    pid: int,
    clamp_us: Optional[Tuple[float, float]] = None,
    extra_args: Optional[Dict[str, Any]] = None,
) -> List[Dict[str, Any]]:
    """Rebase a foreign span ring onto a parent timeline.

    ``offset_us`` shifts every timestamp from the child's tracer-relative
    microseconds to the parent's.  ``clamp_us = (lo, hi)`` then pins each
    span inside the parent's observed window for the child (spans that
    drifted outside are shrunk to the boundary and tagged
    ``args.clamped``), which is what makes the merged timeline immune to
    inter-process clock skew: durations can never go negative and a
    child span can never escape the escalation span that contains it.
    Non-"X" events (track-name metadata) are dropped — the parent track
    already has a name.
    """
    out: List[Dict[str, Any]] = []
    for e in spans:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        try:
            ts = float(e.get("ts", 0.0)) + offset_us
            dur = max(0.0, float(e.get("dur", 0.0)))
        except (TypeError, ValueError):
            continue
        end = ts + dur
        clamped = False
        if clamp_us is not None:
            lo, hi = clamp_us
            new_ts = min(max(ts, lo), hi)
            new_end = min(max(end, lo), hi)
            clamped = abs(new_ts - ts) > 0.5 or abs(new_end - end) > 0.5
            ts, end = new_ts, new_end
        args = dict(e.get("args") or {})
        if extra_args:
            args.update(extra_args)
        if clamped:
            args["clamped"] = True
        out.append(
            {
                "name": str(e.get("name", "span")),
                "ph": "X",
                "ts": round(ts, 3),
                "dur": round(max(0.0, end - ts), 3),
                "pid": int(pid),
                "tid": int(tid),
                "cat": str(e.get("cat", "child")),
                "args": args,
            }
        )
    return out
