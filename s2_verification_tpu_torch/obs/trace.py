"""Bounded in-memory span ring, exportable as Chrome trace_event JSON.

The port's own copy of the JAX package's ``obs/trace.py`` (plain Python,
unchanged in behaviour).

The Tracer records *completed* spans ("X" phase events in the trace_event
format) into a ``collections.deque(maxlen=capacity)``: recording is O(1),
never allocates beyond the ring, and is safe from any thread.  Timestamps
are ``time.monotonic()`` seconds converted to microseconds relative to the
tracer's construction instant, so spans recorded from different threads
share one coherent timeline.

Tracks: the ``tid`` field is a *virtual* track id, not an OS thread id.
verifyd gives every job its own track (``tid = job id``) so the nested
``admit -> queue_wait -> search -> render`` lifecycle of one job reads as
one lane in Perfetto; track 0 is the acceptor ("admission") lane.

The export is a single JSON object ``{"traceEvents": [...],
"displayTimeUnit": "ms"}`` — the JSON Object Format, which both
``chrome://tracing`` and https://ui.perfetto.dev load directly.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .context import rebase_spans

__all__ = ["Tracer", "NULL_TRACER"]

# A track-name metadata set larger than this is reset wholesale: track ids
# are job ids (unbounded over a daemon's life) and the set exists only to
# dedupe "M" events, so losing it merely re-emits a name.
_MAX_NAMED_TRACKS = 65536


class Tracer:
    """Thread-safe bounded span recorder with Chrome trace_event export."""

    def __init__(self, capacity: int = 8192) -> None:
        self.capacity = max(0, int(capacity))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity or 1)
        # Both bases are read at the same instant so wall_base can serve as
        # the cross-process clock-offset handshake: two tracers on the same
        # host rebase each other's spans via their wall_base difference.
        self._base = time.monotonic()
        self.wall_base = time.time()
        self._pid = os.getpid()
        self._named: set = set()
        self._dropped = 0
        #: called with the running drop total each time a span is evicted
        #: (e.g. to bump verifyd_trace_spans_dropped_total); must be cheap
        #: and must not call back into the tracer.
        self.drop_hook: Optional[Callable[[int], None]] = None
        #: called with every completed "X" event dict (e.g. the flight
        #: recorder); invoked outside the ring lock.
        self.span_hook: Optional[Callable[[Dict[str, Any]], None]] = None

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def now(self) -> float:
        """A timestamp suitable for add_span (monotonic seconds)."""
        return time.monotonic()

    def us(self, mono: float) -> float:
        """Convert a ``time.monotonic()`` instant to this tracer's
        trace-relative microseconds (the ``ts`` unit of its spans)."""
        return (mono - self._base) * 1e6

    def mono_of_wall(self, wall: float) -> float:
        """Map a wall-clock instant onto this tracer's monotonic timeline.

        Used to place events that only exist as wall time — e.g. the
        client's ``sent_wall`` from the submit frame — onto the daemon's
        span timeline.  Subject to wall-clock skew; callers clamp.
        """
        return self._base + (wall - self.wall_base)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        tid: int = 0,
        cat: str = "verifyd",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a completed span [t0, t1] (``time.monotonic()`` seconds)."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name,
            "ph": "X",
            "ts": round((t0 - self._base) * 1e6, 3),
            "dur": round(max(0.0, t1 - t0) * 1e6, 3),
            "pid": self._pid,
            "tid": int(tid),
            "cat": cat,
        }
        if args:
            ev["args"] = args
        dropped = None
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
                dropped = self._dropped
            self._ring.append(ev)
        if dropped is not None and self.drop_hook is not None:
            try:
                self.drop_hook(dropped)
            except Exception:
                pass
        if self.span_hook is not None:
            try:
                self.span_hook(ev)
            except Exception:
                pass

    @contextmanager
    def span(
        self,
        name: str,
        *,
        tid: int = 0,
        cat: str = "verifyd",
        args: Optional[Dict[str, Any]] = None,
    ) -> Iterator[None]:
        """Context manager recording the enclosed block as one span."""
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_span(name, t0, time.monotonic(), tid=tid, cat=cat, args=args)

    def name_track(self, tid: int, name: str) -> None:
        """Label a virtual track (emits one thread_name "M" event per tid)."""
        if not self.enabled:
            return
        with self._lock:
            if tid in self._named:
                return
            if len(self._named) >= _MAX_NAMED_TRACKS:
                self._named.clear()
            self._named.add(tid)
            self._ring.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "ts": 0,
                    "pid": self._pid,
                    "tid": int(tid),
                    "args": {"name": name},
                }
            )

    def merge_child(
        self,
        spans: Sequence[Dict[str, Any]],
        *,
        child_wall_base: float,
        tid: int,
        clamp: Optional[Tuple[float, float]] = None,
        extra_args: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Stitch a child process's span ring onto this tracer's timeline.

        ``child_wall_base`` is the child tracer's ``wall_base`` (shipped
        back in the result JSON) — the clock-offset handshake.  ``clamp``
        is the parent's observed [t0, t1] window for the child in
        ``time.monotonic()`` seconds; rebased spans are pinned inside it
        so clock skew can never produce negative durations or child spans
        outside the escalation that ran them.  Returns how many spans
        were merged.
        """
        if not self.enabled or not spans:
            return 0
        offset_us = (child_wall_base - self.wall_base) * 1e6
        clamp_us = None
        if clamp is not None:
            clamp_us = (self.us(clamp[0]), self.us(clamp[1]))
        merged = rebase_spans(
            spans,
            offset_us=offset_us,
            tid=tid,
            pid=self._pid,
            clamp_us=clamp_us,
            extra_args=extra_args,
        )
        with self._lock:
            for ev in merged:
                if len(self._ring) == self._ring.maxlen:
                    self._dropped += 1
                self._ring.append(ev)
        return len(merged)

    def export(self) -> Dict[str, Any]:
        """Snapshot the ring as a loadable trace_event JSON object."""
        with self._lock:
            events: List[Dict[str, Any]] = list(self._ring)
            dropped = self._dropped
        other: Dict[str, Any] = {
            "producer": "s2-verification-tpu",
            "span_capacity": self.capacity,
            "spans_dropped": dropped,
            "wall_base": round(self.wall_base, 6),
        }
        if dropped:
            other["warning"] = (
                "span ring saturated: %d span(s) dropped; timeline is "
                "truncated — raise --trace-capacity" % dropped
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }


#: Shared disabled tracer: every record path is a cheap no-op.  Components
#: take ``tracer=NULL_TRACER`` defaults so call sites never None-check.
NULL_TRACER = Tracer(0)
