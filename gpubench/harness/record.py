"""What one run records, handed to the metric readers.

A reader (``e2e/<metric>.py`` or ``metrics/<metric>.py``) has one
function, ``read(run: Run) -> float | None``; None means it found nothing
to read, and the harness leaves the metric out of the result.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Request", "Trace", "Run", "DECIDED"]

#: the verdicts that decide a history; anything else is a failed request
DECIDED = ("ok", "illegal")


@dataclass
class Request:
    #: index into the run's pool of histories
    pool_index: int
    #: host clock (``time.perf_counter``): sent, history decoded and
    #: prepared, verdict back
    start: float
    prepared: float
    end: float
    #: ``ok``, ``illegal``, ``unknown``, or ``error``
    outcome: str
    #: operations the prepared history holds (the ops the search checks)
    checked_ops: int
    #: search counters, from ``FrontierStats`` where the run collects them
    layers: int | None = None
    host_syncs: int | None = None
    #: the witness as ``op_id``s, for an OK
    witness: list | None = None
    traced: bool = False
    #: epoch nanoseconds (the profiler's clock) of ``start``, ``prepared``
    #: and ``end``
    spans_ns: tuple = ()

    @property
    def decided(self) -> bool:
        return self.outcome in DECIDED

    @property
    def wall_s(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """What the profiler saw over the traced requests."""

    window_s: float
    busy_s: float
    launches: int
    #: device seconds by operation name
    device_ops: dict
    #: the longest idle gaps, ``(what the host was in, seconds)``
    idle_gaps: list
    #: device seconds of the fold's two kernels, and the least time the
    #: card could take for the same calls (``roofline/fold.py``)
    fold_s: float = 0.0
    fold_bound_s: float = 0.0
    fold_calls: int = 0
    fold_bound_by: str = ""


@dataclass
class Run:
    setup_s: float
    #: from the first request sent to the last verdict back
    window_s: float
    requests: list
    peak_bytes: int
    trace: Trace | None = None
    #: seconds of set-up by part, in order
    setup_parts: dict = field(default_factory=dict)
    #: where the whole window was traced: seconds of device operations in
    #: it, and the kernels among them
    device_s: float | None = None
    device_kernels: int = 0

    def traced_requests(self) -> list:
        return [r for r in self.requests if r.traced]
