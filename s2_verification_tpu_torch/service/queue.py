"""Bounded admission queue with per-client priority and shape-grouped pop.

Admission is **reject, not buffer**: a queue at its configured depth
answers ``put`` with :class:`QueueFull` (carrying a retry-after hint)
instead of growing — unbounded buffering just moves the overload into the
daemon's memory and turns latency into an outage.

Workers drain with :meth:`AdmissionQueue.get_batch`: the best job by
``(priority, arrival)`` plus every other queued job sharing its padded
search shape (up to ``batch_max``).  Grouping by shape runs jobs whose
search tables share one padded shape back to back, so the device
search's allocations and lazily built kernels are reused across
consecutive jobs.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from .overload import CancelToken

__all__ = ["Job", "QueueFull", "AdmissionQueue"]


class QueueFull(RuntimeError):
    """The admission queue is at depth; retry after ``retry_after_s``."""

    def __init__(self, depth: int, retry_after_s: float) -> None:
        super().__init__(
            f"admission queue full ({depth} jobs queued); "
            f"retry after ~{retry_after_s}s"
        )
        self.depth = depth
        self.retry_after_s = retry_after_s


@dataclass
class Job:
    """One admitted verification request."""

    id: int
    client: str
    priority: int  # lower = scheduled sooner
    shape: str  # padded-search-shape key (scheduler.shape_key)
    fingerprint: str  # verdict-cache key (cache.history_fingerprint)
    events: list  # decoded LabeledEvents (for viz / spooling)
    hist: Any  # prepared History (elide_trivial=True)
    no_viz: bool = False
    #: distributed trace id (obs/context.py): client-minted when the
    #: submit frame carried one, daemon-minted otherwise; "" only for
    #: direct Job construction in tests
    trace_id: str = ""
    submitted_at: float = field(default_factory=time.monotonic)
    #: monotonic instant the job entered the admission queue (0.0 =
    #: unknown; queue-wait accounting falls back to ``submitted_at``)
    enqueued_at: float = 0.0
    #: cooperative-cancellation flag (deadline / client_gone / shutdown);
    #: armed with a deadline by the submit path, polled by the scheduler
    #: at layer boundaries and by the supervised-child babysitter
    cancel: CancelToken = field(default_factory=CancelToken)
    #: called exactly once with the reply dict (thread-safe trampoline
    #: into the daemon's event loop)
    resolve: Callable[[dict], None] = lambda _reply: None
    #: live progress heartbeat sink (checker/progress.ProgressSink),
    #: attached by scheduler._prestart; None = heartbeats disabled
    progress_sink: Any = None


class AdmissionQueue:
    def __init__(
        self,
        depth: int,
        retry_hint: Callable[[int], float] | None = None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self._retry_hint = retry_hint or (lambda _depth: 1.0)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._seq = itertools.count()
        #: heap of (priority, seq, Job); seq breaks ties FIFO
        self._heap: list[tuple[int, int, Job]] = []
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def put(self, job: Job) -> int:
        """Admit ``job`` or raise :class:`QueueFull`; returns queue depth
        after admission."""
        with self._nonempty:
            if self._closed:
                raise RuntimeError("queue is closed")
            if len(self._heap) >= self.depth:
                raise QueueFull(len(self._heap), self._retry_hint(len(self._heap)))
            heapq.heappush(self._heap, (job.priority, next(self._seq), job))
            self._nonempty.notify()
            return len(self._heap)

    def get_batch(self, batch_max: int = 16, timeout: float | None = None) -> list[Job]:
        """Block for the next shape group: the best queued job plus every
        other job with the same shape, priority order, up to ``batch_max``.
        Returns ``[]`` on timeout or when the queue is closed and drained.
        """
        with self._nonempty:
            if not self._heap and not self._closed:
                self._nonempty.wait(timeout=timeout)
            if not self._heap:
                return []
            _, _, head = heapq.heappop(self._heap)
            batch = [head]
            if batch_max > 1 and self._heap:
                rest: list[tuple[int, int, Job]] = []
                # Heap order is (priority, arrival); scanning ascending
                # keeps the group itself priority-ordered.
                for entry in sorted(self._heap):
                    if len(batch) < batch_max and entry[2].shape == head.shape:
                        batch.append(entry[2])
                    else:
                        rest.append(entry)
                heapq.heapify(rest)
                self._heap = rest
            return batch

    def drain_shape(self, shape: str, batch_max: int = 16) -> list[Job]:
        """Pop up to ``batch_max`` queued jobs of ``shape``, priority
        order, without blocking — the late-join drain: a worker that just
        finished a mega-launch offers the next launch to jobs of the same
        shape that arrived while it was in flight.  Returns ``[]`` when
        none are queued."""
        with self._lock:
            if not self._heap:
                return []
            batch: list[Job] = []
            rest: list[tuple[int, int, Job]] = []
            for entry in sorted(self._heap):
                if len(batch) < batch_max and entry[2].shape == shape:
                    batch.append(entry[2])
                else:
                    rest.append(entry)
            if batch:
                heapq.heapify(rest)
                self._heap = rest
            return batch

    def close(self) -> None:
        """Stop admissions and wake blocked workers (they drain what's
        left, then see ``[]``)."""
        with self._nonempty:
            self._closed = True
            self._nonempty.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
