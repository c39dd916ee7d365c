"""Deterministic virtual time for the collector.

A frozen copy of the port's ``collector/clock.py``, kept for the
benchmark's generators.

The reference achieves replayable histories by running under turmoil /
Antithesis deterministic simulation (README.md:5; AntithesisRng at
history.rs:58,140).  This module gives the in-process collector the same
property without external tooling: client tasks only ever yield at sleep
points, so replacing real ``asyncio.sleep`` with a virtual clock that wakes
exactly one sleeper at a time — ordered by (deadline, registration order) —
makes the whole interleaving a pure function of the seeds, independent of
wall-clock scheduling and machine load.

Protocol: register every client task before it starts; ``sleep`` parks the
caller on a heap and, once every registered task is parked (no one left
runnable), pops the earliest wake-up and resumes just that task.  Ties
break on registration sequence, so equal deadlines are still deterministic.
"""

from __future__ import annotations

import asyncio
import heapq

__all__ = ["VirtualClock", "vsleep"]


async def vsleep(clock: "VirtualClock | None", dt: float) -> None:
    """Sleep on the virtual clock when one is attached, else in real time.

    The single chokepoint for every collector-side sleep: any new sleep site
    must route through here, or it silently bypasses the virtual clock and
    breaks byte-deterministic replay.
    """
    if clock is not None:
        await clock.sleep(dt)
    else:
        await asyncio.sleep(dt)


class VirtualClock:
    def __init__(self) -> None:
        self.now = 0.0
        self._heap: list[tuple[float, int, asyncio.Future]] = []
        self._seq = 0
        self._active = 0

    def register(self) -> None:
        """Count a task as runnable; call before the task first runs."""
        self._active += 1

    def unregister(self) -> None:
        """A task finished; if everyone else is asleep, time may advance."""
        self._active -= 1
        self._maybe_advance()

    async def sleep(self, dt: float) -> None:
        fut = asyncio.get_running_loop().create_future()
        heapq.heappush(self._heap, (self.now + dt, self._seq, fut))
        self._seq += 1
        self._active -= 1
        self._maybe_advance()
        try:
            await fut
        finally:
            self._active += 1

    def _maybe_advance(self) -> None:
        while self._active == 0 and self._heap:
            deadline, _, fut = heapq.heappop(self._heap)
            self.now = max(self.now, deadline)
            # A parked sleeper may have been cancelled by task teardown
            # (e.g. a sibling client raised); setting its result would raise
            # InvalidStateError and mask the original error — skip it and
            # wake the next sleeper instead.
            if not fut.done():
                fut.set_result(None)
                return
