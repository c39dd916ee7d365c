"""Search progress heartbeats: the one hook every engine shares.

The port's own copy of the JAX package's ``checker/progress.py``, held
against it by ``tests/test_torch_progress.py``.  In the port only the
device search (``checker/device.py``) offers updates, one per segment.

A running search is otherwise a black box between ``start`` and ``done``;
the Wing–Gong frontier loop has natural progress structure (ops committed
out of total, frontier width per layer) that the engines can surface for
almost nothing.  :class:`ProgressSink` is the low-overhead carrier: each
engine calls :meth:`ProgressSink.update` wherever the host already holds
fresh counters (per BFS layer on the host search, per compiled segment on
the device search, start/final only around the native engine's blocking C
call) and the sink decides whether a heartbeat actually leaves — emission
is **time-gated**, so a trivial job that decides inside one interval emits
nothing at all, and a hot layer loop costs one clock read per layer.

The sink is engine-agnostic on purpose: ``emit`` receives a plain dict,
so the service layer can fold heartbeats into its per-job table
(service/progress.py), a supervised child can spool them to a file for
its parent (service/supervise.py), and tests can capture them in a list.
"""

from __future__ import annotations

import time

__all__ = ["ProgressSink"]


class ProgressSink:
    """Time-gated progress heartbeat emitter.

    ``emit`` is called with one dict per heartbeat::

        {"ops_committed", "total_ops", "frontier_width",
         "states_expanded", "layer_rate", "engine", "final"[, "layer"]}

    Cadence contract: at most one heartbeat per ``min_interval_s`` of
    wall clock, however often the engine calls :meth:`update`.  The very
    first call only records the rate baseline (never emits), and a
    ``final=True`` heartbeat is emitted only when the search outlived one
    interval — so trivial jobs produce **zero** heartbeats.  ``time_fn``
    is injectable for deterministic tests.
    """

    def __init__(
        self,
        emit,
        *,
        min_interval_s: float = 0.5,
        time_fn=time.monotonic,
        engine: str | None = None,
        lane: int | None = None,
    ) -> None:
        self._emit = emit
        self.min_interval_s = min_interval_s
        self._time = time_fn
        self.engine = engine
        self.lane = lane
        self.emitted = 0
        self._started: float | None = None
        self._last_emit: float | None = None
        #: rate baseline: (time, layer, ops) of the previous emission (or
        #: of the first update when nothing has been emitted yet)
        self._ref: tuple[float, int, int] | None = None

    def update(
        self,
        *,
        ops_committed: int,
        total_ops: int,
        frontier_width: int = 0,
        states_expanded: int = 0,
        layer: int | None = None,
        engine: str | None = None,
        final: bool = False,
    ) -> bool:
        """Offer a progress sample; returns True iff a heartbeat left."""
        now = self._time()
        if self._ref is None:
            self._started = now
            self._ref = (
                now,
                int(layer) if layer is not None else 0,
                int(ops_committed),
            )
            if not final:
                return False
        since = self._last_emit if self._last_emit is not None else self._started
        if now - since < self.min_interval_s:
            # Bounded cadence — and a final offer inside the very first
            # interval stays silent too (the trivial-job rule).
            if not final or self._last_emit is None:
                return False
        ref_t, ref_layer, ref_ops = self._ref
        dt = max(now - ref_t, 1e-9)
        # ``layer`` is cumulative, so a multi-layer jump (a speculative
        # K-layer launch, a multi-op fast stretch) is attributed in full:
        # the rate is the layer DELTA over the interval, never "one
        # heartbeat = one layer".
        if layer is not None:
            rate = (int(layer) - ref_layer) / dt
        else:
            rate = (int(ops_committed) - ref_ops) / dt
        rec = {
            "ops_committed": int(ops_committed),
            "total_ops": int(total_ops),
            "frontier_width": int(frontier_width),
            "states_expanded": int(states_expanded),
            "layer_rate": round(max(rate, 0.0), 3),
            "engine": engine or self.engine or "other",
            "final": bool(final),
        }
        if layer is not None:
            rec["layer"] = int(layer)
        if self.lane is not None:
            rec["lane"] = self.lane
        # A layer-less offer (native engine, service-side folds) carries
        # the previous layer baseline forward — resetting it to 0 would
        # inflate the next layer-bearing update's rate by the whole
        # cumulative layer count.
        self._ref = (
            now,
            int(layer) if layer is not None else ref_layer,
            int(ops_committed),
        )
        self._last_emit = now
        self.emitted += 1
        self._emit(rec)
        return True
