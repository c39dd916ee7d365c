"""Continuous cross-job batching: the scheduler's mega-launch lane manager.

A worker that picks a shape group hands it here instead of running the
jobs one by one.  Launch composition:

- **Drain-on-launch.**  The group (every queued job of the picked shape,
  up to ``batch_max`` — ``AdmissionQueue.get_batch``) becomes one launch.
  Each lane still gets the full per-job prestart (queue-cancel boundary,
  execute-time verdict-cache recheck, journal ``started``, ``start``
  event), so a lane that was answered in the queue never launches.
- **Late-join.**  After a launch completes, jobs of the same shape that
  arrived while it was in flight are drained
  (``AdmissionQueue.drain_shape``) into an immediate follow-up launch —
  they join at the next launch boundary, never mid-flight.  Follow-up
  rounds are bounded (``LATE_JOIN_ROUNDS``) so a hot shape cannot starve
  the rest of the queue; past the bound the worker goes back through the
  normal priority pick, which favors the hot shape anyway if it is still
  the best work.
- **Early-exit lanes.**  Under the native engine a lane's verdict
  resolves (reply, ``done`` event, cache put) the moment its lane
  decides, while later lanes are still searching.  Under the vmap engine
  the whole launch is one compiled search whose per-lane carries latch on
  decision (``checker/batched.py``); verdicts resolve at launch end with
  per-lane layer counts recording who decided early.
- **Per-lane attribution.**  Every job emits its own ``done`` event with
  ``wall_s`` = its own pick→decide span — not the mega-launch wall — so
  the per-shape EWMA sentinel and the profile archive see honest per-job
  numbers whatever the batch size was.
- **Per-lane deadline/cancel.**  Each lane's CancelToken is consulted at
  the launch boundary and again immediately before the lane dispatches
  (native) — the same boundaries the sequential path polls.

A lane the batch engine cannot decide (vmap prune dead-end, native
UNKNOWN under budget, viz-requesting jobs under vmap) falls back to the
sequential portfolio — batching is a fast path, never a verdict change.

The port's copy of the JAX package's ``service/batcher.py``.  The vmap
engine is the port's one lane-batched search
(``checker/batched.py::check_batch_vmap`` over
``device.run_search_lanes``, which launches the fold kernel), run in the
daemon's own process on the scheduler's ``torch_device`` (``None`` = the
card; the daemon resolves it when it is built).  A launch whose kernel
fails to build or launch answers each of its lanes with that error; it
is never re-run on another device.  The native engine loads no torch.
"""

from __future__ import annotations

import logging
import time

from ..checker.batched import (
    BatchLane,
    check_batch_native,
    check_batch_vmap,
    default_engine,
)
from ..checker.oracle import CheckOutcome
from ..models.encode import encode_batch
from ..obs.introspect import job_context
from .protocol import err
from .queue import Job

__all__ = ["Batcher", "LATE_JOIN_ROUNDS"]

log = logging.getLogger("s2_verification_tpu_torch.verifyd")

#: Bounded follow-up drains per worker pick (fairness vs. the rest of
#: the queue); the normal priority pick takes over past this.
LATE_JOIN_ROUNDS = 4


class Batcher:
    """Runs shape groups as batched launches against a Scheduler.

    Holds no state of its own beyond the engine choice; all policy
    objects (queue, cache, stats, journal, cancel semantics) are the
    scheduler's, reached through the extracted ``_prestart`` /
    ``_portfolio`` / ``_finish`` hooks so batched and sequential jobs
    share one code path for everything but the search dispatch.
    """

    def __init__(self, sched, engine: str = "auto") -> None:
        self.sched = sched
        self.engine = engine

    def _resolved_engine(self) -> str:
        return default_engine() if self.engine == "auto" else self.engine

    # -- group loop ---------------------------------------------------------

    def run_group(self, batch: list[Job]) -> None:
        """One picked shape group plus bounded late-join follow-ups."""
        shape = batch[0].shape
        group = batch
        for round_no in range(1 + LATE_JOIN_ROUNDS):
            try:
                self._launch(group, late_joiners=round_no > 0)
            except Exception as e:
                # The launch machinery itself failed (not one job):
                # answer every job sequentially rather than dropping any.
                log.exception("mega-launch failed; running lanes sequentially")
                del e
                for job in group:
                    self._sequential(job)
            if self.sched._stopping:
                return
            group = self.sched.queue.drain_shape(shape, self.sched.batch_max)
            if not group:
                return

    # -- helpers ------------------------------------------------------------

    def _resolve_error(self, job: Job, e: Exception) -> None:
        reply = err("InternalError", repr(e), job=job.id)
        self.sched._mark_done(job, verdict=None, outcome="error")
        self.sched.stats.emit(
            "job_error", job=job.id, reason=repr(e)[:200], trace_id=job.trace_id
        )
        job.resolve(reply)

    def _sequential(self, job: Job) -> None:
        """Full sequential path for one job (launch-level fallback)."""
        try:
            reply = self.sched._run_job(job)
        except Exception as e:
            self._resolve_error(job, e)
            return
        job.resolve(reply)

    def _fallback(self, job: Job, queue_wait: float, warm: bool) -> None:
        """Portfolio continuation for a lane the batch engine could not
        decide (prestart already ran — don't repeat it)."""
        try:
            t0 = time.monotonic()
            with job_context(
                job=job.id,
                shape=job.shape,
                trace_id=job.trace_id,
                tracer=self.sched.tracer,
            ):
                res, backend = self.sched._portfolio(job)
            wall = time.monotonic() - t0
            reply = self.sched._finish(
                job, res, backend, queue_wait=queue_wait, warm=warm, wall=wall
            )
        except Exception as e:
            self._resolve_error(job, e)
            return
        job.resolve(reply)

    def _lane_budget(self, job: Job) -> float | None:
        """The sequential CPU stage's budget clamp, per lane."""
        budget = self.sched.time_budget_s
        remaining = job.cancel.remaining()
        if budget is not None and budget <= 0:
            return remaining  # unbounded close, capped by any deadline
        budget = budget if budget is not None else 10.0
        if remaining is not None:
            budget = max(0.05, min(budget, remaining))
        return budget

    # -- one launch ---------------------------------------------------------

    def _launch(self, group: list[Job], *, late_joiners: bool) -> None:
        sched = self.sched
        engine = self._resolved_engine()
        t_pick = time.monotonic()
        shape = group[0].shape

        live: list[tuple[Job, float, bool]] = []
        for job in group:
            try:
                reply, queue_wait, warm = sched._prestart(job, t_pick)
            except Exception as e:
                self._resolve_error(job, e)
                continue
            if reply is not None:
                job.resolve(reply)
                continue
            if engine == "vmap" and not job.no_viz:
                # The vmapped kernel recovers no witness; viz jobs take
                # the sequential path where artifacts are first-class.
                self._fallback(job, queue_wait, warm)
                continue
            live.append((job, queue_wait, warm))
        if not live:
            return

        try:
            encs = encode_batch([job.hist for job, _, _ in live])
        except Exception:
            log.exception("batched encode failed; running lanes sequentially")
            for job, queue_wait, warm in live:
                self._fallback(job, queue_wait, warm)
            return

        lanes = [
            BatchLane(job.hist, enc, self._lane_budget(job))
            for (job, _, _), enc in zip(live, encs)
        ]

        def skip(i: int) -> str | None:
            job = live[i][0]
            if sched._stopping:
                job.cancel.cancel("shutdown")
            return job.cancel.check()

        decided = 0
        fallbacks: list[tuple[Job, float, bool]] = []
        decide_t: list[float | None] = [None] * len(live)

        def settle(i: int, verdict) -> None:
            """Resolve lane i from its LaneVerdict (or queue a fallback)."""
            nonlocal decided
            job, queue_wait, warm = live[i]
            if verdict.skipped is not None:
                try:
                    reply = sched._cancel_reply(
                        job, verdict.skipped, queue_wait, started=True
                    )
                except Exception as e:
                    self._resolve_error(job, e)
                    return
                job.resolve(reply)
                return
            res = verdict.result
            if res is None or res.outcome == CheckOutcome.UNKNOWN:
                fallbacks.append((job, queue_wait, warm))
                return
            now = time.monotonic()
            decide_t[i] = now
            decided += 1
            try:
                reply = sched._finish(
                    job,
                    res,
                    verdict.engine,
                    queue_wait=queue_wait,
                    warm=warm,
                    # This lane's own pick→decide span: encode share plus
                    # however long the launch took to reach ITS verdict.
                    wall=now - t_pick,
                )
            except Exception as e:
                self._resolve_error(job, e)
                return
            job.resolve(reply)

        t0 = time.monotonic()
        with job_context(
            job=live[0][0].id,
            shape=shape,
            trace_id=live[0][0].trace_id,
            tracer=sched.tracer,
        ):
            # Per-lane progress sinks (prestart attached them): each lane
            # heartbeats to its own job row, so a mega-launch stays
            # attributable job by job on the watch surface.
            sinks = [job.progress_sink for job, _, _ in live]
            if engine == "native":
                # Lanes resolve one by one as they decide — a decided
                # lane's client is answered while later lanes still run.
                verdicts = check_batch_native(
                    lanes,
                    skip=skip,
                    profile=sched.profile,
                    on_lane=settle,
                    progress=sinks,
                )
            else:
                try:
                    verdicts = check_batch_vmap(
                        lanes, skip=skip, progress=sinks, device=sched.torch_device
                    )
                except Exception as e:
                    # The kernel did not build or launch: every live lane
                    # is answered with the error, never searched again on
                    # another device in the card's place.
                    log.exception("vmap launch failed; answering its lanes with the error")
                    for job, _, _ in live:
                        self._resolve_error(job, e)
                    return
                for i, v in enumerate(verdicts):
                    settle(i, v)
        t_end = time.monotonic()
        sched.tracer.add_span(
            f"batch[{engine}]",
            t0,
            t_end,
            tid=live[0][0].id,
            args={"shape": shape, "lanes": len(live)},
        )

        # Early exit = decided while at least one other lane was still
        # searching: every decided lane but the last-to-decide (native
        # resolves in lane order; vmap lanes below the launch's deepest
        # layer count latched early).
        if engine == "vmap":
            layer_counts = [v.layers for v in verdicts if v.layers >= 0]
            deepest = max(layer_counts, default=0)
            early = sum(
                1
                for v in verdicts
                if v.result is not None and 0 <= v.layers < deepest
            )
        else:
            early = max(0, decided - 1) if len(live) > 1 else 0

        sched.stats.emit(
            "batch_launch",
            engine=f"batch-{engine}",
            shape=shape,
            lanes=len(live),
            decided=decided,
            early_exits=early,
            occupancy=round(len(live) / max(1, sched.batch_max), 4),
            late_join=late_joiners,
            wall_s=round(t_end - t0, 4),
        )

        for job, queue_wait, warm in fallbacks:
            self._fallback(job, queue_wait, warm)
