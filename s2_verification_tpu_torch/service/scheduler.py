"""Shape-grouped scheduler: the daemon's worker pool and per-job policy.

The port's copy of the JAX package's ``service/scheduler.py``.  Workers
drain the admission queue in **shape groups** — jobs whose prepared
histories pad to the same search shape (the encoder's bucketing rule,
``models/encode.py``) run back to back, so the device search's tables and
lazily built kernels are reused across requests.

Per-job policy is the one-shot ``auto`` portfolio (cli.py): the CPU
engine (native when buildable, oracle otherwise) under a time budget,
escalating to the device search when the budget expires.  Device
escalation runs under supervision (:mod:`.supervise`) by default — a
wedged or crashed CUDA job degrades to the CPU answer for *that job*
instead of taking the daemon down; ``device="inline"`` runs
``check_device_auto`` in this process and keeps one CUDA context warm
across jobs.  Unlike the one-shot CLI, an inconclusive budgeted job is
answered UNKNOWN rather than held open unbounded unless
``unbounded_close`` is configured: a shared daemon bounds every job, and
the client can always rerun one-shot with ``-time-budget 0``.

``torch_device`` names the device of both escalations (``None`` = the
card; ``"cpu"`` runs the device search on the CPU).  Nothing here
imports ``torch`` until an inline escalation or a vmap launch group runs:
a supervised or device-off daemon never holds a card.

With ``batching`` a worker hands each picked shape group of two or more
jobs to the batcher (``service/batcher.py``), which runs it as one launch
of ``batch_engine`` (``native``, or ``vmap``: one lane-batched search on
``torch_device``).  With a ``prefix_store`` (``serve --prefix``) a job
carrying a :class:`~.prefixstore.PrefixPlan` runs the resumable host
frontier search from the plan's carry and writes its snapshot cuts to the
store; a follow window's verdict is window-scoped (never cached, never
journaled, never escalated).

With a ``journal`` (``serve --state-dir``) every job leaves the JAX
scheduler's records: ``run`` before its search, ``done`` after its
verdict (or its error, cancel or cache answer); with a ``quarantine``
ledger a conclusive verdict forgives the fingerprint's crashes and a
supervised child that died with no cancel of ours to blame counts one.
"""

from __future__ import annotations

import inspect
import logging
import os
import tempfile
import threading
import time

from ..checker.entries import History, prepare
from ..checker.oracle import CheckOutcome, CheckResult, check
from ..checker.profile import job_profile
from ..models.encode import _bucket_chains, _bucket_len, round_pow2
from ..models.stream import APPEND
from ..obs.introspect import INTROSPECTOR, job_context
from ..obs.trace import NULL_TRACER, Tracer
from .protocol import ERR_CANCELLED, ERR_DEADLINE, VERDICT_EXIT, err, ok
from .queue import AdmissionQueue, Job
from .stats import ServiceStats

__all__ = ["shape_key", "job_profile", "Scheduler"]

log = logging.getLogger("s2_verification_tpu_torch.verifyd")


def shape_key(hist: History) -> str:
    """Padded-search-shape key of a prepared history: ops × chains ×
    record-batch width, each through the encoder's bucketing rule — two
    histories with equal keys reach search tables of the same shape."""
    width = max(
        (len(op.inp.record_hashes) for op in hist.ops if op.inp.input_type == APPEND),
        default=1,
    )
    return (
        f"{round_pow2(max(1, len(hist.ops)))}x"
        f"{_bucket_chains(len(hist.chains))}x{_bucket_len(max(1, width))}"
    )


def _cpu_check(
    hist: History,
    budget: float | None,
    profile: bool = False,
    progress=None,
    prune: bool = False,
) -> tuple[CheckResult, str]:
    """Native engine when buildable, Python oracle otherwise (cli.py).
    ``prune`` hands the native DFS its verdict-exact precedence tables;
    the oracle fallback ignores it (exhaustive by construction)."""
    from ..checker.native import NativeUnavailable, check_native

    try:
        return (
            check_native(
                hist,
                time_budget_s=budget,
                profile=profile,
                progress=progress,
                prune=prune,
            ),
            "native",
        )
    except NativeUnavailable as e:
        log.debug("native checker unavailable (%s); using the Python oracle", e)
        return check(hist, time_budget_s=budget), "oracle"


_accepts_cache: dict[str, tuple] = {}


def _accepts_kwarg(fn, name: str) -> bool:
    """Whether ``fn`` takes a ``name`` kwarg.  Test doubles replace
    :func:`_cpu_check` with plain ``(hist, budget)`` callables; optional
    kwargs are only threaded through when the live function can carry
    them.  The answer is cached per (kwarg, function identity): this runs
    on every job, and ``inspect.signature`` is tens of microseconds."""
    cached = _accepts_cache.get(name)
    if cached is not None and cached[0] is fn:
        return cached[1]
    try:
        ok = name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        ok = False
    _accepts_cache[name] = (fn, ok)
    return ok


def _lease_devices(torch_device: str | None, indices) -> list:
    """The mesh shards of a pool lease for an inline escalation: slot
    ``i`` is ``cuda:i`` on the card, as the supervised child resolves its
    grant; on the CPU every slot is a ``"cpu"`` shard."""
    import torch

    from ..checker.device import resolve_device

    dev = resolve_device(torch_device)
    if dev.type != "cuda":
        return [dev] * len(indices)
    visible = torch.cuda.device_count()
    missing = [i for i in indices if i >= visible]
    if missing:
        raise RuntimeError(
            f"device grant {list(indices)} exceeds the {visible} visible cards"
        )
    return [torch.device("cuda", i) for i in indices]


class Scheduler:
    def __init__(
        self,
        queue: AdmissionQueue,
        cache,
        stats: ServiceStats,
        *,
        time_budget_s: float | None = 10.0,
        device: str = "supervised",  # supervised | inline | off
        unbounded_close: bool = False,
        batch_max: int = 16,
        out_dir: str = "./porcupine-outputs",
        spool_dir: str | None = None,
        device_rows: int | None = None,
        attempt_timeout_s: float = 900.0,
        max_restarts: int = 2,
        journal=None,
        tracer: Tracer = NULL_TRACER,
        profile: bool = False,
        device_pool=None,
        lease_timeout_s: float = 120.0,
        journal_writer=None,
        quarantine=None,
        cancel_grace_s: float = 2.0,
        batching: bool = False,
        batch_engine: str = "auto",
        prefix_store=None,
        progress=None,
        prune: bool = False,
        speculate_depth: int = 0,
        torch_device: str | None = None,
    ) -> None:
        if device not in ("supervised", "inline", "off"):
            raise ValueError(f"unknown device escalation mode {device!r}")
        if batch_engine not in ("auto", "native", "vmap"):
            raise ValueError(f"unknown batch engine {batch_engine!r}")
        self.queue = queue
        self.cache = cache
        self.stats = stats
        self.time_budget_s = time_budget_s
        self.device = device
        self.unbounded_close = unbounded_close
        self.batch_max = batch_max
        self.out_dir = out_dir
        self.spool_dir = spool_dir or os.path.join(
            tempfile.gettempdir(), f"verifyd-spool-{os.getpid()}"
        )
        self.device_rows = device_rows
        self.attempt_timeout_s = attempt_timeout_s
        self.max_restarts = max_restarts
        self.journal = journal
        self.tracer = tracer
        self.profile = profile
        #: device-lease allocator (service/devicepool.py); None = the
        #: single-card escalation path
        self.device_pool = device_pool
        #: how long an escalation waits for a lease under contention
        #: before falling back to the unsharded path
        self.lease_timeout_s = lease_timeout_s
        #: DegradedWriter guarding journal appends (None = raw journal);
        #: lets an ENOSPC'd disk degrade durability instead of erroring
        self.journal_writer = journal_writer
        #: poison-job ledger (overload.QuarantineStore); child kills feed
        #: it live, conclusive verdicts forgive accumulated crashes
        self.quarantine = quarantine
        #: SIGTERM→SIGKILL grace for cancelled supervised children
        self.cancel_grace_s = cancel_grace_s
        #: continuous cross-job batching: shape groups of >= 2 jobs run
        #: as one mega-launch (service/batcher.py) instead of job by job
        self.batching = batching
        self.batch_engine = batch_engine
        #: prefix store (service/prefixstore.PrefixStore); jobs carrying a
        #: PrefixPlan run the resumable host-frontier path and write their
        #: snapshot cuts here on OK
        self.prefix_store = prefix_store
        #: per-job progress table (service/progress.JobProgress); None
        #: disables heartbeats — every job then runs exactly as before
        self.progress = progress
        #: verdict-exact search pruning (checker/prune.py).  Never
        #: changes a verdict.
        self.prune = prune
        #: speculative multi-layer expansion depth for device escalations
        #: (0 = off); internally disabled for witness-carrying runs
        self.speculate_depth = speculate_depth
        #: the torch device of inline and supervised escalations (None =
        #: the card)
        self.torch_device = torch_device
        #: fold launches the supervised children reported, summed (the
        #: daemon cannot count a child's launches itself)
        self.child_launches: dict[str, int] = {}
        self._launch_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._stopping = False
        self._batcher = None
        if batching:
            from .batcher import Batcher

            self._batcher = Batcher(self, engine=batch_engine)

    # -- lifecycle ----------------------------------------------------------

    def start(self, workers: int) -> None:
        for i in range(workers):
            t = threading.Thread(
                target=self._worker, name=f"verifyd-w{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self, timeout: float = 30.0) -> None:
        self._stopping = True
        self.queue.close()
        for t in self._threads:
            t.join(timeout=timeout)

    # -- worker loop --------------------------------------------------------

    def _worker(self) -> None:
        while True:
            batch = self.queue.get_batch(self.batch_max, timeout=0.5)
            if not batch:
                if self.queue.closed:
                    return
                continue
            self.stats.set_queue_depth(len(self.queue))
            if self._batcher is not None and len(batch) > 1:
                # Prefix-planned jobs peel off before a mega-launch: the
                # batched engines search cold from op 0, which is wrong
                # for window-scoped follow jobs (their carry IS the
                # prefix) and wastes the resume for extensions.
                grouped = [j for j in batch if j.prefix is None]
                batch = [j for j in batch if j.prefix is not None]
                if len(grouped) > 1:
                    # Mega-launch: the whole shape group (plus
                    # late-joiners); the batcher resolves every job.
                    self._batcher.run_group(grouped)
                else:
                    batch = grouped + batch
                if not batch:
                    continue
            for job in batch:
                try:
                    reply = self._run_job(job)
                except Exception as e:  # one bad job must not kill the worker
                    log.exception("job %d failed", job.id)
                    reply = err("InternalError", repr(e), job=job.id)
                    # Close the journal record even on failure: a poison
                    # job must not re-run on every restart forever.
                    self._mark_done(job, verdict=None, outcome="error")
                    if self.progress is not None:
                        self.progress.finish(job.id, outcome="error")
                    # Balance the `start` event so in-flight accounting
                    # (active-jobs gauge, retry-after hint) can't leak.
                    self.stats.emit(
                        "job_error",
                        job=job.id,
                        reason=repr(e)[:200],
                        trace_id=job.trace_id,
                    )
                job.resolve(reply)

    def _journal_append(self, job: Job, fn) -> None:
        """Route a journal append through the DegradedWriter when one is
        armed (disk-full degrades durability instead of raising)."""
        if self.journal_writer is not None:
            self.journal_writer.run(fn)
            return
        try:
            fn()
        except (OSError, ValueError):
            log.exception("job %d: journal append failed", job.id)

    @staticmethod
    def _is_window(job: Job) -> bool:
        """Follow-window jobs: verdicts are window-scoped (computed from a
        carried frontier, not op 0), so they must never enter the verdict
        cache or the journal — a replay or a fingerprint twin would serve
        a rolling verdict as if it were a cold full-history one.
        Distributed-search partition jobs (``kind == "partition"``) carry
        the same hazard: their verdict covers one partition of one
        segment, never the whole history."""
        return job.prefix is not None and job.prefix.kind in (
            "window",
            "partition",
        )

    def _mark_done(self, job: Job, *, verdict: int | None, outcome: str) -> None:
        if self.journal is None or self._is_window(job):
            return
        self._journal_append(
            job,
            lambda: self.journal.done(
                job=job.id,
                fingerprint=job.fingerprint,
                verdict=verdict,
                outcome=outcome,
            ),
        )

    def _cancel_reply(
        self, job: Job, reason: str, queue_wait: float, *, started: bool
    ) -> dict:
        """Answer a cancelled job: close its journal record (the client
        got — or abandoned — its reply; nothing is owed a replay), count
        it, and return the definite error."""
        if self.progress is not None:
            self.progress.finish(job.id, outcome="cancelled")
        self.stats.emit(
            "job_cancelled",
            job=job.id,
            client=job.client,
            reason=reason,
            started=started,
            queue_wait_s=round(queue_wait, 4),
            trace_id=job.trace_id,
        )
        self._mark_done(job, verdict=None, outcome="cancelled")
        cls = ERR_DEADLINE if reason == "deadline" else ERR_CANCELLED
        return err(
            cls,
            f"job {job.id} cancelled ({reason})",
            job=job.id,
            reason=reason,
        )

    def _prestart(
        self, job: Job, t_pick: float
    ) -> tuple[dict | None, float, bool]:
        """Everything between picking a job and starting its search.

        Returns ``(reply, queue_wait, warm)``; a non-None ``reply`` means
        the job was answered here (cancelled in the queue, or a verdict-
        cache twin landed while it waited) and must not run.  Shared by
        the sequential path and the batcher's per-lane prestart.
        """
        queue_wait = t_pick - (job.enqueued_at or job.submitted_at)
        # Cancellation boundary #1: a job whose deadline passed in the
        # queue (or whose client hung up / whose daemon is stopping)
        # never starts — the worker moves straight to live work.
        if self._stopping:
            job.cancel.cancel("shutdown")
        reason = job.cancel.check()
        if reason is not None:
            return (
                self._cancel_reply(job, reason, queue_wait, started=False),
                queue_wait,
                False,
            )
        # Duplicate admitted while its twin was still in flight: answer
        # from the verdict cache at execution time too.
        cached = self.cache.get(job.fingerprint)
        if cached is not None:
            cached.update(
                cached=True,
                job=job.id,
                queue_wait_s=round(queue_wait, 4),
                trace_id=job.trace_id,
            )
            self.stats.emit(
                "cache_hit",
                stage="execute",
                job=job.id,
                client=job.client,
                queue_wait_s=round(queue_wait, 4),
                trace_id=job.trace_id,
            )
            self._mark_done(
                job,
                verdict=cached.get("verdict"),
                outcome=str(cached.get("outcome", "cached")),
            )
            return ok(cached), queue_wait, False

        # Run record before the search: it is what lets boot-time orphan
        # recovery distinguish a poison job (started, then the process
        # died) from one that innocently sat in the queue.
        if self.journal is not None and not self._is_window(job):
            self._journal_append(
                job,
                lambda: self.journal.started(
                    job=job.id, fingerprint=job.fingerprint
                ),
            )
        warm = self.stats.note_shape(job.shape)
        self.stats.emit(
            "start",
            job=job.id,
            client=job.client,
            shape=job.shape,
            shape_warm=warm,
            queue_wait_s=round(queue_wait, 4),
            trace_id=job.trace_id,
        )
        if job.enqueued_at:
            self.tracer.add_span(
                "queue_wait",
                job.enqueued_at,
                t_pick,
                tid=job.id,
                args={"trace_id": job.trace_id},
            )
        if self.progress is not None:
            job.progress_sink = self.progress.sink_for(
                job.id,
                fingerprint=job.fingerprint,
                shape=job.shape,
                trace_id=job.trace_id,
            )
        return None, queue_wait, warm

    def _run_job(self, job: Job) -> dict:
        t_pick = time.monotonic()
        reply, queue_wait, warm = self._prestart(job, t_pick)
        if reply is not None:
            return reply
        t0 = time.monotonic()
        # Job context for the build tracker: a kernel library the
        # portfolio builds (inline device escalation included) is
        # attributed to this job's shape bucket and trace.
        with job_context(
            job=job.id,
            shape=job.shape,
            trace_id=job.trace_id,
            tracer=self.tracer,
        ):
            res, backend = self._portfolio(job)
        wall = time.monotonic() - t0
        self.tracer.add_span(
            "search",
            t0,
            t0 + wall,
            tid=job.id,
            args={
                "backend": backend,
                "outcome": res.outcome.value,
                "trace_id": job.trace_id,
            },
        )
        return self._finish(
            job, res, backend, queue_wait=queue_wait, warm=warm, wall=wall
        )

    def _finish(
        self,
        job: Job,
        res: CheckResult,
        backend: str,
        *,
        queue_wait: float,
        warm: bool,
        wall: float,
    ) -> dict:
        """Turn a search result into the job's reply: cancel boundary #2,
        artifact, verdict-cache put, ``done`` event.  ``wall`` is this
        job's own search span — for batched lanes, its queue-pick→decide
        time, not the mega-launch wall."""
        # Cancellation boundary #2: a search abandoned mid-flight comes
        # back UNKNOWN — answer the cancellation, not a fake verdict.  A
        # conclusive result that beat the cancel is still worth more to
        # the client than the error, so it wins.
        reason = job.cancel.check()
        if reason is not None and res.outcome == CheckOutcome.UNKNOWN:
            return self._cancel_reply(job, reason, queue_wait, started=True)
        if self.progress is not None:
            self.progress.finish(job.id, outcome=res.outcome.value)
        if self.quarantine is not None and res.outcome != CheckOutcome.UNKNOWN:
            # A conclusive verdict forgives accumulated crash counts.
            self.quarantine.note_success(job.fingerprint)

        artifact = None
        if not job.no_viz:
            try:
                with self.tracer.span("render", tid=job.id):
                    artifact = self._write_artifact(job, res)
            except Exception:
                log.exception("job %d: artifact write failed", job.id)

        payload = {
            "verdict": VERDICT_EXIT[res.outcome.value],
            "outcome": res.outcome.value,
            "backend": backend,
            "wall_s": round(wall, 4),
            "ops": len(job.hist.ops),
            "shape": job.shape,
            "shape_warm": warm,
            "artifact": artifact,
            "cached": False,
            "trace_id": job.trace_id,
        }
        profile = job_profile(res) if self.profile else None
        if profile is not None:
            payload["profile"] = profile
        if self._is_window(job):
            # A follow window's verdict only covers the suffix relative to
            # its carry; its "fingerprint" is the cut key (pv2:...), and
            # the payload is marked so edges scope it too.  Partition jobs
            # are scoped likewise (their end-of-segment union goes back to
            # the coordinator with the fleet tier, ROADMAP.md queue 1
            # item 6).
            kind = job.prefix.kind
            payload["scope"] = "partition" if kind == "partition" else "window"
        # Inconclusive verdicts are not cached: a resubmission may get a
        # healthier device or a bigger budget and deserves a fresh run.
        # Window verdicts are never cached at all (see _is_window).
        if res.outcome != CheckOutcome.UNKNOWN and not self._is_window(job):
            self.cache.put(job.fingerprint, payload)
        # Done-mark after the cache put: a crash in between re-runs the
        # job (at-least-once), and the rerun answers from the cache.
        self._mark_done(
            job, verdict=payload["verdict"], outcome=res.outcome.value
        )
        done_fields = dict(
            job=job.id,
            client=job.client,
            backend=backend,
            verdict=payload["verdict"],
            wall_s=payload["wall_s"],
            queue_wait_s=round(queue_wait, 4),
            shape=job.shape,
            shape_warm=warm,
            trace_id=job.trace_id,
            fingerprint=job.fingerprint,
            ops=len(job.hist.ops),
        )
        if profile is not None:
            done_fields["profile"] = profile
        # Per-shard summary rides the done event even without --profile:
        # the mesh metric families update on every sharded escalation.
        shards = getattr(getattr(res, "stats", None), "shards", None)
        if shards:
            done_fields["shards"] = shards
        self.stats.emit("done", **done_fields)
        st = getattr(res, "stats", None)
        if st is not None:
            commits = int(getattr(st, "prune_commits", 0) or 0)
            dead = int(getattr(st, "prune_dead", 0) or 0)
            ranked = int(getattr(st, "prune_ranked", 0) or 0)
            if commits or dead or ranked:
                self.stats.emit(
                    "prune_applied",
                    job=job.id,
                    backend=backend,
                    commits=commits,
                    dead=dead,
                    ranked=ranked,
                    trace_id=job.trace_id,
                )
            rollbacks = int(getattr(st, "spec_rollbacks", 0) or 0)
            if rollbacks:
                self.stats.emit(
                    "speculation_rollback",
                    job=job.id,
                    backend=backend,
                    rollbacks=rollbacks,
                    layers=int(getattr(st, "spec_layers", 0) or 0),
                    launches=int(getattr(st, "spec_launches", 0) or 0),
                    accepts=int(getattr(st, "spec_accepts", 0) or 0),
                    trace_id=job.trace_id,
                )
        out = dict(payload)
        out.update(job=job.id, queue_wait_s=round(queue_wait, 4))
        return ok(out)

    # -- per-job policy -----------------------------------------------------

    def _portfolio(self, job: Job) -> tuple[CheckResult, str]:
        budget = self.time_budget_s
        # A job deadline bounds every stage: no layer may out-sleep what
        # the client is still willing to wait for.
        remaining = job.cancel.remaining()
        if budget is not None and budget <= 0:
            # Budget 0 = run to completion on CPU (the reference's
            # unbounded default), mirroring cli._run_backend — unless a
            # deadline caps it.
            res, engine = self._traced_cpu(job, remaining)
            return res, f"{engine}-unbounded"
        budget = budget if budget is not None else 10.0
        if remaining is not None:
            budget = max(0.05, min(budget, remaining))
        res, engine = self._traced_cpu(job, budget)
        if res.outcome != CheckOutcome.UNKNOWN:
            return res, engine
        if job.cancel.check() is not None:
            # Cancelled during the CPU stage: skip device escalation.
            return res, engine
        if self.device != "off" and not self._is_window(job):
            # (Window jobs never escalate: the device engines search cold
            # from op 0, and a window without its carry is a different —
            # wrong — question.)
            t_dev = time.monotonic()
            dres, dev_backend = self._escalate_device(job)
            t_end = time.monotonic()
            self.tracer.add_span(
                f"device[{self.device}]",
                t_dev,
                t_end,
                tid=job.id,
                args={
                    "degraded": dres is None,
                    "backend": dev_backend,
                    "trace_id": job.trace_id,
                },
            )
            self._trace_shards(job, dres, t_dev, t_end)
            self._merge_child_trace(job, dres, t_dev, t_end)
            self._merge_child_jit(job, dres)
            if dres is not None and dres.outcome != CheckOutcome.UNKNOWN:
                return dres, dev_backend
            if job.cancel.check() is not None:
                return res, engine
            if dres is None:
                self.stats.emit("degrade", job=job.id, to="cpu")
        if self.unbounded_close:
            res, engine = self._traced_cpu(job, job.cancel.remaining())
            return res, f"{engine}-unbounded"
        return res, engine

    def _traced_prefix(
        self, job: Job, budget: float | None
    ) -> tuple[CheckResult, str]:
        """Resumable host-frontier search for prefix-planned jobs.

        Runs :func:`..checker.frontier.check_frontier_auto` with the
        plan's carry as the initial configuration and its chosen cuts as
        snapshot points; on OK the completed cuts are written to the
        prefix store.  The span name distinguishes ``search.resume``
        (carry present) from ``search.cold`` (probe missed; this search
        merely seeds the store).
        """
        from ..checker.frontier import check_frontier_auto

        plan = job.prefix
        init_counts = init_states = None
        if plan.carry is not None:
            init_states = plan.carry.states
            if plan.kind == "extend":
                init_counts = plan.resume_counts
        mode = "resume" if plan.carry is not None else "cold"
        t0 = time.monotonic()
        # (A distributed-search partition runs an exhaustive
        # check_frontier(complete_cuts=True) instead; it comes with the
        # fleet tier, ROADMAP.md queue 1 item 6.)
        res = check_frontier_auto(
            job.hist,
            collect_stats=True,
            witness=False,
            profile=self.profile,
            init_counts=init_counts,
            init_states=init_states,
            snapshot_cuts=sorted(plan.snap_keys) or None,
            time_budget_s=budget,
            progress=job.progress_sink,
            prune=self.prune,
        )
        self.tracer.add_span(
            f"search.{mode}",
            t0,
            time.monotonic(),
            tid=job.id,
            args={
                "budget_s": budget,
                "outcome": res.outcome.value,
                "kind": plan.kind,
                "resume_ops": plan.resume_ops,
                "ops": len(job.hist.ops),
                "trace_id": job.trace_id,
            },
        )
        self._store_snapshots(job, res)
        return res, f"frontier-{mode}"

    def _store_snapshots(self, job: Job, res: CheckResult) -> None:
        """Write every completed snapshot cut of an OK search to the
        prefix store (checker/frontier.py already refused cuts touched by
        pruning or crossed by in-flight ops)."""
        plan = job.prefix
        if (
            self.prefix_store is None
            or plan is None
            or not plan.snap_keys
            or res.outcome != CheckOutcome.OK
        ):
            return
        snaps = getattr(res, "snapshots", None) or {}
        from ..checker.prefix import PrefixCarry
        from .prefixstore import make_entry

        n = len(job.hist.ops)
        for k, states in snaps.items():
            key = plan.snap_keys.get(k)
            if key is None:
                continue
            # Event horizon of the cut: the first suffix event (or the
            # whole window) — the offset a follow continuation folds from.
            horizon = plan.base_events + (
                job.hist.ops[k].call if k < n else plan.total_events
            )
            carry = PrefixCarry(ops=plan.base_ops + k, states=tuple(states))
            try:
                self.prefix_store.put(
                    key,
                    make_entry(
                        carry,
                        events=horizon,
                        stream=plan.stream,
                        window=plan.window,
                    ),
                )
            except ValueError:
                log.warning("job %d: refused snapshot at cut %d", job.id, k)
                continue
            self.stats.emit(
                "prefix_snapshot",
                job=job.id,
                key=key,
                ops=plan.base_ops + k,
                entries=len(self.prefix_store),
                bytes=self.prefix_store.bytes,
                trace_id=job.trace_id,
            )

    def _traced_cpu(
        self, job: Job, budget: float | None
    ) -> tuple[CheckResult, str]:
        if job.prefix is not None:
            return self._traced_prefix(job, budget)
        t0 = time.monotonic()
        # Optional kwargs only when asked/armed: test doubles for
        # _cpu_check keep the plain (hist, budget) signature, so the sink
        # rides only when the live function declares the kwarg.
        kw = {}
        if self.profile:
            kw["profile"] = True
        if job.progress_sink is not None and _accepts_kwarg(_cpu_check, "progress"):
            kw["progress"] = job.progress_sink
        if self.prune and _accepts_kwarg(_cpu_check, "prune"):
            kw["prune"] = True
        res, engine = _cpu_check(job.hist, budget, **kw)
        self.tracer.add_span(
            f"cpu[{engine}]",
            t0,
            time.monotonic(),
            tid=job.id,
            args={"budget_s": budget, "outcome": res.outcome.value},
        )
        return res, engine

    def _trace_shards(self, job: Job, res, t0: float, t1: float) -> None:
        """One span per mesh shard on the job's trace track, spanning the
        device-escalation window (per-segment timing lives in the profile
        timeline; the spans carry the per-shard occupancy summary)."""
        shards = getattr(getattr(res, "stats", None), "shards", None)
        if not shards:
            return
        for s in shards:
            segs = max(int(s.get("segments") or 0), 1)
            self.tracer.add_span(
                f"shard[{s.get('shard')}]",
                t0,
                t1,
                tid=job.id,
                args={
                    "device": s.get("device"),
                    "peak_occupancy": s.get("peak_occupancy"),
                    "mean_occupancy": round(
                        (s.get("occupancy_sum") or 0) / segs, 2
                    ),
                    "collective_wall_s": s.get("collective_wall_s"),
                    "skew": s.get("skew"),
                },
            )

    def _merge_child_trace(self, job: Job, res, t0: float, t1: float) -> None:
        """Stitch a supervised child's span ring onto the job's track.

        The child ships ``{"wall_base", "spans", "dropped", ...}`` back in
        the result JSON (supervise attaches it as ``res.child_trace``);
        the parent rebases via the wall_base clock-offset handshake and
        clamps into the observed escalation window [t0, t1], so the
        merged timeline can't contain negative durations whatever the
        clocks did.
        """
        child = getattr(res, "child_trace", None)
        if not isinstance(child, dict) or not self.tracer.enabled:
            return
        spans = child.get("spans") or []
        try:
            wall_base = float(child.get("wall_base", 0.0))
        except (TypeError, ValueError):
            return
        if not spans or wall_base <= 0:
            return
        merged = self.tracer.merge_child(
            spans,
            child_wall_base=wall_base,
            tid=job.id,
            clamp=(t0, t1),
            extra_args={
                "origin": "child",
                "trace_id": job.trace_id,
                "child_pid": child.get("pid"),
            },
        )
        if child.get("dropped"):
            log.warning(
                "job %d: child span ring dropped %s spans (truncated child timeline)",
                job.id,
                child.get("dropped"),
            )
        log.debug("job %d: merged %d child spans", job.id, merged)

    def _merge_child_jit(self, job: Job, res) -> None:
        """Fold a supervised child's harvested build snapshot
        (``res.child_jit``, the counterpart of ``child_trace``) into the
        daemon's introspector, and its kernel launches
        (``res.child_launches``) into :attr:`child_launches`."""
        child = getattr(res, "child_jit", None)
        if isinstance(child, dict):
            INTROSPECTOR.fold(child)
        launches = getattr(res, "child_launches", None)
        if isinstance(launches, dict):
            with self._launch_lock:
                for name, n in launches.items():
                    self.child_launches[name] = self.child_launches.get(name, 0) + int(n)

    def _escalate_device(self, job: Job) -> tuple[CheckResult | None, str]:
        """Run the device search, leasing a card set from the pool when
        one is configured.  Returns ``(result_or_None, backend_string)`` —
        ``device-mesh[N]`` for a leased N-card mesh run, ``device-{mode}``
        otherwise."""
        log.info("job %d: CPU budget exhausted; escalating to device", job.id)
        backend = f"device-{self.device}"
        remaining = job.cancel.remaining()
        lease_t = self.lease_timeout_s
        attempt_t = self.attempt_timeout_s
        if remaining is not None:
            # Neither the lease wait nor a child attempt may out-live
            # the job's deadline (the cancel poll frees the child within
            # grace anyway).
            lease_t = max(0.05, min(lease_t, remaining))
            attempt_t = max(0.1, min(attempt_t, remaining))
        lease = None
        if self.device_pool is not None:
            lease = self.device_pool.acquire(
                shape=job.shape,
                job=job.id,
                timeout_s=lease_t,
            )
            if lease is not None:
                backend = f"device-mesh[{lease.size}]"
                log.info(
                    "job %d: leased devices %s", job.id, list(lease.indices)
                )
            else:
                # Contention timeout: the single-card path still answers;
                # the pool has already emitted lease_timeout.
                log.warning(
                    "job %d: no device lease within %.1fs; running unsharded",
                    job.id,
                    lease_t,
                )
        try:
            if self.device == "inline":
                # The daemon loads torch here (and in a vmap launch group).
                from ..checker.device import check_device_auto

                kw = {} if self.device_rows is None else {"device_rows_cap": self.device_rows}
                if self.profile:
                    kw["profile"] = True
                if job.progress_sink is not None:
                    kw["progress"] = job.progress_sink
                if self.prune:
                    kw["prune"] = True
                if self.speculate_depth:
                    kw["speculate_depth"] = self.speculate_depth
                if lease is not None:
                    from ..parallel.distributed import frontier_mesh

                    kw["mesh"] = frontier_mesh(
                        devices=_lease_devices(self.torch_device, lease.indices)
                    )
                    kw["collect_stats"] = True
                else:
                    kw["device"] = self.torch_device
                return check_device_auto(job.hist, **kw), backend
            from .supervise import supervised_device_check

            dres = supervised_device_check(
                job.events,
                spool_dir=self.spool_dir,
                job_id=job.id,
                attempt_timeout_s=attempt_t,
                max_restarts=self.max_restarts,
                device_rows=self.device_rows,
                devices=lease.indices if lease is not None else None,
                profile=self.profile,
                trace_id=job.trace_id,
                log=lambda s: log.info("job %d supervise: %s", job.id, s),
                tracer=self.tracer,
                cancel=job.cancel.check,
                grace_s=self.cancel_grace_s,
                progress=job.progress_sink,
                prune=self.prune,
                speculate_depth=self.speculate_depth,
                device=self.torch_device,
            )
            if (
                dres is None
                and self.quarantine is not None
                and job.cancel.check() is None
            ):
                # The child died (or wedged past its kill timeout) with
                # no cancellation of ours to blame: one live crash
                # charged to this fingerprint in the poison ledger.
                self.quarantine.note_crash(job.fingerprint, kind="child")
            return dres, backend
        finally:
            if lease is not None:
                self.device_pool.release(lease)

    # -- artifact -----------------------------------------------------------

    def _write_artifact(self, job: Job, res: CheckResult) -> str:
        """Same artifact discipline as the one-shot CLI (cli._check_one):
        always emit the HTML visualization, re-deriving refusal reports
        for engines that don't produce them."""
        if (
            res.outcome in (CheckOutcome.ILLEGAL, CheckOutcome.UNKNOWN)
            and not res.refusals
        ):
            from ..checker.diagnostics import deepest_refusals

            report = deepest_refusals(job.hist, res.deepest or [])
            if report is not None:
                res.refusals = [report]

        from ..viz import write_visualization

        full = prepare(job.events, elide_trivial=False)
        os.makedirs(self.out_dir, exist_ok=True)
        fd, path = tempfile.mkstemp(
            prefix=f"{job.client}-job{job.id}-", suffix=".html", dir=self.out_dir
        )
        os.close(fd)
        cur = os.umask(0)
        os.umask(cur)
        os.chmod(path, 0o644 & ~cur)
        write_visualization(
            path,
            full,
            res,
            title=f"s2 linearizability check — {job.client} job {job.id}",
            checked=job.hist,
        )
        return path
