"""Supervised device escalation: bounded child + checkpoint resume.

The port's copy of the JAX package's ``service/supervise.py``.  A device
search can take its process down (a lost or reset card, an out-of-memory
kill) or hang in a CUDA call — failure shapes that would take a
resident daemon down with the job.  A device escalation therefore runs in
the bounded-child/checkpoint-resume machinery of
``checker/resilient.drive`` + ``checker/checkpoint``:

- the search runs in a child with a hard attempt timeout (crash → nonzero
  rc, hang → process-group kill);
- each relaunch resumes from the search checkpoint, so a crash costs one
  segment, not the search;
- when the restart budget is exhausted (or the backend never answers its
  probe again), :func:`supervised_device_check` returns ``None``: the
  caller's signal to decide *that job* on the CPU engines.  Nothing here
  turns ``None`` into a verdict, and the supervising process never
  imports ``torch``.

This module is also the child's entry point
(``python -m s2_verification_tpu_torch.service.supervise HIST CKPT OUT
[extras]``): check with ``check_device_auto`` on the card (or on the
device the ``device=`` extra names), write the result JSON atomically to
OUT.  The result JSON has the JAX child's layout, so each package's
:func:`_result_from_json` reads the other's.
"""

from __future__ import annotations

import json
import os
import sys

from ..checker.oracle import CheckOutcome, CheckResult

__all__ = ["supervised_device_check"]


def _result_to_json(res: CheckResult) -> dict:
    out = {
        "outcome": res.outcome.value,
        "linearization": res.linearization,
        "deepest": list(res.deepest),
        "steps": res.steps,
    }
    st = getattr(res, "stats", None)
    if st is not None:
        # Search stats (incl. the per-shard summary and profile timeline of
        # a mesh run) cross the process boundary with the verdict: the
        # parent's metrics/tracer/viz must see what the child measured.
        import dataclasses

        out["stats"] = dataclasses.asdict(st)
    return out


def _result_from_json(obj: dict) -> CheckResult:
    res = CheckResult(
        CheckOutcome(obj["outcome"]),
        linearization=obj.get("linearization"),
        deepest=list(obj.get("deepest") or []),
        steps=int(obj.get("steps") or 0),
    )
    st = obj.get("stats")
    if isinstance(st, dict):
        import dataclasses

        from ..checker.stats import FrontierStats

        known = {f.name for f in dataclasses.fields(FrontierStats)}
        res.stats = FrontierStats(  # type: ignore[attr-defined]
            **{k: v for k, v in st.items() if k in known}
        )
    # The child's own span ring (``{"trace_id", "pid", "wall_base",
    # "spans", "dropped"}``) rides the result JSON home; the scheduler
    # stitches it onto the job's trace track via clock rebasing.
    trace = obj.get("trace")
    if isinstance(trace, dict):
        res.child_trace = trace  # type: ignore[attr-defined]
    # Likewise the child's harvested build snapshot: the scheduler folds
    # it into the daemon's introspector (verifyd_jit_* families).
    jit = obj.get("jit")
    if isinstance(jit, dict):
        res.child_jit = jit  # type: ignore[attr-defined]
    # The port's child also reports its kernel launches (absent from a JAX
    # child's JSON).
    launches = obj.get("launches")
    if isinstance(launches, dict):
        res.child_launches = launches  # type: ignore[attr-defined]
    return res


def supervised_device_check(
    events: list,
    *,
    spool_dir: str,
    job_id: int,
    attempt_timeout_s: float = 900.0,
    max_restarts: int = 2,
    device_rows: int | None = None,
    devices: tuple[int, ...] | list[int] | None = None,
    profile: bool = False,
    trace_id: str = "",
    probe: bool | None = None,
    log=None,
    tracer=None,
    cancel=None,
    grace_s: float = 5.0,
    progress=None,
    prune: bool = False,
    speculate_depth: int = 0,
    device: str | None = None,
) -> CheckResult | None:
    """Run the device search for ``events`` under supervision.

    Returns the device verdict, or ``None`` when the device never produced
    one (restart budget exhausted, backend dead) — the caller's signal to
    degrade the job to CPU.  ``device`` (``None`` = the card; ``"cpu"``
    runs the child's search on the CPU, the counterpart of the JAX
    package's ``JAX_PLATFORMS=cpu`` pin) rides to the child as the argv
    extra ``device=...``.  ``probe`` gates between-attempt backend
    probing; default: on unless ``device`` is ``"cpu"`` (probing a CPU
    "backend" is pointless and slow).  ``tracer`` (a
    :class:`~..obs.Tracer`) records ``drive``'s attempt/probe spans on
    the job's trace track.

    ``devices`` (a :class:`~.devicepool.DevicePool` grant): offsets into
    the child's visible cards (slot ``i`` is ``cuda:i``; with
    ``device="cpu"`` every slot is a ``"cpu"`` shard); the child builds a
    frontier mesh over exactly those devices and runs the search sharded,
    collecting the per-shard stats the parent's metrics need.  Indices
    travel as argv — the supervising process never resolves device
    objects itself (a hung CUDA call cannot be interrupted;
    ``checker/resilient.py``).  Because the child
    re-places the checkpointed frontier onto whatever mesh its argv
    names, a restart after a re-grant onto a *different* chip set resumes
    the same snapshot.  ``profile=True`` makes the child record the
    per-segment timeline (rides back in the result JSON).

    ``cancel`` (a ``() -> reason | None`` callable, the job's
    CancelToken poll) is threaded into ``drive``: a cancelled job
    SIGTERMs the child, waits ``grace_s`` for a clean exit, SIGKILLs it
    otherwise, and returns ``None`` with no relaunch — the lease
    releases through the scheduler's normal ``finally``.

    ``progress`` (a :class:`~..checker.progress.ProgressSink`) crosses
    the process boundary over the same spool-file seam as the history and
    result: the child overwrites ``jobN.progress.json`` atomically with
    its latest heartbeat, and the parent reads it from inside the
    existing cancel poll of ``drive`` (no extra thread) and re-offers it to
    the job's sink — so a supervised search is as watchable as an inline
    one, and the spooled file survives a SIGKILL for the flight
    recorder's post-mortem.

    ``prune``/``speculate_depth`` are the search-accelerator knobs
    (``checker/device.check_device_auto``): verdict-exact order pruning
    and the speculative multi-layer dive.  They ride to the child as
    argv extras, so a restarted attempt keeps the same configuration.
    """
    from ..checker.resilient import default_probe_cmd, drive
    from ..obs.trace import NULL_TRACER
    from ..utils import events as ev

    os.makedirs(spool_dir, exist_ok=True)
    hist_path = os.path.join(spool_dir, f"job{job_id}.jsonl")
    ckpt_path = os.path.join(spool_dir, f"job{job_id}.ckpt.npz")
    out_path = os.path.join(spool_dir, f"job{job_id}.result.json")
    progress_path = os.path.join(spool_dir, f"job{job_id}.progress.json")
    with open(hist_path, "w", encoding="utf-8") as f:
        ev.write_history(events, f)

    if probe is None:
        probe = device != "cpu"
    cmd = [
        sys.executable,
        "-m",
        "s2_verification_tpu_torch.service.supervise",
        hist_path,
        ckpt_path,
        out_path,
    ]
    if device_rows is not None:
        cmd.append(str(device_rows))
    if devices is not None:
        cmd.append("devices=" + ",".join(str(int(i)) for i in devices))
    if profile:
        cmd.append("profile=1")
    if prune:
        cmd.append("prune=1")
    if speculate_depth:
        cmd.append(f"spec={int(speculate_depth)}")
    if trace_id:
        # Distributed-trace propagation: the child runs its own Tracer
        # under this id and ships its span ring back in the result JSON.
        cmd.append("trace=" + trace_id)
    if device is not None:
        cmd.append("device=" + str(device))
    if progress is not None:
        cmd.append("progress=" + progress_path)
        cancel = _progress_poll(cancel, progress, progress_path)
    try:
        outcome = drive(
            cmd,
            done=lambda: os.path.exists(out_path),
            attempt_timeout_s=attempt_timeout_s,
            max_restarts=max_restarts,
            probe_cmd=default_probe_cmd(device) if probe else None,
            log=log,
            tracer=tracer if tracer is not None else NULL_TRACER,
            trace_tid=job_id,
            cancel=cancel,
            grace_s=grace_s,
        )
        if not outcome.ok:
            return None
        with open(out_path, encoding="utf-8") as f:
            return _result_from_json(json.load(f))
    except (OSError, ValueError, KeyError):
        return None
    finally:
        for p in (hist_path, ckpt_path, out_path, progress_path):
            try:
                os.remove(p)
            except OSError:
                pass


def _progress_poll(cancel, sink, path, min_interval_s: float = 0.5):
    """Wrap the cancel poll of ``drive`` to also drain the child's spooled
    heartbeat.  ``drive`` already polls cancel every ~0.25s while it
    waits on the child; reading one small JSON file at bounded cadence
    rides that loop for free (no babysitter thread)."""
    import time as _time

    state = {"next": 0.0, "stamp": None}

    def poll():
        now = _time.monotonic()
        if now >= state["next"]:
            state["next"] = now + min_interval_s
            try:
                with open(path, encoding="utf-8") as f:
                    rec = json.load(f)
                stamp = (rec.get("ops_committed"), rec.get("layer"))
                if stamp != state["stamp"]:
                    state["stamp"] = stamp
                    sink.update(
                        ops_committed=int(rec.get("ops_committed", 0)),
                        total_ops=int(rec.get("total_ops", 0)),
                        frontier_width=int(rec.get("frontier_width", 0)),
                        states_expanded=int(rec.get("states_expanded", 0)),
                        layer=rec.get("layer"),
                        engine=str(rec.get("engine", "device")),
                    )
            except (OSError, ValueError, TypeError):
                pass
        return cancel() if cancel is not None else None

    return poll


def _child_main(argv: list[str]) -> int:
    hist_path, ckpt_path, out_path = argv[:3]
    # Trailing argv: a bare int is the legacy device_rows cap; `key=value`
    # extras carry the mesh grant, the profile flag, the trace id, and the
    # device (the counterpart of the JAX child's platform pin).
    device_rows: int | None = None
    devices: list[int] | None = None
    profile = False
    trace_id = ""
    progress_path = ""
    prune = False
    spec_depth = 0
    device: str | None = None
    for extra in argv[3:]:
        if extra.startswith("devices="):
            devices = [int(s) for s in extra[len("devices=") :].split(",") if s]
        elif extra.startswith("profile="):
            profile = extra[len("profile=") :] == "1"
        elif extra.startswith("prune="):
            prune = extra[len("prune=") :] == "1"
        elif extra.startswith("spec="):
            spec_depth = int(extra[len("spec=") :])
        elif extra.startswith("trace="):
            trace_id = extra[len("trace=") :]
        elif extra.startswith("progress="):
            progress_path = extra[len("progress=") :]
        elif extra.startswith("device="):
            device = extra[len("device=") :] or None
        else:
            device_rows = int(extra)
    if not trace_id:
        from ..obs.context import ENV_TRACE

        trace_id = os.environ.get(ENV_TRACE, "")

    from ..checker.device import check_device_auto, resolve_device
    from ..checker.entries import prepare
    from ..obs.introspect import INTROSPECTOR, job_context
    from ..obs.trace import Tracer
    from ..ops import fold_cuda
    from ..utils import events as ev
    from .scheduler import shape_key

    # CUDA unless the argv names another device; without a card this
    # raises DeviceUnavailable (a nonzero exit), never a CPU search.
    dev = resolve_device(device)

    # The child's own span ring: a small Tracer whose wall_base rides the
    # result JSON back so the parent can rebase these spans onto its
    # timeline (the clock-offset handshake).  tid is irrelevant here —
    # the parent re-homes merged spans onto the job's track.
    tracer = Tracer(512)
    with tracer.span("child_prepare", cat="child", args={"trace_id": trace_id}):
        hist = prepare(ev.read_history(hist_path))
    kw: dict = {} if device_rows is None else {"device_rows_cap": device_rows}
    if profile:
        kw["profile"] = True
    if prune:
        kw["prune"] = True
    if spec_depth:
        kw["speculate_depth"] = spec_depth
    if progress_path:
        # The latest heartbeat overwrites the spool file atomically: the
        # parent samples it from its cancel poll, and whatever survives a
        # SIGKILL tells the post-mortem how far the search got.
        from ..checker.progress import ProgressSink

        def _spool(rec, _path=progress_path):
            tmp = f"{_path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(rec, f)
                os.replace(tmp, _path)
            except OSError:
                pass

        kw["progress"] = ProgressSink(_spool)
    if devices is not None:
        from ..parallel.distributed import frontier_mesh

        if dev.type == "cuda":
            import torch

            visible = torch.cuda.device_count()
            missing = [i for i in devices if i >= visible]
            if missing:
                raise SystemExit(
                    f"device grant {devices} exceeds the {visible} visible "
                    "devices (check CUDA_VISIBLE_DEVICES / the device= extra)"
                )
            shards = [torch.device("cuda", i) for i in devices]
        else:
            # Slots of a CPU grant are shards on the one host device.
            shards = [dev] * len(devices)
        # Mesh runs always collect stats: the parent's per-shard metric
        # families are fed from the result JSON, profile or not.
        kw["mesh"] = frontier_mesh(devices=shards)
        kw["collect_stats"] = True
    else:
        kw["device"] = dev
    # Job context for the build sites: a library built in this child is
    # attributed to the job's shape bucket, and its build span lands on
    # the child tracer (merged home with everything else).
    with job_context(
        shape=shape_key(hist), trace_id=trace_id, tracer=tracer
    ), tracer.span(
        "child_search",
        cat="child",
        args={"trace_id": trace_id, "devices": devices or []},
    ):
        res = check_device_auto(hist, checkpoint_path=ckpt_path, **kw)
    out = _result_to_json(res)
    # Harvest-and-reset: a restarted attempt reports only its own
    # builds, so the parent's fold never double-counts.
    out["jit"] = INTROSPECTOR.snapshot_and_reset()
    # This attempt's kernel launches (the parent cannot count a child's);
    # the JAX package's reader ignores the key.
    out["launches"] = dict(fold_cuda.LAUNCHES)
    out["trace"] = {
        "trace_id": trace_id,
        "pid": os.getpid(),
        "wall_base": round(tracer.wall_base, 6),
        "spans": tracer.export()["traceEvents"],
        "dropped": tracer.dropped,
    }
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(out, f)
    os.replace(tmp, out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(_child_main(sys.argv[1:]))
