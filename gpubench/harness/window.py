"""Set-up, warm-up and the measured window of one run of a cell.

Each request is what ``python -m s2_verification_tpu_torch check
-backend=device -no-viz`` does with one history, in process: decode its
JSONL (``utils/events.py``), prepare it (``checker/entries.py::prepare``),
and decide it with ``checker/device.py::check_device_auto`` and the
keywords the CLI passes by default; then the device is synchronised.  The
loop is closed, with one client: a request is sent when the previous
verdict is back, while the window is open, and the window closes with the
last verdict, so no request is counted in part.  Requests take the pool's
histories in turn.
"""

from __future__ import annotations

import gc
import hashlib
import sys
import time
import traceback

from .record import Request, Run
from .spec import Cell

__all__ = ["request_seed", "make_pool", "run_window"]


def request_seed(seed: int, what) -> int:
    """The generator's seed for item ``what`` of the run seeded ``seed``."""
    return int.from_bytes(hashlib.sha256(f"{seed}/{what}".encode()).digest()[:8], "little")


def make_pool(cell: Cell, seed: int) -> list[str]:
    params = cell.params()
    return [cell.make(params, request_seed(seed, i), i) for i in range(cell.traffic["pool"])]


def run_window(cell: Cell, seed: int, seconds: float, trace: bool, started: float, device: str = "cuda"):
    """Set up, warm up and measure one run.  Returns the :class:`Run`
    (setup measured from ``started``, a ``time.perf_counter`` reading) and
    the pool of histories."""
    marks = [("start", started)]
    import torch

    from s2_verification_tpu_torch.checker import device as dev_mod
    from s2_verification_tpu_torch.checker.entries import prepare
    from s2_verification_tpu_torch.utils import events as ev

    marks.append(("imports", time.perf_counter()))
    cuda = device == "cuda"
    if cuda:
        from s2_verification_tpu_torch.ops import fold_cuda

        torch.zeros(1, device=device)
        marks.append(("cuda_context", time.perf_counter()))
        fold_cuda.build()
        marks.append(("fold_build", time.perf_counter()))
    pool = make_pool(cell, seed)
    warm = cell.make(cell.params(**cell.traffic.get("warmup", {})), request_seed(seed, "warmup"), "warmup")
    marks.append(("pool", time.perf_counter()))

    def one(text: str, index: int, traced: bool) -> Request:
        s_ns, start = time.time_ns(), time.perf_counter()
        prepared, p_ns, outcome, hist, res = start, s_ns, "error", None, None
        try:
            hist = prepare(list(ev.iter_history(text)), elide_trivial=True)
            prepared, p_ns = time.perf_counter(), time.time_ns()
            res = dev_mod.check_device_auto(
                hist, collect_stats=trace, device=device, checkpoint_path=None,
                profile=False, prune=False, speculate_depth=0,
            )
            if cuda:
                torch.cuda.synchronize()
            outcome = res.outcome.value
        except Exception:  # a request that raises is a failed request; the run goes on
            traceback.print_exc(file=sys.stderr)
        end, e_ns = time.perf_counter(), time.time_ns()
        stats = getattr(res, "stats", None)
        return Request(
            pool_index=index, start=start, prepared=prepared, end=end, outcome=outcome,
            checked_ops=len(hist.ops) if hist is not None else 0,
            layers=None if stats is None else stats.layers,
            host_syncs=None if stats is None else stats.host_syncs,
            witness=[hist.ops[i].op_id for i in res.linearization] if outcome == "ok" else None,
            traced=traced, spans_ns=(s_ns, p_ns, e_ns),
        )

    one(warm, -1, False)
    marks.append(("warmup", time.perf_counter()))
    n_traced = cell.traffic["trace"]["requests"] if trace else 0
    # A cell with an end-to-end metric read from the device trace has the
    # whole window traced in its untraced runs (device activity only).
    whole = cuda and not trace and any(m["source"] == "device_trace" for m in cell.end_to_end)
    profiler = recorder = peak = None
    if n_traced or whole:
        from .trace import Profiler

        profiler = Profiler()
        profiler.warm()
    if n_traced:
        from ..roofline.fold import PEAKS
        from .trace import FoldRecorder

        peak = PEAKS[torch.cuda.get_device_name()]
        recorder = FoldRecorder(dev_mod)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # The pool and everything set-up made stay out of the collector's
    # sweeps, as a process that checks one history would have none of it.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - started
    requests: list[Request] = []
    events = None
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            i = len(requests)
            if i == 0 and profiler is not None:
                profiler.start()
                if recorder is not None:
                    recorder.active = True
            if n_traced and i == n_traced:
                recorder.active = False
                events = profiler.stop()
            requests.append(one(pool[i % len(pool)], i % len(pool), i < n_traced))
        if n_traced and events is None:
            recorder.active = False
            events = profiler.stop()
        if whole:
            events = profiler.stop()
    finally:
        if recorder is not None:
            recorder.close()
    window_s = requests[-1].end - t0
    peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    gc.unfreeze()
    marks.append(("tracer", t0))
    setup = {name: b - a for (_, a), (name, b) in zip(marks, marks[1:])}
    run = Run(setup_s=setup_s, window_s=window_s, requests=requests, peak_bytes=peak_bytes, setup_parts=setup)
    if whole:
        from .trace import device_seconds

        run.device_s, run.device_kernels = device_seconds(events)
    if n_traced:
        from .trace import summarize

        run.trace = summarize(events, run.traced_requests(), recorder, peak)
    return run, pool
