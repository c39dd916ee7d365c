"""The traced run's instruments: the profiler over the first requests of
the window, and a recorder of the fold's calls; and the device time of a
window traced whole, for an end-to-end metric read from the device trace.

The profiler records device activity only (CUDA, not the host's
operators, whose records would cost more than the search).  Its
timestamps are epoch nanoseconds, the clock of ``time.time_ns``, so the
benchmark's own spans (``prepare``, ``search``), taken on that clock,
name what the host was doing in each idle gap.

The recorder wraps ``fold_lanes`` as the search calls it
(``checker.device.fold_lanes``).  For each call it keeps the lanes and the
table's shape on the host, and the call's steps (``length`` clamped to the
table's width, summed) in a device buffer, reduced on a stream of its
own and fetched once the traced requests are done.  The trace leaves out
the device operations it launched (matched by the correlation ids of the
launches made inside its own calls), so that they count in no metric.
"""

from __future__ import annotations

import bisect
import re
import time

import torch

from ..roofline import fold as fold_roofline
from .record import Trace

__all__ = ["FoldRecorder", "Profiler", "device_seconds", "summarize"]

#: device operations, by the profiler's activity type
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_FOLD_KERNELS = ("fold_kernel", "scan_kernel")
_BUFFER = 4096


class FoldRecorder:
    def __init__(self, dev_mod):
        self._dev_mod = dev_mod
        self._real = dev_mod.fold_lanes
        self._side = None
        self._buffers: list[torch.Tensor] = []
        #: per call: lanes, table rows, table width
        self.calls: list[tuple[int, int, int]] = []
        #: epoch-ns intervals of the recorder's own launches
        self.intervals: list[tuple[int, int]] = []
        self.active = False
        dev_mod.fold_lanes = self

    def close(self) -> None:
        self._dev_mod.fold_lanes = self._real

    def __call__(self, seed, row, length, rh):
        if self.active:
            t0 = time.time_ns()
            n = len(self.calls)
            if n % _BUFFER == 0:
                self._buffers.append(torch.zeros(_BUFFER, dtype=torch.int64, device=length.device))
            out = self._buffers[-1][n % _BUFFER]
            if length.is_cuda:
                if self._side is None:
                    self._side = torch.cuda.Stream(length.device)
                self._side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self._side):
                    fold_roofline.call_steps(length, rh.shape[1], out=out)
                length.record_stream(self._side)
            else:
                fold_roofline.call_steps(length, rh.shape[1], out=out)
            self.calls.append((int(length.numel()), int(rh.shape[0]), int(rh.shape[1])))
            self.intervals.append((t0, time.time_ns()))
        return self._real(seed, row, length, rh)

    def steps(self) -> list[int]:
        """Each recorded call's steps (one fetch)."""
        if not self._buffers:
            return []
        if self._side is not None:
            self._side.synchronize()
        return torch.cat(self._buffers)[: len(self.calls)].tolist()


class Profiler:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._new = lambda: profile(activities=[ProfilerActivity.CUDA])
        self._prof = None

    def warm(self) -> None:
        """One short session, so that the first traced request does not pay
        for starting the device tracer."""
        with self._new():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof = self._new()
        self._prof.start()

    def stop(self) -> list:
        torch.cuda.synchronize()
        self._prof.stop()
        return self._prof.profiler.kineto_results.events()


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip() or name[:120]


def _kind(e) -> str:
    """The profiler's activity type of an event (read from its device and
    name where the event does not give it)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = kind()
        return kind if isinstance(kind, str) else str(kind)
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if getattr(e, "is_user_annotation", lambda: False)():
            return "gpu_user_annotation"
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def device_seconds(events) -> tuple[float, int]:
    """Seconds of the device operations in ``events``, and how many of them
    are kernels."""
    ns = kernels = 0
    for e in events:
        kind = _kind(e)
        if kind in _DEVICE_KINDS:
            ns += e.duration_ns()
            kernels += kind == "kernel"
    return ns / 1e9, kernels


def summarize(events, requests, recorder: FoldRecorder | None, peak: dict) -> Trace:
    """The trace of the traced ``requests``: device time, launches, the
    longest idle gaps and the fold's time against its bound."""
    lo = min(r.spans_ns[0] for r in requests)
    hi = max(r.spans_ns[2] for r in requests)
    own = set()
    if recorder is not None and recorder.intervals:
        starts = sorted(recorder.intervals)
        firsts = [a for a, _ in starts]
        for e in events:
            if _kind(e).startswith("cuda_"):
                t = e.start_ns()
                j = bisect.bisect_right(firsts, t) - 1
                if j >= 0 and t <= starts[j][1]:
                    own.add(e.correlation_id())
    ops = [
        (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), _kind(e))
        for e in events
        if _kind(e) in _DEVICE_KINDS and e.correlation_id() not in own
    ]
    ops.sort()
    by_name: dict[str, float] = {}
    fold_ns = 0
    for a, b, name, _ in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        if any(k in name for k in _FOLD_KERNELS):
            fold_ns += b - a
    # The union of the device's busy intervals inside the window, and the
    # gaps between them.
    busy_ns, gaps, cursor = 0, [], lo
    for i, (a, b, _, _) in enumerate(ops):
        a, b = max(a, lo), min(b, hi)
        if b <= cursor:
            continue
        if a > cursor:
            gaps.append((a - cursor, cursor, i))
        busy_ns += b - max(a, cursor)
        cursor = b
    if hi > cursor:
        gaps.append((hi - cursor, cursor, len(ops)))
    gaps.sort(reverse=True)
    idle = []
    for length, at, nxt in gaps[:10]:
        where = "between requests"
        for r in requests:
            s, p, e = r.spans_ns
            if s <= at < p:
                where = "prepare"
            elif p <= at < e:
                where = "search"
        after = _short(ops[nxt][2]) if nxt < len(ops) else "the window's end"
        idle.append([f"{where}, before {after}", length / 1e9])
    trace = Trace(
        window_s=(hi - lo) / 1e9,
        busy_s=busy_ns / 1e9,
        launches=sum(1 for op in ops if op[3] == "kernel"),
        device_ops=by_name,
        idle_gaps=idle,
        fold_s=fold_ns / 1e9,
    )
    if recorder is not None and recorder.calls:
        by = {"operations": 0.0, "bytes": 0.0}
        for steps, (lanes, rows, width) in zip(recorder.steps(), recorder.calls):
            s, what = fold_roofline.call_bound_s(steps, lanes, rows, width, peak)
            by[what] += s
        trace.fold_bound_s = by["operations"] + by["bytes"]
        trace.fold_calls = len(recorder.calls)
        trace.fold_bound_by = max(by, key=by.get)
    return trace
