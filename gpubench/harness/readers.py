"""The arithmetic of the per-layer metrics, shared by the readers under
``metrics/`` that compute one quantity for different cells."""

from __future__ import annotations

from .record import Run

__all__ = [
    "prepare_ms",
    "syncs_per_layer",
    "launches_per_layer",
    "fold_roofline",
    "kernel_ms_per_verdict",
    "device_idle_pct",
]


def prepare_ms(run: Run) -> float | None:
    """Mean milliseconds a request spent decoding and preparing its
    history, over the window's requests."""
    spans = [r.prepared - r.start for r in run.requests if r.prepared > r.start]
    return 1e3 * sum(spans) / len(spans) if spans else None


def syncs_per_layer(run: Run) -> float | None:
    """Host synchronisations over layers (``FrontierStats``), summed over
    the window's verdicts."""
    rs = [r for r in run.requests if r.layers]
    layers = sum(r.layers for r in rs)
    return sum(r.host_syncs for r in rs) / layers if layers else None


def launches_per_layer(run: Run) -> float | None:
    """Kernel launches in the trace over the traced verdicts' layers."""
    layers = sum(r.layers or 0 for r in run.traced_requests())
    return run.trace.launches / layers if run.trace and layers else None


def fold_roofline(run: Run) -> float | None:
    """The fold's least time (``roofline/fold.py``) over the device time of
    its kernels, in percent."""
    t = run.trace
    if t is None or not t.fold_calls or t.fold_s <= 0:
        return None
    return 100.0 * t.fold_bound_s / t.fold_s


def kernel_ms_per_verdict(run: Run) -> float | None:
    """Device time of every operation in the trace over the verdicts it
    holds, in milliseconds."""
    n = sum(r.decided for r in run.traced_requests())
    return 1e3 * sum(run.trace.device_ops.values()) / n if run.trace and n else None


def device_idle_pct(run: Run) -> float | None:
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s > 0 else None
