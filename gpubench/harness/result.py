"""One run of a cell, from set-up to its result line."""

from __future__ import annotations

import sys

from .judge import LIMITS, judge
from .spec import Cell
from .window import run_window

__all__ = ["FORBIDDEN", "execute", "forbidden_modules"]

#: top-level module names the process must not hold: JAX, and the JAX
#: package the port was made from (a prefix of the port's own name, so
#: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "s2_verification_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _cut(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."


def execute(cell: Cell, seed: int, seconds: float, trace: bool, started: float, device: str = "cuda") -> dict:
    """Run the cell once and return its result: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` (without ``kind``), with
    ``--trace 1`` ``breakdown``, and last ``checks``, the numbers compared
    with their limits."""
    run, pool = run_window(cell, seed, seconds, trace, started, device=device)
    numbers, judged, refused = judge(run.requests, pool, cell.traffic["judge"]["illegal_sample"], seed)
    kind = "metrics" if trace else "e2e"
    metrics = {}
    for entry in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(kind, entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    out = {
        "correct": all(numbers[k] <= LIMITS[k] for k in LIMITS),
        "attempted": len(run.requests),
        "failed": numbers["failed"],
        "metrics": metrics,
        "device": {"count": cell.chips, "memory_peak_bytes": run.peak_bytes},
        "setup_parts_s": run.setup_parts,
        "walls_s": [r.wall_s for r in run.requests],
        "device_traced": None if run.device_s is None else (run.device_s, run.device_kernels),
        "judged": judged,
        "refused": refused[:5],
    }
    if run.trace is not None:
        t = run.trace
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        top = sorted(t.device_ops.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {
            "device_ops": [[_cut(name), s] for name, s in top],
            "idle_gaps": t.idle_gaps[:10],
        }
        out["fold"] = {"calls": t.fold_calls, "kernel_s": t.fold_s, "bound_s": t.fold_bound_s, "bound_by": t.fold_bound_by}
    out["checks"] = {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
    return out
