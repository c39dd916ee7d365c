"""Run one cell of the benchmark of ``s2_verification_tpu_torch`` once.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  It builds the cell's pool of histories from ``--seed``, warms
up with one request of the cell's shape, then sends requests for
``--seconds`` (closed loop, one client), judges the window's verdicts with
the plain reference (``gpubench/reference/``), and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared with its limit (also the last lines
on standard error).  It exits with 2 and prints no result where CUDA or
the cell's devices are missing, and with 3 where JAX or the JAX package
was loaded.  Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 where unreadable)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: the process's start, on the ``time.perf_counter`` clock
STARTED = time.perf_counter() - _process_age()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "gpubench" / ".cache"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 gpubench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "gpubench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    from gpubench.harness.result import execute, forbidden_modules
    from gpubench.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace), STARTED)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(), **out["device"]}
    out["checks"] = out.pop("checks")
    parts = ", ".join(f"{k} {v:.3f}" for k, v in out.pop("setup_parts_s").items())
    print(f"gpubench: set-up seconds by part: {parts}", file=sys.stderr)
    walls = out.pop("walls_s")
    ranked = sorted(walls)
    print(f"gpubench: {len(walls)} request walls (s): first {[round(w, 4) for w in walls[:3]]}, "
          f"median {ranked[len(ranked) // 2]:.4f}, max {ranked[-1]:.4f}", file=sys.stderr)
    traced = out.pop("device_traced")
    if traced:
        print(f"gpubench: the whole window traced: {traced[0]:.6f} s of device operations, {traced[1]} kernels "
              f"over {len(walls)} requests", file=sys.stderr)
    fold = out.pop("fold", None)
    if fold:
        print(f"gpubench: fold: {fold['calls']} calls, {fold['kernel_s']} s in its kernels, least time "
              f"{fold['bound_s']} s (mostly set by {fold['bound_by']})", file=sys.stderr)
    print(f"gpubench: {out.pop('judged')} verdicts judged; refused: {out.pop('refused') or 'none'}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"{name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
