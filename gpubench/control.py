"""The control of a cell's correctness check: the plain reference put in the
program's place at a lower precision, judged as a run's verdicts are.

    python3 gpubench/control.py --workload <name> --seeds S [S ...]
        [--requests N] [--precision compare32|carry32]

The configurations state a 64-bit chain hash; the nearest precision below
is 32 bits, which a search can take in two ways:

- ``compare32``: the chain is folded at 64 bits, but a read's stream hash
  is compared on its high 32-bit word only;
- ``carry32``: the chain's running hash is carried in 32 bits (its low
  word), each step seeded by it, and a read's hash is compared on its low
  word.

For each seed it makes the cell's pool as a run does, decides the first
``--requests`` histories with ``reference/search.py`` at that precision,
judges those verdicts with the 64-bit reference (``harness/judge.py``),
and prints one JSON line a seed: the numbers compared, which a correct run
holds at 0.  The benchmark's runs never run it.  Needs no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

_M32 = np.uint64(0xFFFFFFFF)


def _compare32(hashes: np.ndarray, reported: int) -> np.ndarray:
    return (hashes >> np.uint64(32)) == np.uint64(reported >> 32)


def _carry32_fold(stream_hashes, record_hashes):
    from gpubench.reference.xxh3 import chain_np

    out = np.asarray(stream_hashes, dtype=np.uint64) & _M32
    with np.errstate(over="ignore"):
        for rh in record_hashes:
            out = chain_np(out, rh) & _M32
    return out


def _carry32_compare(hashes: np.ndarray, reported: int) -> np.ndarray:
    return hashes == np.uint64(reported & 0xFFFFFFFF)


PRECISIONS = {
    "compare32": {"same_hash": _compare32},
    "carry32": {"fold": _carry32_fold, "same_hash": _carry32_compare},
}


def control_requests(pool: list[str], n: int, **precision) -> list:
    """The verdicts of the reference search (with ``precision``, one of
    :data:`PRECISIONS`' entries) on the first ``n`` histories of ``pool``,
    as a run's requests."""
    from gpubench.harness.record import Request
    from gpubench.reference import history, search

    out = []
    for i, text in enumerate(pool[:n]):
        t0 = time.perf_counter()
        order = search.decide(history.parse(text), **precision)
        t1 = time.perf_counter()
        out.append(Request(pool_index=i, start=t0, prepared=t0, end=t1,
                           outcome="illegal" if order is None else "ok", checked_ops=0, witness=order))
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 gpubench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--precision", choices=sorted(PRECISIONS), required=True)
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "gpubench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    from gpubench.harness.judge import LIMITS, judge
    from gpubench.harness.spec import load_cell
    from gpubench.harness.window import make_pool

    cell = load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        pool = make_pool(cell, seed)
        requests = control_requests(pool, args.requests, **PRECISIONS[args.precision])
        numbers, judged, refused = judge(requests, pool, "all", seed)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "precision": args.precision,
            "verdicts": [r.outcome for r in requests], "judged": judged,
            "correct": all(numbers[k] <= LIMITS[k] for k in LIMITS),
            "checks": {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS},
            "refused": refused[:3], "seconds": time.perf_counter() - t0,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
