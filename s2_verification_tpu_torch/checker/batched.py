"""Cross-job batched checking: one launch decides many same-shape lanes.

The port of the JAX package's ``checker/batched.py``: two lane engines
behind one result shape.

- **batch-native** — a Python loop over the native C++ engine with
  *pre-encoded* lanes (``check_native(..., enc=...)``): the whole launch
  group is encoded once (:func:`..models.encode.encode_batch`) and every
  lane gets the canonical rich ``CheckResult`` (witness, refusals,
  deepest), so this engine is drop-in for any job the sequential path
  could serve.

- **batch-vmap** — the whole launch group runs as ONE lane-batched search
  (:func:`.device.run_search_lanes`, the counterpart of the JAX engine's
  ``jit(vmap(run_search))``): ``encode_batch`` makes every lane's arrays
  shape-identical, the lanes' tables are stacked, and one layer loop steps
  every running lane.  A lane whose search stops (accept/empty)
  **latches**: its result is frozen while the stragglers keep stepping,
  and ``layers`` records how early it decided.  Beam soundness is per
  lane: OK is conclusive under pruning, EMPTY is ILLEGAL only if that lane
  never pruned; anything else returns ``None`` and the caller escalates
  that lane on the sequential path.  No witness is recovered.

The JAX engines' ``skip``, ``on_lane``, ``progress``, ``profile`` and
``prune`` keywords, ``BatchLane.time_budget_s`` and ``default_engine``
serve only that package's daemon (``service/batcher.py``); they come back
with the port's daemon.

The JAX launch pads its lane count to a power of two (repeating the last
lane) to bound its compile variants.  This port compiles nothing per
shape, so it launches the lanes it is given; verdicts do not depend on the
padding.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..models.encode import EncodedHistory
from .device import (
    STOP_ACCEPT,
    STOP_EMPTY,
    build_tables,
    init_frontier,
    resolve_device,
    run_search_lanes,
)
from .entries import History
from .native import check_native
from .oracle import CheckOutcome, CheckResult

__all__ = [
    "BatchLane",
    "LaneVerdict",
    "VMAP_LANE_CAPACITY",
    "check_batch_native",
    "check_batch_vmap",
]

#: Beam capacity per vmap lane.  Collector-shaped histories decide at tiny
#: frontiers; per-layer cost scales with this width for every lane, so the
#: lane default stays small and a pruned dead end escalates that one lane
#: to the sequential path.
VMAP_LANE_CAPACITY = 64


@dataclass
class BatchLane:
    """One job's search inputs inside a launch group."""

    history: History
    enc: EncodedHistory


@dataclass
class LaneVerdict:
    """Per-lane outcome of a batched launch.

    ``result`` is ``None`` when this engine could not decide the lane (a
    vmap lane pruned into a dead end, or ``skipped="init-overflow"``: more
    initial states than the lane's capacity): the caller runs that lane
    through the sequential path instead.  ``search_s`` is
    the lane's own C call for batch-native, the shared launch wall for
    batch-vmap.  ``layers`` (vmap only) is how many layers the lane ran
    before its verdict latched.
    """

    result: CheckResult | None
    engine: str
    search_s: float
    layers: int = -1
    skipped: str | None = None


def check_batch_native(lanes: list[BatchLane]) -> list[LaneVerdict]:
    """Run each lane through the native engine without re-encoding."""
    out: list[LaneVerdict] = []
    for lane in lanes:
        t0 = time.monotonic()
        res = check_native(lane.history, enc=lane.enc)
        out.append(LaneVerdict(res, "batch-native", time.monotonic() - t0))
    return out


def _mega_launch(tables, frontiers, max_layers):
    """The launch group's one lane-batched search (the JAX engine's
    ``jit(vmap(run_search))`` with ``allow_prune=True``)."""
    return run_search_lanes(tables, frontiers, max_layers)


def check_batch_vmap(
    lanes: list[BatchLane],
    capacity: int = VMAP_LANE_CAPACITY,
    device=None,
) -> list[LaneVerdict]:
    """One lane-batched frontier search over the whole launch group.

    Lanes must come from one :func:`..models.encode.encode_batch` call
    (shape-identical arrays).  Per-lane verdicts follow the beam soundness
    rules; undecidable lanes return ``result=None``.  ``device`` is the
    search's device, CUDA unless the caller names another
    (:func:`.device.resolve_device`).
    """
    dev = resolve_device(device)
    n = len(lanes)
    verdicts: list[LaneVerdict | None] = [None] * n
    live: list[int] = []
    tables_list = []
    frontier_list = []
    for i, lane in enumerate(lanes):
        enc = lane.enc
        if enc.total_remaining == 0:
            # The forced prefix consumed every op: trivially OK, as in
            # check_device.
            verdicts[i] = LaneVerdict(
                CheckResult(
                    CheckOutcome.OK,
                    linearization=list(enc.forced_prefix),
                    final_states=sorted(enc.init_states),
                ),
                "batch-vmap",
                0.0,
                layers=0,
            )
            continue
        try:
            frontier_list.append(init_frontier(enc, capacity, dev))
        except ValueError:
            # More initial states than lane capacity: sequential path.
            verdicts[i] = LaneVerdict(None, "batch-vmap", 0.0, skipped="init-overflow")
            continue
        tables_list.append(build_tables(enc, dev))
        live.append(i)

    if not live:
        return verdicts  # type: ignore[return-value]  (all entries set)

    max_layers = max(lanes[i].enc.total_remaining for i in live) + 2
    t0 = time.monotonic()
    outs = _mega_launch(tables_list, frontier_list, max_layers)
    wall = time.monotonic() - t0

    for i, out in zip(live, outs):
        if out.stop_code == STOP_ACCEPT:
            res: CheckResult | None = CheckResult(CheckOutcome.OK)
        elif out.stop_code == STOP_EMPTY and not out.pruned_ever:
            res = CheckResult(CheckOutcome.ILLEGAL)
        else:
            res = None  # pruned dead end / layer cap: escalate this lane
        verdicts[i] = LaneVerdict(res, "batch-vmap", wall, layers=out.layers)
    return verdicts  # type: ignore[return-value]
