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

The daemon's batcher (``service/batcher.py``) drives both engines
through their ``skip`` (a lane's cancel or deadline at the launch
boundary), ``on_lane`` (answer a native lane's client as it decides),
``progress`` (one heartbeat sink a lane), ``profile`` and ``prune``
keywords, and picks the engine with :func:`default_engine`.

The JAX launch pads its lane count to a power of two (repeating the last
lane) to bound its compile variants.  This port compiles nothing per
shape, so it launches the lanes it is given; verdicts do not depend on the
padding.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..models.encode import EncodedHistory
from .entries import History
from .native import check_native, native_available
from .oracle import CheckOutcome, CheckResult

__all__ = [
    "BatchLane",
    "LaneVerdict",
    "VMAP_LANE_CAPACITY",
    "check_batch_native",
    "check_batch_vmap",
    "default_engine",
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
    time_budget_s: float | None = None


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


def default_engine() -> str:
    """'native' when the C++ engine builds, else 'vmap'."""
    return "native" if native_available() else "vmap"


def check_batch_native(
    lanes: list[BatchLane],
    skip=None,
    profile: bool = False,
    on_lane=None,
    progress=None,
    prune: bool = False,
) -> list[LaneVerdict]:
    """Run each lane through the native engine without re-encoding.

    ``skip(i)`` is consulted immediately before lane *i* dispatches and
    returns a reason string to skip it (cancelled / deadline passed) or
    ``None`` to run it.  ``on_lane(i, verdict)`` fires the moment lane *i*
    decides, while later lanes are still to run.  ``progress`` is an
    optional per-lane sequence of :class:`.progress.ProgressSink` (or
    ``None``): the C call blocks, so each lane offers a baseline before its
    search and a final sample after it.
    """
    out: list[LaneVerdict] = []
    for i, lane in enumerate(lanes):
        sink = progress[i] if progress is not None else None
        reason = skip(i) if skip is not None else None
        if reason is not None:
            v = LaneVerdict(None, "batch-native", 0.0, skipped=reason)
        else:
            total = len(lane.history.ops)
            if sink is not None:
                sink.update(ops_committed=0, total_ops=total, engine="batch-native")
            t0 = time.monotonic()
            res = check_native(
                lane.history,
                time_budget_s=lane.time_budget_s,
                profile=profile,
                enc=lane.enc,
                prune=prune,
            )
            v = LaneVerdict(res, "batch-native", time.monotonic() - t0)
            if sink is not None:
                done = res.linearization if res.outcome == CheckOutcome.OK else res.deepest
                sink.update(
                    ops_committed=len(done or []),
                    total_ops=total,
                    states_expanded=res.steps,
                    engine="batch-native",
                    final=True,
                )
        out.append(v)
        if on_lane is not None:
            on_lane(i, v)
    return out


def _mega_launch(tables, frontiers, max_layers):
    """The launch group's one lane-batched search (the JAX engine's
    ``jit(vmap(run_search))`` with ``allow_prune=True``)."""
    from .device import run_search_lanes

    return run_search_lanes(tables, frontiers, max_layers)


def check_batch_vmap(
    lanes: list[BatchLane],
    skip=None,
    capacity: int = VMAP_LANE_CAPACITY,
    progress=None,
    prune: bool = False,
    device=None,
) -> list[LaneVerdict]:
    """One lane-batched frontier search over the whole launch group.

    Lanes must come from one :func:`..models.encode.encode_batch` call
    (shape-identical arrays).  Per-lane verdicts follow the beam soundness
    rules; undecidable lanes return ``result=None``.  ``device`` is the
    search's device, CUDA unless the caller names another
    (:func:`.device.resolve_device`).

    ``skip`` and ``progress`` are as in :func:`check_batch_native`; the
    whole group is one launch, so each live lane's sink gets a baseline
    before it and a final sample after, with the lane's own latched layer
    count.  ``prune`` builds each lane's tables with the verdict-exact
    prune rules (:func:`.device.build_tables`).

    Only this engine loads torch (and the device search), when it is
    called: a native batching daemon never does.
    """
    from .device import STOP_ACCEPT, STOP_EMPTY, build_tables, init_frontier, resolve_device

    dev = resolve_device(device)
    n = len(lanes)
    verdicts: list[LaneVerdict | None] = [None] * n
    live: list[int] = []
    tables_list = []
    frontier_list = []
    for i, lane in enumerate(lanes):
        reason = skip(i) if skip is not None else None
        if reason is not None:
            verdicts[i] = LaneVerdict(None, "batch-vmap", 0.0, skipped=reason)
            continue
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
        tables_list.append(build_tables(enc, dev, prune=prune))
        live.append(i)

    if not live:
        return verdicts  # type: ignore[return-value]  (all entries set)

    max_layers = max(lanes[i].enc.total_remaining for i in live) + 2
    if progress is not None:
        for i in live:
            if progress[i] is not None:
                progress[i].update(ops_committed=0, total_ops=len(lanes[i].history.ops), engine="batch-vmap")
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
        sink = progress[i] if progress is not None else None
        if sink is not None:
            total = len(lanes[i].history.ops)
            sink.update(
                ops_committed=total if out.stop_code == STOP_ACCEPT else 0,
                total_ops=total,
                layer=out.layers,
                engine="batch-vmap",
                final=True,
            )
    return verdicts  # type: ignore[return-value]
