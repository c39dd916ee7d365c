"""The layer expansion replayed from a CUDA graph (``checker/device.py``:
``_LayerGraph``, ``_graph_engages``, ``_capture_graph``).

The CPU has no CUDA graphs and never takes one (the rule says so), so the
plumbing around the capture runs here through a stand-in for it that
re-runs the expansion over the same static input buffers and writes its
results into the first run's output buffers, as a replay does.  A check
through that plumbing must equal the eager check in everything: the
verdict, the statistics, every segment's ``RunOut`` and frontier arrays,
the witness and the synchronisations, also where a segment stops after
replays on a capacity or an empty stop (which keep the pre-expansion
frontier) and with the witness log.  The histories come from the
benchmark's generator (``msn.5x200`` and ``fencing.8x500`` cut to fewer
ops) and the collector's ``fence-resurrect`` campaign.

The adversarial cells' histories must never reach the threshold: they run
fewer than ``_GRAPH_AFTER`` expansions in every bucket up to
``_GRAPH_MAX_ROWS`` rows, in both phases.

The tests marked ``cuda`` run the replayed and the eager search on the
card, bit for bit, at the cells' own sizes and in a 4,096-row bucket, and
read the adversarial cells' ``check.segment`` spans there: no capture, no
replayed layer.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from gpubench.harness.spec import load_cell
from s2_verification_tpu_torch.checker import device as dev_mod
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.collector.campaign import collect_labeled, get_campaign
from s2_verification_tpu_torch.foldbench import recording_folds
from s2_verification_tpu_torch.obs.trace import Tracer
from s2_verification_tpu_torch.ops import fold_cuda
from s2_verification_tpu_torch.utils import events as ev

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


# --- (a) the rule -----------------------------------------------------------


@pytest.mark.parametrize(
    "device, rows, chunked, eager, want",
    [
        (CUDA, 16, False, dev_mod._GRAPH_AFTER, True),
        (CUDA, dev_mod._GRAPH_MAX_ROWS, False, 500, True),
        (CUDA, 16, False, dev_mod._GRAPH_AFTER - 1, False),
        (CUDA, 16, False, 0, False),
        (CUDA, 2 * dev_mod._GRAPH_MAX_ROWS, False, 500, False),
        (CUDA, 1 << 20, False, 500, False),
        (CUDA, 16, True, 500, False),
        (CUDA, dev_mod._GRAPH_MAX_ROWS, True, 500, False),
        (CPU, 16, False, 500, False),
        (CPU, 16, False, dev_mod._GRAPH_AFTER, False),
    ],
)
def test_the_graph_engages_on_cuda_for_small_unchunked_unsharded_buckets_after_the_eager_runs(
    device, rows, chunked, eager, want
):
    assert dev_mod._graph_engages(device, rows, chunked=chunked, eager=eager) is want


def test_the_thresholds_are_the_stated_ones():
    assert (dev_mod._GRAPH_MAX_ROWS, dev_mod._GRAPH_AFTER) == (4096, 8)


def test_a_cpu_check_captures_nothing():
    hist = prepare(list(ev.iter_history(_collected("msn.5x200", 40, 5))), elide_trivial=True)
    c0, r0 = dev_mod.GRAPH_CAPTURES[0], dev_mod.GRAPH_REPLAYS[0]
    assert dev_mod.check_device_auto(hist, device="cpu").ok
    assert (dev_mod.GRAPH_CAPTURES[0], dev_mod.GRAPH_REPLAYS[0]) == (c0, r0)


def test_a_graph_takes_its_streams_fold_scratch_for_its_own(monkeypatch):
    scratch = {(1, 0, 11): ("c11", "l11"), (1, 0, 12): ("c12", "l12"), (2, 0, 11): ("c", "l")}
    monkeypatch.setattr(fold_cuda, "_scratch", dict(scratch))
    assert sorted(fold_cuda.take_scratch(11)) == [("c", "l"), ("c11", "l11")]
    assert fold_cuda._scratch == {(1, 0, 12): ("c12", "l12")}
    assert fold_cuda.take_scratch(11) == []


# --- (b) the adversarial cells stay eager -----------------------------------


class _Past(Exception):
    """A segment was asked of a bucket wider than the graphs' cap."""


@pytest.mark.parametrize(
    "events",
    [
        pytest.param(dict(k=10, batch=100, applied=5, seed=3), id="k10-ok"),
        pytest.param(dict(k=9, batch=100, unsatisfiable=True, seed=3), id="k9-illegal"),
    ],
)
@pytest.mark.parametrize("beam", [True, False], ids=["beam", "exhaustive"])
def test_the_adversarial_cells_expand_fewer_than_the_threshold_in_every_small_bucket(monkeypatch, events, beam):
    """Each phase of ``check_device_auto`` (its keywords for the phase), up
    to the first segment in a bucket over the cap: no bucket of at most
    ``_GRAPH_MAX_ROWS`` rows reaches ``_GRAPH_AFTER`` expansions."""
    hist = prepare(adversarial_events(**events))
    per_bucket: dict[int, int] = {}
    expand, run_search = dev_mod._expand_layer, dev_mod.run_search

    def counted(tables, fr, **kw):
        per_bucket[fr.capacity] = per_bucket.get(fr.capacity, 0) + 1
        return expand(tables, fr, **kw)

    def capped(tables, frontier, *a, **kw):
        if frontier.capacity > dev_mod._GRAPH_MAX_ROWS:
            raise _Past
        return run_search(tables, frontier, *a, **kw)

    monkeypatch.setattr(dev_mod, "_expand_layer", counted)
    monkeypatch.setattr(dev_mod, "run_search", capped)
    kw = dict(max_frontier=65536, beam=True) if beam else dict(max_frontier=1 << 20, beam=False, device_rows_cap=1 << 23)
    with pytest.raises(_Past):
        dev_mod.check_device(hist, device="cpu", **kw)
    assert per_bucket and all(b <= dev_mod._GRAPH_MAX_ROWS for b in per_bucket)
    assert max(per_bucket.values()) < dev_mod._GRAPH_AFTER, per_bucket


# --- (c) the plumbing, through a stand-in for the capture -------------------


def _rerun_capture(body, device):
    """The capture's stand-in: the first run's outputs are the graph's
    output buffers; a replay runs ``body`` again over the same static
    inputs and writes its results into them."""
    outputs = body()

    def replay():
        for x, y in zip(outputs, body()):
            x.copy_(y)

    return outputs, replay


@functools.lru_cache(maxsize=None)
def _collected(cell: str, ops: int, structure: int) -> str:
    c = load_cell(cell)
    return c.make(c.params(num_ops_per_client=ops), 7, structure)


def _resurrect() -> str:
    events, label = collect_labeled(get_campaign("fence-resurrect"), seed=11)
    assert label["expect"] == "illegal"
    return "".join(ev.encode_event(le) + "\n" for le in events)


def _host(out: dev_mod.RunOut, replays: int) -> dict:
    """A segment's ``RunOut`` as host values, read as it returns."""
    d = out._asdict()
    d["frontier"] = [x.cpu().numpy().tolist() for x in out.frontier]
    d["deep_counts"] = out.deep_counts.cpu().numpy().tolist()
    if out.wlog is not None:
        d["wlog"] = [[np.asarray(a).tolist() for a in entry] for entry in out.wlog]
    d["replays"] = replays
    return d


def _check(monkeypatch, text: str, replayed: bool, auto: bool, **kw):
    """Decide ``text`` eagerly or through the stand-in; the result's
    fields, each segment (``_host``), the syncs and the captures."""
    if replayed:
        rule = dev_mod._graph_engages
        monkeypatch.setattr(dev_mod, "_capture_graph", _rerun_capture)
        monkeypatch.setattr(dev_mod, "_graph_engages", lambda device, *a, **k: rule(CUDA, *a, **k))
    segments = []
    run_search = dev_mod.run_search

    def recorded(*a, **k):
        r0 = dev_mod.GRAPH_REPLAYS[0]
        out = run_search(*a, **k)
        segments.append(_host(out, dev_mod.GRAPH_REPLAYS[0] - r0))
        return out

    monkeypatch.setattr(dev_mod, "run_search", recorded)
    hist = prepare(list(ev.iter_history(text)), elide_trivial=True)
    s0, c0 = dev_mod.SYNCS[0], dev_mod.GRAPH_CAPTURES[0]
    check = dev_mod.check_device_auto if auto else dev_mod.check_device
    res = check(hist, device="cpu", collect_stats=True, **kw)
    monkeypatch.undo()
    got = dict(
        outcome=res.outcome, linearization=res.linearization, final_states=res.final_states,
        deepest=res.deepest, refusals=res.refusals, stats=dataclasses.asdict(res.stats),
    )
    return got, segments, dev_mod.SYNCS[0] - s0, dev_mod.GRAPH_CAPTURES[0] - c0


#: a history, whether it goes through ``check_device_auto`` (else one
#: exhaustive ``check_device``), its keywords, and the stop that must come
#: after replays in some segment (None: the last segment accepts)
CASES = {
    "msn": (("msn.5x200", 40, 5), True, {}, None),
    "msn, witness log": (("msn.5x200", 40, 5), True, {"witness_max_frontier": 16}, None),
    "fencing": (("fencing.8x500", 120, 0), True, {}, None),
    # a 2-row bucket that overflows after hundreds of replays
    "fencing, capacity stop": (("fencing.8x500", 120, 3), False, {"start_frontier": 2, "max_frontier": 1 << 20},
                               dev_mod.STOP_CAPACITY),
    "fencing, capacity stop, witness log": (
        ("fencing.8x500", 120, 1), False,
        {"start_frontier": 2, "max_frontier": 1 << 20, "witness_max_frontier": 64}, dev_mod.STOP_CAPACITY),
    # a fenced-out writer's accepted append: ILLEGAL on an empty stop
    "fence-resurrect, empty stop": (None, True, {}, dev_mod.STOP_EMPTY),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_check_through_the_replay_plumbing_equals_the_eager_check(monkeypatch, case):
    source, auto, kw, stop_after_replays = CASES[case]
    text = _resurrect() if source is None else _collected(*source)
    eager, eager_segments, eager_syncs, eager_captures = _check(monkeypatch, text, False, auto, **kw)
    got, segments, syncs, captures = _check(monkeypatch, text, True, auto, **kw)
    assert eager_captures == 0 and all(s["replays"] == 0 for s in eager_segments)
    assert captures >= 1 and sum(s["replays"] for s in segments) > 0
    assert got == eager
    assert syncs == eager_syncs
    assert [{k: v for k, v in s.items() if k != "replays"} for s in segments] == [
        {k: v for k, v in s.items() if k != "replays"} for s in eager_segments
    ]
    if stop_after_replays is not None:
        assert any(s["stop_code"] == stop_after_replays and s["replays"] > 0 for s in segments)
    if "witness_max_frontier" in kw:
        assert any(s["wlog"] and s["replays"] > 0 for s in segments)


# --- on the card ------------------------------------------------------------

#: a history, the keywords of ``check_device`` (else ``check_device_auto``
#: runs), and whether layers must replay
CARD_CASES = {
    "msn.5x200 structure 0": (("msn.5x200", 0), None, True),
    "fencing.8x500 structure 2": (("fencing.8x500", 2), None, True),
    # 4,096-row layers: the fold runs its multi-block launch (a scan and a
    # dependent fold) inside the graph, on the capture stream's scratch
    "msn.5x200 structure 0, 4,096-row bucket": (("msn.5x200", 0), {"start_frontier": 4096, "max_frontier": 4096,
                                                                  "beam": True}, True),
    "adversarial k=8": (dict(k=8, batch=100, applied=4, seed=5), None, False),
}


def _card_events(source) -> list:
    if isinstance(source, dict):
        return adversarial_events(**source)
    c = load_cell(source[0])
    return list(ev.iter_history(c.make(c.params(), 2**31 + 17, source[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_the_replayed_search_is_bit_exact_with_the_eager_one_on_card(monkeypatch, name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the fold kernel have no CPU mode")
    source, kw, replays_expected = CARD_CASES[name]
    hist = prepare(_card_events(source), elide_trivial=True)

    def decide(graphs: bool):
        if not graphs:
            monkeypatch.setattr(dev_mod, "_graph_engages", lambda *a, **k: False)
        segments = []
        run_search = dev_mod.run_search

        def recorded(*a, **k):
            out = run_search(*a, **k)
            segments.append(_host(out, 0))
            return out

        monkeypatch.setattr(dev_mod, "run_search", recorded)
        s0, r0 = dev_mod.SYNCS[0], dev_mod.GRAPH_REPLAYS[0]
        n0, c0 = fold_cuda.LAUNCHES["fold_lanes"], dev_mod.GRAPH_CAPTURES[0]
        with recording_folds(dev_mod) as calls:
            if kw is None:
                res = dev_mod.check_device_auto(hist, device="cuda", collect_stats=True)
            else:
                res = dev_mod.check_device(hist, device="cuda", collect_stats=True, **kw)
            torch.cuda.synchronize()
        monkeypatch.undo()
        got = dict(outcome=res.outcome, linearization=res.linearization, final_states=res.final_states,
                   deepest=res.deepest, refusals=res.refusals, stats=dataclasses.asdict(res.stats))
        folds = (fold_cuda.LAUNCHES["fold_lanes"] - n0, len(calls), dev_mod.GRAPH_CAPTURES[0] - c0)
        return got, segments, dev_mod.SYNCS[0] - s0, dev_mod.GRAPH_REPLAYS[0] - r0, folds

    eager, eager_segments, eager_syncs, eager_replays, (eager_launches, eager_recorded, _) = decide(False)
    got, segments, syncs, replays, (launches, recorded, captures) = decide(True)
    assert eager_replays == 0
    assert (replays > 0) is replays_expected
    assert got == eager and segments == eager_segments and syncs == eager_syncs
    # The same folds launch, each replay counting and handing to the
    # recorder the one its graph holds, and a graph's warm-up once more.
    assert eager_recorded == eager_launches and recorded == launches
    assert launches == eager_launches + captures
    assert got["outcome"].value == "ok"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "events",
    [
        pytest.param(dict(k=10, batch=100, applied=5, seed=3), id="k10-ok"),
        pytest.param(dict(k=9, batch=100, unsatisfiable=True, seed=3), id="k9-illegal"),
    ],
)
def test_the_adversarial_cells_segments_capture_and_replay_nothing_on_card(monkeypatch, events):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    ring = Tracer(4096)
    monkeypatch.setattr(dev_mod, "SEARCH_TRACER", ring)
    res = dev_mod.check_device_auto(prepare(adversarial_events(**events)), device="cuda", collect_stats=True)
    assert res.outcome.value == ("illegal" if events.get("unsatisfiable") else "ok")
    segments = [e["args"] for e in ring.export()["traceEvents"] if e["ph"] == "X" and e["name"] == "check.segment"]
    assert segments and all(s["captures"] == 0 and s["graph_layers"] == 0 for s in segments)
