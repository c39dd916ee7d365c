"""The device check's own spans (``checker/device.py``), on the CPU.

A check records its spans where the thread's job context holds an enabled
tracer, else into ``obs.trace.SEARCH_TRACER`` when the caller collects
statistics, else nowhere; recording them changes no verdict, witness or
synchronisation count.  ``Tracer.wall_ns`` puts them on the clock of
``torch.profiler``'s events, which ``breakdown.idle_gaps`` relies on.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from s2_verification_tpu_torch import breakdown
from s2_verification_tpu_torch.checker import device as dev_mod
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.obs.introspect import job_context
from s2_verification_tpu_torch.obs.trace import Tracer
from s2_verification_tpu_torch.utils import hashing

PHASES = ("check.beam", "check.exhaustive")

#: a history, the keywords of ``check_device_auto``, and the spans it must
#: record (beyond ``check.beam``, ``check.encode`` and ``check.segment``)
CASES = {
    "ok": (dict(k=5, batch=10, seed=3), {}, {"check.witness", "check.final_states"}),
    # the beam of 4 rows prunes, concedes, and the exhaustive phase decides
    "illegal": (dict(k=5, batch=10, seed=3, unsatisfiable=True), {"beam_width": 4},
                {"check.exhaustive", "check.diagnose"}),
    # a beam of 16 rows starts at its cap, so nothing escalates; the
    # witness log decides the witness
    "ok, witness log": (dict(k=4, batch=10, seed=1), {"beam_width": 16, "witness_max_frontier": 16},
                        {"check.witness", "check.final_states"}),
}


@pytest.fixture
def ring(monkeypatch):
    """A fresh ``SEARCH_TRACER`` for the test."""
    t = Tracer(4096)
    monkeypatch.setattr(dev_mod, "SEARCH_TRACER", t)
    return t


def _spans(t: Tracer) -> list[dict]:
    return [e for e in t.export()["traceEvents"] if e["ph"] == "X"]


def _inside(e: dict, outer: dict) -> bool:
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-3


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_check_records_its_spans_inside_its_phases(ring, case, monkeypatch):
    events, kw, want = CASES[case]
    hist = prepare(adversarial_events(**events))
    syncs0 = dev_mod.SYNCS[0]
    off = dev_mod.check_device_auto(hist, device="cpu", **kw)
    syncs_off = dev_mod.SYNCS[0] - syncs0
    assert _spans(ring) == []
    # the host folds each witness function makes natively, in the spans-on run
    witness_folds = []
    for name in ("_witness_linearization", "_recover_witness_bounded"):
        def counted(*a, _real=getattr(dev_mod, name), **k):
            n0 = hashing.NATIVE_FOLDS[0]
            try:
                return _real(*a, **k)
            finally:
                witness_folds.append(hashing.NATIVE_FOLDS[0] - n0)

        monkeypatch.setattr(dev_mod, name, counted)
    t0 = ring.now()
    syncs0 = dev_mod.SYNCS[0]
    on = dev_mod.check_device_auto(hist, device="cpu", collect_stats=True, **kw)
    t1 = ring.now()
    assert dev_mod.SYNCS[0] - syncs0 == syncs_off
    assert (on.outcome, on.linearization, on.final_states) == (off.outcome, off.linearization, off.final_states)
    assert (on.deepest, on.refusals) == (off.deepest, off.refusals)
    spans = _spans(ring)
    names = {e["name"] for e in spans}
    assert {"check.beam", "check.encode", "check.segment"} | want <= names
    assert all(e["cat"] == "search" and e["tid"] == 0 for e in spans)
    phases = [e for e in spans if e["name"] in PHASES]
    assert [e["name"] for e in phases] == ["check.beam", "check.exhaustive"][: len(phases)]
    assert phases[-1]["args"]["outcome"] == on.outcome.value
    assert sum(e["args"]["layers"] for e in phases) >= on.stats.layers
    for e in phases:
        assert ring.us(t0) <= e["ts"] and e["ts"] + e["dur"] <= ring.us(t1)
    for e in spans:
        if e["name"] not in PHASES:
            assert sum(_inside(e, p) for p in phases) == 1, e
    # the last phase's segments add up to the layers and syncs the search counted
    last = [e for e in spans if e["name"] == "check.segment" and _inside(e, phases[-1])]
    assert sum(e["args"]["layers"] for e in last) == phases[-1]["args"]["layers"]
    assert all(e["args"]["fetch_ms"] >= 0 and e["args"]["syncs"] >= 1 for e in last)
    assert sum(e["args"]["syncs"] for e in last) <= on.stats.host_syncs
    # the CPU replays no layer from a graph, and every segment says so
    segments = [e["args"] for e in spans if e["name"] == "check.segment"]
    assert all(s["captures"] == 0 and s["graph_layers"] == 0 for s in segments)
    if "check.witness" in want:
        (w,) = [e for e in spans if e["name"] == "check.witness"]
        assert sum(witness_folds) > 0
        assert w["args"] == {"source": "log" if "witness_max_frontier" in kw else "research", "found": True,
                             "native_folds": sum(witness_folds)}
    if "check.diagnose" in want:
        d = [e for e in spans if e["name"] == "check.diagnose"]
        assert d[-1]["args"]["refusals"] == len(on.refusals)


@pytest.mark.parametrize("where", ["no statistics, no job", "job context", "disabled job tracer"])
def test_spans_go_to_the_job_context_or_nowhere(ring, where):
    hist = prepare(adversarial_events(4, batch=10, seed=2))
    job = Tracer(1024 if where == "job context" else 0)
    collect = where != "no statistics, no job"
    if where == "no statistics, no job":
        dev_mod.check_device_auto(hist, device="cpu")
    else:
        with job_context(job=7, tracer=job):
            dev_mod.check_device_auto(hist, device="cpu", collect_stats=collect)
    got = {"ring": _spans(ring), "job": _spans(job)}
    if where == "job context":
        assert got["ring"] == [] and got["job"] and all(e["tid"] == 7 for e in got["job"])
    elif where == "disabled job tracer":
        # a disabled job tracer is no tracer: statistics send the spans to the ring
        assert got["job"] == [] and got["ring"]
    else:
        assert got == {"ring": [], "job": []}


def test_wall_ns_agrees_with_the_profiler():
    t = Tracer(16)
    x = torch.ones(4096)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("outer", cat="search"):
            time.sleep(0.002)
            x.add_(1)
            time.sleep(0.002)
    (span,) = _spans(t)
    a, b = t.wall_ns(span)
    assert b - a == pytest.approx(span["dur"] * 1e3, abs=1)
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add_"]
    assert ops
    # the op starts at least 2 ms after the span does and 2 ms before its
    # end: on one clock to within 1 ms
    for e in ops:
        assert a + 1_000_000 <= e.start_ns() <= b - 1_000_000


def _device_op(start_ns: int, dur_ns: int):
    return SimpleNamespace(
        device_type=lambda: torch.autograd.DeviceType.CUDA,
        start_ns=lambda: start_ns,
        duration_ns=lambda: dur_ns,
    )


def test_breakdown_names_each_idle_gap_by_the_innermost_span():
    t = Tracer(16)
    base = t.mono_of_wall(t.wall_base)
    t.add_span("check.beam", base + 0.0, base + 1.0, cat="search")
    t.add_span("check.segment", base + 0.1, base + 0.5, cat="search")
    t.add_span("check.witness", base + 0.5, base + 0.9, cat="search")
    w0 = t.wall_base_ns
    t.add_span("before", base - 0.5, base - 0.1, cat="search")
    ms = 1_000_000
    spans = breakdown.search_spans(w0, w0 + 1200 * ms, tracer=t)
    assert sorted(name for _, _, name in spans) == ["check.beam", "check.segment", "check.witness"]
    # the device busy 0.05-0.3, 0.45-0.55 and 0.95-1.1 s of a 0-1.2 s window
    ops = [_device_op(w0 + a * ms, (b - a) * ms) for a, b in ((50, 300), (450, 550), (950, 1100))]
    gaps = breakdown.idle_gaps(ops, w0, w0 + 1200 * ms, spans)
    assert [name for name, _ in gaps] == ["check.witness", "check.segment", "outside the check", "check.beam"]
    assert [s for _, s in gaps] == pytest.approx([0.4, 0.15, 0.1, 0.05])
