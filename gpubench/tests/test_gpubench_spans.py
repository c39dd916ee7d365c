"""``harness/spans.py`` on the CPU: which of the search's spans count for
which request, and the four metrics read from them."""

from __future__ import annotations

import pytest

from gpubench.harness import spans
from gpubench.harness.record import Request, Run
from s2_verification_tpu_torch.obs.trace import Tracer


def _request(tracer: Tracer, start_s: float, end_s: float, traced: bool, outcome: str = "ok") -> Request:
    """A request decided from ``start_s`` to ``end_s`` after the tracer's
    base (prepared at ``start_s``)."""
    ns = [tracer.wall_base_ns + round(t * 1e9) for t in (start_s - 0.001, start_s, end_s)]
    return Request(pool_index=0, start=0.0, prepared=0.0, end=1.0, outcome=outcome, checked_ops=1,
                   traced=traced, spans_ns=tuple(ns))


def _span(tracer: Tracer, name: str, a_s: float, b_s: float, **args) -> None:
    base = tracer.mono_of_wall(tracer.wall_base)
    tracer.add_span(name, base + a_s, base + b_s, cat="search", args=args or None)


def _request_at(tracer: Tracer, at: float, witness_s: float) -> None:
    """One request's spans from ``at``: encode 1 ms, a segment of 10 ms
    with 2 ms of fetches over 4 layers, witness recovery of ``witness_s``."""
    _span(tracer, "check.encode", at, at + 0.001, ops=9, chains=3)
    _span(tracer, "check.segment", at + 0.001, at + 0.011, layers=4, fetch_ms=2.0, syncs=5)
    _span(tracer, "check.witness", at + 0.011, at + 0.011 + witness_s, source="research", found=True)


CASES = {
    # one request, and spans of the check that ran before it (outside its
    # window): only the request's own count
    "outside the window": (
        [(1.0, 1.2, False)], [(0.5, 0.05), (1.0, 0.1)],
        {"witness_ms": 100.0, "encode_ms": 1.0, "fetch_ms": 2.0, "host_us_per_layer": 2000.0},
    ),
    # the profiled request is left out: only the second one's spans count
    "profiled request": (
        [(1.0, 1.2, True), (2.0, 2.2, False)], [(1.0, 0.15), (2.0, 0.05)],
        {"witness_ms": 50.0, "encode_ms": 1.0, "fetch_ms": 2.0, "host_us_per_layer": 2000.0},
    ),
    # every request profiled: all of them count
    "all profiled": (
        [(1.0, 1.2, True), (2.0, 2.2, True)], [(1.0, 0.15), (2.0, 0.05)],
        {"witness_ms": 100.0, "encode_ms": 1.0, "fetch_ms": 2.0, "host_us_per_layer": 2000.0},
    ),
    # a ring that dropped spans reads nothing
    "dropped spans": (
        [(1.0, 1.2, False)], [(1.0, 0.1)] * 3,
        {"witness_ms": None, "encode_ms": None, "fetch_ms": None, "host_us_per_layer": None},
    ),
    # no span inside any request: nothing to read
    "no spans": (
        [(1.0, 1.2, False)], [(3.0, 0.1)],
        {"witness_ms": None, "encode_ms": None, "fetch_ms": None, "host_us_per_layer": None},
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_count_only_inside_unprofiled_requests(monkeypatch, case):
    requests, checks, want = CASES[case]
    tracer = Tracer(8 if case == "dropped spans" else 64)
    for at, witness_s in checks:
        _request_at(tracer, at, witness_s)
    assert bool(tracer.dropped) == (case == "dropped spans")
    run = Run(setup_s=0.0, window_s=1.0, requests=[_request(tracer, *r) for r in requests], peak_bytes=0)
    monkeypatch.setattr(spans, "_search_tracer", lambda: tracer)
    for name, value in want.items():
        got = getattr(spans, name)(run)
        assert got == (None if value is None else pytest.approx(value, rel=1e-6)), name


def test_a_program_without_the_ring_reads_nothing(monkeypatch):
    tracer = Tracer(64)
    _request_at(tracer, 1.0, 0.1)
    run = Run(setup_s=0.0, window_s=1.0, requests=[_request(tracer, 1.0, 1.2, False)], peak_bytes=0)
    monkeypatch.setattr(spans, "_search_tracer", lambda: None)
    assert spans.request_spans(run) is None and spans.witness_ms(run) is None
