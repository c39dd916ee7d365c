"""The search's own spans, read by the per-layer metrics of the search and
layer loop.

``checker/device.py`` records spans of each check (``check.beam``,
``check.encode``, ``check.segment``, ``check.witness`` and the others, all
``cat="search"``) into ``obs.trace.SEARCH_TRACER`` when the caller
collects statistics, which the traced run does (``window.py``:
``collect_stats=trace``).  ``Tracer.wall_ns`` puts each span on the
``time.time_ns`` clock of a request's ``spans_ns``, so a request's spans
are those that lie inside its decide time, from ``prepared`` to ``end``.

Requests under the profiler are left out (its cost would count in every
span), unless every request was profiled.  A program without the ring
gives None, and so does a ring that dropped spans: its sums would be short.
"""

from __future__ import annotations

from .record import Run

__all__ = ["request_spans", "witness_ms", "encode_ms", "fetch_ms", "host_us_per_layer"]


def _search_tracer():
    try:
        from s2_verification_tpu_torch.obs import trace
    except ImportError:
        return None
    return getattr(trace, "SEARCH_TRACER", None)


def request_spans(run: Run, tracer=None) -> list[tuple] | None:
    """``(request, spans)`` for each decided request that was not profiled
    (each decided request if none), ``spans`` being the search spans of
    ``tracer`` (``SEARCH_TRACER`` by default) inside its decide time; None
    where there is no such ring, it has no ``wall_ns``, or it dropped
    spans."""
    tracer = _search_tracer() if tracer is None else tracer
    if tracer is None or not hasattr(tracer, "wall_ns") or tracer.dropped:
        return None
    placed = [
        (*tracer.wall_ns(e), e)
        for e in tracer.export()["traceEvents"]
        if e.get("ph") == "X" and e.get("cat") == "search"
    ]
    decided = [r for r in run.requests if r.decided and len(r.spans_ns) == 3]
    out = []
    for r in [r for r in decided if not r.traced] or decided:
        _, lo, hi = r.spans_ns
        out.append((r, [e for a, b, e in placed if lo <= a and b <= hi]))
    return out if any(spans for _, spans in out) else None


def _ms(spans, name: str) -> float:
    return sum(e["dur"] for e in spans if e["name"] == name) / 1e3


def _mean(values: list) -> float | None:
    return sum(values) / len(values) if values else None


def witness_ms(run: Run) -> float | None:
    """Milliseconds of witness recovery (``check.witness``) an OK verdict."""
    got = request_spans(run)
    return None if got is None else _mean([_ms(s, "check.witness") for r, s in got if r.outcome == "ok"])


def encode_ms(run: Run) -> float | None:
    """Milliseconds of encoding and tables (``check.encode``) a request."""
    got = request_spans(run)
    return None if got is None else _mean([_ms(s, "check.encode") for _, s in got])


def _segments(spans) -> list:
    return [e for e in spans if e["name"] == "check.segment"]


def fetch_ms(run: Run) -> float | None:
    """Milliseconds a request spends inside the layer loop's counted
    synchronisations (``check.segment``'s ``fetch_ms``)."""
    got = request_spans(run)
    return None if got is None else _mean([sum(e["args"]["fetch_ms"] for e in _segments(s)) for _, s in got])


def host_us_per_layer(run: Run) -> float | None:
    """Microseconds of the layer loop's own host time a layer: the
    segments' time less their fetch waits, over their layers, summed over
    the requests."""
    got = request_spans(run)
    if got is None:
        return None
    segs = [e for _, s in got for e in _segments(s)]
    layers = sum(e["args"]["layers"] for e in segs)
    busy_us = sum(e["dur"] - 1e3 * e["args"]["fetch_ms"] for e in segs)
    return busy_us / layers if layers else None
