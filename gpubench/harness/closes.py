"""The auto-close's share of the layer loop, read from the search's
``check.segment`` spans.

``checker/device.py`` counts two things of its auto-close
(``_auto_close``, the sweeps that pass the ops a row can never take
before the layer expands) and puts each segment's deltas on its span:

- ``sweeps``: the sweeps made, each one host synchronisation
  (``CLOSE_SWEEPS``);
- ``token_closes``: the ops its token arm passed, an indefinite append
  whose fencing token no remaining op can set, summed on the device over
  the rows (``TOKEN_CLOSES``).

Each is read over the segments' layers, summed over the window's
unprofiled requests (``spans.py::request_spans``).  A program whose spans
lack the args, or a ring that dropped spans, reads None.
"""

from __future__ import annotations

from .record import Run
from .spans import request_spans

__all__ = ["close_sweeps_per_layer", "token_closes_per_layer"]


def _per_layer(run: Run, arg: str) -> float | None:
    got = request_spans(run)
    if got is None:
        return None
    segs = [e for _, s in got for e in s if e["name"] == "check.segment"]
    if not segs or any(arg not in (e.get("args") or {}) for e in segs):
        return None
    layers = sum(e["args"]["layers"] for e in segs)
    return sum(e["args"][arg] for e in segs) / layers if layers else None


def close_sweeps_per_layer(run: Run) -> float | None:
    """Auto-close sweeps (one synchronisation each) a layer."""
    return _per_layer(run, "sweeps")


def token_closes_per_layer(run: Run) -> float | None:
    """Ops the auto-close's token arm passed, a layer."""
    return _per_layer(run, "token_closes")
