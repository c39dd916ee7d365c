"""The layer expansions replayed from CUDA graphs, read from the search's
``check.segment`` spans.

``checker/device.py`` replays a layer's expansion from a captured CUDA
graph where the frontier is small and its key has expanded eagerly often
enough in the segment, and puts each segment's deltas on its span:
``captures`` (graphs captured, ``GRAPH_CAPTURES``) and ``graph_layers``
(layers whose expansion was replayed, ``GRAPH_REPLAYS``).  The metric is
``graph_layers`` over the segments' layers, summed over the window's
unprofiled requests (``spans.py::request_spans``).  A program whose spans
lack the arg, or a ring that dropped spans, reads None.
"""

from __future__ import annotations

from .closes import _per_layer
from .record import Run

__all__ = ["graph_replays_per_layer"]


def graph_replays_per_layer(run: Run) -> float | None:
    """Layer expansions replayed from a CUDA graph, a layer."""
    return _per_layer(run, "graph_layers")
