"""graph_replays_per_layer.msn: ``harness/graphs.py::graph_replays_per_layer``, in the match-seq-num cells."""

from gpubench.harness.graphs import graph_replays_per_layer as read  # noqa: F401
