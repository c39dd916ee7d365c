"""launches_per_layer.msn: ``harness/readers.py::launches_per_layer``, in the match-seq-num cells."""

from gpubench.harness.readers import launches_per_layer as read  # noqa: F401
