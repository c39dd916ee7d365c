"""syncs_per_layer.msn: ``harness/readers.py::syncs_per_layer``, in the match-seq-num cells."""

from gpubench.harness.readers import syncs_per_layer as read  # noqa: F401
