"""host_us_per_layer.msn: ``harness/spans.py::host_us_per_layer``, in the match-seq-num cells."""

from gpubench.harness.spans import host_us_per_layer as read  # noqa: F401
