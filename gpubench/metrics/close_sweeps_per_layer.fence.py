"""close_sweeps_per_layer.fence: ``harness/closes.py::close_sweeps_per_layer``, in the fencing cells."""

from gpubench.harness.closes import close_sweeps_per_layer as read  # noqa: F401
