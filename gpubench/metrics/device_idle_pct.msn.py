"""device_idle_pct.msn: ``harness/readers.py::device_idle_pct``, in the match-seq-num cells."""

from gpubench.harness.readers import device_idle_pct as read  # noqa: F401
