"""prepare_ms.msn: ``harness/readers.py::prepare_ms``, in the match-seq-num cells."""

from gpubench.harness.readers import prepare_ms as read  # noqa: F401
