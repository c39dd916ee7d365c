"""fetch_ms.msn: ``harness/spans.py::fetch_ms``, in the match-seq-num cells."""

from gpubench.harness.spans import fetch_ms as read  # noqa: F401
