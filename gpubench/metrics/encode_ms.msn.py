"""encode_ms.msn: ``harness/spans.py::encode_ms``, in the match-seq-num cells."""

from gpubench.harness.spans import encode_ms as read  # noqa: F401
