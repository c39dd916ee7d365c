"""witness_ms.adv: ``harness/spans.py::witness_ms``, in the adversarial cells that decide OK."""

from gpubench.harness.spans import witness_ms as read  # noqa: F401
