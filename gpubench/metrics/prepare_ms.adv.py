"""prepare_ms.adv: ``harness/readers.py::prepare_ms``, in the adversarial cells."""

from gpubench.harness.readers import prepare_ms as read  # noqa: F401
