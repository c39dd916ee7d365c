"""kernel_ms_per_verdict.adv: ``harness/readers.py::kernel_ms_per_verdict``, in the adversarial cells."""

from gpubench.harness.readers import kernel_ms_per_verdict as read  # noqa: F401
