"""device_idle_pct.adv: ``harness/readers.py::device_idle_pct``, in the adversarial cells."""

from gpubench.harness.readers import device_idle_pct as read  # noqa: F401
