"""syncs_per_layer.adv: ``harness/readers.py::syncs_per_layer``, in the adversarial cells."""

from gpubench.harness.readers import syncs_per_layer as read  # noqa: F401
