"""fold_roofline.adv: ``harness/readers.py::fold_roofline``, in the adversarial cells."""

from gpubench.harness.readers import fold_roofline as read  # noqa: F401
