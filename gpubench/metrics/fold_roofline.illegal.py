"""fold_roofline.illegal: ``harness/readers.py::fold_roofline``, in the cells timed by ``device_ms_per_verdict``."""

from gpubench.harness.readers import fold_roofline as read  # noqa: F401
