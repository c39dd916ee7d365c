"""token_closes_per_layer.fence: ``harness/closes.py::token_closes_per_layer``, in the fencing cells."""

from gpubench.harness.closes import token_closes_per_layer as read  # noqa: F401
