"""verifyd's device side: the supervised device escalation.

The part of the JAX package's ``service`` package that runs without a
daemon:

- :mod:`.supervise`  — bounded-child/checkpoint-resume wrapper for device
                       jobs (``checker/resilient.py`` +
                       ``checker/checkpoint.py``), and the child's entry
                       point; a wedged or crashed CUDA job degrades to
                       ``None`` instead of taking the caller down.
- :mod:`.devicepool` — the buddy allocator that leases power-of-two
                       blocks of cards to escalating jobs.
- :mod:`.stats`      — per-job structured events, counters and metric
                       families (lease and per-shard families included).
- :mod:`.scheduler`  — ``shape_key`` alone, the padded-search-shape key.

The daemon, queue, cache, journal, protocol, client and router are not
ported yet.  Nothing here imports ``torch``: only the supervised child
touches a card.  As in the JAX package, :mod:`.supervise` is imported by
name (it is also the child's ``-m`` entry point).
"""

from .devicepool import DeviceLease, DevicePool, lease_size_for
from .scheduler import shape_key
from .stats import ServiceStats

__all__ = [
    "DeviceLease",
    "DevicePool",
    "ServiceStats",
    "lease_size_for",
    "shape_key",
]
