"""The scheduler's padded-search-shape key.

The port has only ``shape_key`` of the JAX package's ``service/
scheduler.py`` (:44-55): the supervised child attributes its builds to it
and the device pool sizes leases by it.  The worker pool and the per-job
policy come with the daemon.
"""

from __future__ import annotations

from ..checker.entries import History
from ..models.encode import _bucket_chains, _bucket_len, round_pow2
from ..models.stream import APPEND

__all__ = ["shape_key"]


def shape_key(hist: History) -> str:
    """Padded-search-shape key of a prepared history: ops × chains ×
    record-batch width, each through the encoder's bucketing rule — two
    histories with equal keys reach search tables of the same shape."""
    width = max(
        (len(op.inp.record_hashes) for op in hist.ops if op.inp.input_type == APPEND),
        default=1,
    )
    return (
        f"{round_pow2(max(1, len(hist.ops)))}x"
        f"{_bucket_chains(len(hist.chains))}x{_bucket_len(max(1, width))}"
    )
