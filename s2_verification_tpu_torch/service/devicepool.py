"""Device-lease allocator: verifyd's multi-card placement policy.

The port's own copy of the JAX package's ``service/devicepool.py``, with the
same buddy policy and the same lease events; ``tests/test_torch_devicepool.py``
runs both side by side.

The device search shards its frontier over a :class:`~..parallel.
distributed.FrontierMesh` (``check_device(mesh=)``).  The pool turns the
visible cards into a schedulable resource: escalating jobs lease a
**power-of-two contiguous block** of device slots sized by the job's
padded search shape (the scheduler's ``shape_key``), run their sharded
search on exactly those cards, and return them.

Design notes:

- The pool tracks *slot indices* (offsets into the supervised child's
  visible cards, ``cuda:0`` … ``cuda:N-1``), never device objects — the
  supervising process never imports ``torch`` nor creates a CUDA context
  (``checker/resilient.py``); only the supervised child resolves indices
  to devices (``service/supervise.py``).
- Blocks are power-of-two sized and **aligned** (``base % size == 0``),
  the buddy-allocator invariant: any two grants are either disjoint or
  nested, so frees never fragment the pool below its largest grantable
  block.
- ``acquire`` blocks under contention (a shared daemon queues escalations
  rather than failing them) with an optional timeout; a timed-out caller
  falls back to the single-card path rather than erroring the job.
- Every grant/release/timeout is one :class:`~.stats.ServiceStats` event,
  so lease accounting rides the same stream as every other daemon fact
  (JSONL sink, ``stats`` op, /metrics — they can never disagree).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

__all__ = ["DeviceLease", "DevicePool", "lease_size_for"]


def _floor_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def lease_size_for(shape: str, total: int) -> int:
    """Chips a job of padded search shape ``shape`` should lease.

    ``shape`` is the scheduler's ``shape_key`` — ``"{ops}x{chains}x{width}"``
    with every factor already bucketed (``models/encode.py``).  The policy
    keys on the two factors that drive frontier width (the sharded axis):
    concurrency (chains ≈ k) fans the frontier out per layer, and history
    length sets how many layers the fan-out compounds over.  Thresholds
    follow the measured regimes (BASELINE.md): k≈10 peaks past 4·10^5 rows
    (8-chip territory), k in the high single digits peaks in the 10^4s
    (4), small-k long histories still outgrow one chip's comfort (2), and
    everything below stays single-chip — escalation is already the slow
    path, so tiny jobs must not queue behind an 8-chip grant.

    The result is clamped to the largest power of two ≤ ``total`` and is
    always ≥ 1, so a 1-device pool degenerates to today's behavior.
    """
    try:
        ops_s, chains_s, _ = shape.split("x", 2)
        ops, chains = int(ops_s), int(chains_s)
    except (ValueError, AttributeError):
        ops, chains = 1, 1
    if chains >= 12 or ops >= 1024:
        want = 8
    elif chains >= 8 or ops >= 256:
        want = 4
    elif chains >= 4 or ops >= 64:
        want = 2
    else:
        want = 1
    return max(1, min(want, _floor_pow2(max(1, total))))


@dataclass
class DeviceLease:
    """A granted block of device slots.  ``indices`` are offsets into the
    supervised child's visible cards; contiguous and ``size``-aligned."""

    indices: tuple[int, ...]
    job: int | None = None
    shape: str | None = None
    t_granted: float = field(default_factory=time.monotonic)

    @property
    def size(self) -> int:
        return len(self.indices)


class DevicePool:
    """Blocking buddy-style allocator over ``total`` device slots."""

    def __init__(self, total: int, *, stats=None) -> None:
        if total < 1:
            raise ValueError(f"device pool needs >= 1 device, got {total}")
        self.total = int(total)
        self.stats = stats
        self._free = [True] * self.total
        self._cond = threading.Condition()
        self._granted = 0  # lifetime grants (pool-local; stats has counters)
        self._waiters = 0

    # -- policy -------------------------------------------------------------

    def size_for(self, shape: str | None) -> int:
        return lease_size_for(shape or "", self.total)

    # -- allocation ---------------------------------------------------------

    def _find_block(self, size: int) -> int | None:
        # Aligned first-fit: alignment is the buddy invariant that keeps
        # frees coalescible without a merge pass.
        for base in range(0, self.total - size + 1, size):
            if all(self._free[base : base + size]):
                return base
        return None

    def acquire(
        self,
        *,
        shape: str | None = None,
        size: int | None = None,
        job: int | None = None,
        timeout_s: float | None = None,
    ) -> DeviceLease | None:
        """Lease a block (``size`` explicit, else sized from ``shape``).

        Blocks while the pool is too busy; returns ``None`` only when
        ``timeout_s`` elapses first — the caller's signal to run the
        escalation unsharded rather than fail the job.
        """
        size = size if size is not None else self.size_for(shape)
        size = max(1, min(_floor_pow2(size), _floor_pow2(self.total)))
        t0 = time.monotonic()
        deadline = t0 + timeout_s if timeout_s is not None else None
        with self._cond:
            self._waiters += 1
            try:
                while True:
                    base = self._find_block(size)
                    if base is not None:
                        for i in range(base, base + size):
                            self._free[i] = False
                        self._granted += 1
                        lease = DeviceLease(
                            indices=tuple(range(base, base + size)),
                            job=job,
                            shape=shape,
                        )
                        break
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            if self.stats is not None:
                                self.stats.emit(
                                    "lease_timeout",
                                    job=job,
                                    size=size,
                                    wait_s=round(time.monotonic() - t0, 4),
                                )
                            return None
                    self._cond.wait(timeout=remaining)
            finally:
                self._waiters -= 1
            in_use = self.total - sum(self._free)
        if self.stats is not None:
            self.stats.emit(
                "lease_grant",
                job=job,
                shape=shape,
                size=size,
                devices=list(lease.indices),
                wait_s=round(time.monotonic() - t0, 4),
                in_use=in_use,
            )
        return lease

    def release(self, lease: DeviceLease) -> None:
        with self._cond:
            for i in lease.indices:
                if self._free[i]:
                    raise ValueError(f"double release of device slot {i}")
                self._free[i] = True
            in_use = self.total - sum(self._free)
            self._cond.notify_all()
        if self.stats is not None:
            self.stats.emit(
                "lease_release",
                job=lease.job,
                size=lease.size,
                held_s=round(time.monotonic() - lease.t_granted, 4),
                in_use=in_use,
            )

    # -- introspection ------------------------------------------------------

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "total": self.total,
                "in_use": self.total - sum(self._free),
                "waiters": self._waiters,
                "granted": self._granted,
            }
