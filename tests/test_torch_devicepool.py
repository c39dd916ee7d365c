"""Device-lease allocator (service/devicepool.py) in the port, beside the
JAX package's: ``tests/test_devicepool.py`` run over both packages' pools
and ``ServiceStats`` — sizing policy, buddy alignment, blocking
contention, timeout fallback, and the lease event stream with its metric
families.  Pure threading — no torch, no jax, no daemon."""

from __future__ import annotations

import importlib
import io
import json
import threading
import time
from types import SimpleNamespace

import pytest

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return SimpleNamespace(
        devicepool=importlib.import_module(f"{request.param}.service.devicepool"),
        stats=importlib.import_module(f"{request.param}.service.stats"),
    )


# -- sizing policy -----------------------------------------------------------


@pytest.mark.parametrize(
    "shape,total,want",
    [
        # small jobs stay single-chip (escalation is already the slow path)
        ("16x2x8", 8, 1),
        ("32x3x8", 8, 1),
        # chains >= 4 or ops >= 64 -> 2
        ("16x4x8", 8, 2),
        ("64x2x8", 8, 2),
        # chains >= 8 or ops >= 256 -> 4
        ("64x8x8", 8, 4),
        ("256x2x8", 8, 4),
        # chains >= 12 or ops >= 1024 -> 8
        ("64x12x8", 8, 8),
        ("1024x2x8", 8, 8),
        # clamped to the largest power of two <= total
        ("1024x12x8", 4, 4),
        ("1024x12x8", 6, 4),
        ("1024x12x8", 1, 1),
        # malformed shapes degrade to 1, never raise
        ("", 8, 1),
        ("garbage", 8, 1),
        (None, 8, 1),
    ],
)
def test_lease_size_policy(pkg, shape, total, want):
    assert pkg.devicepool.lease_size_for(shape, total) == want


def test_grants_are_power_of_two_and_aligned(pkg):
    pool = pkg.devicepool.DevicePool(8)
    for shape in ("16x4x8", "64x8x8", "64x12x8", "16x2x8"):
        lease = pool.acquire(shape=shape, timeout_s=0)
        assert lease is not None
        size = lease.size
        assert size & (size - 1) == 0  # power of two
        assert lease.indices[0] % size == 0  # aligned
        assert lease.indices == tuple(
            range(lease.indices[0], lease.indices[0] + size)
        )  # contiguous
        pool.release(lease)


# -- allocation ---------------------------------------------------------------


def test_disjoint_grants_and_reuse_after_release(pkg):
    pool = pkg.devicepool.DevicePool(8)
    a = pool.acquire(size=4, timeout_s=0)
    b = pool.acquire(size=2, timeout_s=0)
    c = pool.acquire(size=2, timeout_s=0)
    assert a and b and c
    taken = set(a.indices) | set(b.indices) | set(c.indices)
    assert len(taken) == 8  # all disjoint, pool exactly full
    assert pool.acquire(size=1, timeout_s=0) is None
    pool.release(b)
    d = pool.acquire(size=2, timeout_s=0)
    assert d is not None and set(d.indices) == set(b.indices)
    for lease in (a, c, d):
        pool.release(lease)
    assert pool.snapshot()["in_use"] == 0


def test_oversized_request_clamps_to_pool(pkg):
    pool = pkg.devicepool.DevicePool(2)
    lease = pool.acquire(shape="1024x12x8", timeout_s=0)
    assert lease is not None and lease.size == 2
    pool.release(lease)


def test_double_release_raises(pkg):
    pool = pkg.devicepool.DevicePool(2)
    lease = pool.acquire(size=1, timeout_s=0)
    pool.release(lease)
    with pytest.raises(ValueError):
        pool.release(lease)


def test_contention_blocks_then_wakes_waiter(pkg):
    pool = pkg.devicepool.DevicePool(2)
    first = pool.acquire(size=2, timeout_s=0)
    got = []

    def waiter():
        got.append(pool.acquire(size=2, timeout_s=10))

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while pool.snapshot()["waiters"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.snapshot()["waiters"] == 1  # blocked, not failed
    pool.release(first)
    t.join(timeout=10)
    assert not t.is_alive()
    assert got and got[0] is not None and got[0].size == 2
    pool.release(got[0])


def test_timeout_returns_none_and_pool_survives(pkg):
    pool = pkg.devicepool.DevicePool(1)
    held = pool.acquire(size=1, timeout_s=0)
    t0 = time.monotonic()
    assert pool.acquire(size=1, timeout_s=0.05) is None
    assert time.monotonic() - t0 < 5.0
    pool.release(held)
    again = pool.acquire(size=1, timeout_s=0)
    assert again is not None
    pool.release(again)


# -- stats events -------------------------------------------------------------


def _events(sink: io.StringIO) -> list[dict]:
    return [json.loads(l) for l in sink.getvalue().splitlines() if l.strip()]


def test_lease_events_drive_stats_stream_and_registry(pkg):
    sink = io.StringIO()
    stats = pkg.stats.ServiceStats(sink)
    pool = pkg.devicepool.DevicePool(4, stats=stats)

    lease = pool.acquire(shape="64x8x8", job=7, timeout_s=0)
    assert lease is not None and lease.size == 4
    blocked = pool.acquire(size=1, job=8, timeout_s=0.05)
    assert blocked is None
    pool.release(lease)

    evs = _events(sink)
    by_name = {e["ev"]: e for e in evs}
    grant = by_name["lease_grant"]
    assert grant["job"] == 7
    assert grant["size"] == 4
    assert grant["devices"] == [0, 1, 2, 3]
    assert grant["in_use"] == 4
    timeout = by_name["lease_timeout"]
    assert timeout["job"] == 8
    release = by_name["lease_release"]
    assert release["in_use"] == 0
    assert release["held_s"] >= 0

    snap = stats.snapshot()
    assert snap["leases_granted"] == 1
    assert snap["lease_timeouts"] == 1
    rendered = stats.registry.render()
    assert "verifyd_leases_granted_total 1" in rendered
    assert "verifyd_lease_timeouts_total 1" in rendered
    assert "verifyd_devices_leased 0" in rendered  # released at the end
    assert "verifyd_lease_wait_seconds_count 1" in rendered
