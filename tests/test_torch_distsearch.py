"""The distributed search in the port — ``service/distsearch.py``, the
grant ledger of ``service/journal.py``, the daemon's ``grant`` /
``delta`` / ``partition_done`` ops and the scheduler's partition path —
beside the JAX package's.

- The cases of ``tests/test_distsearch.py``, run over both packages: the
  packed-state canon, digest partitioning, segment planning,
  ``complete_cuts``, the coordinator's merge fence and epoch floor, the
  grant ledger's recovery (torn tail included) and cold read, and the
  coordinated route through in-process backends behind an in-process
  router (OK, ILLEGAL, and the single-backend fallback); and the cases of
  ``tests/test_progress.py`` on the coordinator's progress-rate stall
  clock (a moving owner, a silent one, the stall-steal count).
- Side by side, exact: ``pack_states`` bytes, ``part_ranges`` and
  ``part_id``, ``partition_states`` and ``plan_segments`` (with
  ``_closed_event_cuts``) on seeded histories, and the bytes of a grant
  ledger for the same records.
- Across packages: a grant ledger either package wrote is recovered and
  read cold by the other; the daemons answer the same ``grant`` /
  ``delta`` / ``partition_done`` frames with the same bodies; a
  ``submit --distributed`` through the port's router over the port's
  daemons gives the JAX router's verdict and per-segment merged unions
  over the JAX daemons, and each router coordinates the other package's
  daemons to the same answer.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import random
import socket as _socket
from types import SimpleNamespace

import pytest

from helpers import H, fold
from s2_verification_tpu.utils import events as jev
from s2_verification_tpu.utils.events import AppendIndefiniteFailure
from test_torch_service import time_limit

JAX, PORT = "s2_verification_tpu", "s2_verification_tpu_torch"
PACKAGES = (JAX, PORT)

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    "prepare": ("checker.entries", "prepare"),
    "check_frontier": ("checker.frontier", "check_frontier"),
    "check_frontier_auto": ("checker.frontier", "check_frontier_auto"),
    "CheckOutcome": ("checker.oracle", "CheckOutcome"),
    "INIT_STATE": ("models.stream", "INIT_STATE"),
    "StreamState": ("models.stream", "StreamState"),
    "VerifydClient": ("service.client", "VerifydClient"),
    "Verifyd": ("service.daemon", "Verifyd"),
    "VerifydConfig": ("service.daemon", "VerifydConfig"),
    "distsearch": ("service.distsearch", None),
    "Coordinator": ("service.distsearch", "Coordinator"),
    "DistSearchConfig": ("service.distsearch", "DistSearchConfig"),
    "_Attempt": ("service.distsearch", "_Attempt"),
    "VerifydError": ("service.client", "VerifydError"),
    "pack_states": ("service.distsearch", "pack_states"),
    "part_ranges": ("service.distsearch", "part_ranges"),
    "part_id": ("service.distsearch", "part_id"),
    "partition_states": ("service.distsearch", "partition_states"),
    "plan_segments": ("service.distsearch", "plan_segments"),
    "unpack_states": ("service.distsearch", "unpack_states"),
    "GRANTS_SUBDIR": ("service.journal", "GRANTS_SUBDIR"),
    "GrantLedger": ("service.journal", "GrantLedger"),
    "read_grants_cold": ("service.journal", "read_grants_cold"),
    "encode_frame": ("service.protocol", "encode_frame"),
    "BackendSpec": ("service.router", "BackendSpec"),
    "RouterConfig": ("service.router", "RouterConfig"),
    "VerifydRouter": ("service.router", "VerifydRouter"),
    "ev": ("utils.events", None),
}


def names(pkg: str) -> SimpleNamespace:
    """The names of :data:`_NAMES` from package ``pkg``."""
    ns = SimpleNamespace()
    for name, (mod, attr) in _NAMES.items():
        m = importlib.import_module(f"{pkg}.{mod}")
        setattr(ns, name, getattr(m, attr) if attr else m)
    return ns


@pytest.fixture(params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    P.__dict__.update(vars(names(request.param)))
    yield request.param


#: a case of ``tests/test_distsearch.py``, run once for each package
both = pytest.mark.usefixtures("package")


@pytest.fixture(autouse=True)
def _time_limit():
    """Each case fails at its limit instead of hanging the run."""
    with time_limit(90):
        yield


J, T = names(JAX), names(PORT)


def _text(h: H) -> str:
    buf = io.StringIO()
    jev.write_history(h.events, buf)
    return buf.getvalue()


def _branchy(rounds: int = 3, k: int = 2, base: int = 700) -> H:
    """``rounds`` rounds of ``k`` concurrent indefinite appends, each
    closed by a check-tail barrier pinning exactly one more applied
    record — every round doubles the candidate-state union, and every
    barrier is an event-closed cut for the segment planner."""
    h = H()
    for r in range(rounds):
        ops = [
            (10 + i, h.call_append(10 + i, [base + 10 * r + i]))
            for i in range(k)
        ]
        for c, op in ops:
            h.finish(c, op, AppendIndefiniteFailure())
        h.check_tail_ok(99, tail=r + 1)
    return h


def _events(h: H, ns=None):
    """``h``'s events in package ``ns`` (the JAX package's by default)."""
    ns = ns or P
    return list(ns.ev.iter_history(_text(h)))


# -- wire canon ---------------------------------------------------------------


@both
def test_pack_unpack_roundtrip_byte_for_byte():
    states = (
        P.StreamState(tail=3, stream_hash=777, fencing_token=None),
        P.StreamState(tail=1, stream_hash=42, fencing_token=7),
        P.StreamState(tail=2, stream_hash=99, fencing_token=None),
    )
    payload = P.pack_states(states)
    # JSON round trip (the wire) then re-pack: identical bytes.
    wire = json.dumps(payload, separators=(",", ":"))
    back = P.unpack_states(json.loads(wire))
    assert set(back) == set(states)
    assert json.dumps(P.pack_states(back), separators=(",", ":")) == wire
    # Input order never matters: the canon sorts.
    assert P.pack_states(reversed(states)) == payload


@both
def test_unpack_malformed_raises():
    for bad in ([[1, 2]], [["x", "y", None]], [1], [[1, 2, 3, 4]]):
        with pytest.raises(ValueError):
            P.unpack_states(bad)


@both
def test_part_ranges_cover_disjoint():
    for n in (1, 2, 3, 7, 16):
        ranges = P.part_ranges(n)
        assert len(ranges) == n
        assert ranges[0][0] == 0 and ranges[-1][1] == 1 << 32
        for (_, hi), (lo, _) in zip(ranges, ranges[1:]):
            assert hi == lo  # contiguous, no gap, no overlap


@both
def test_partition_states_disjoint_cover():
    states = [
        P.StreamState(tail=t, stream_hash=h, fencing_token=None)
        for t in range(6)
        for h in (t * 1000003, t * 17 + 5)
    ]
    for n in (1, 2, 3, 5):
        parts = P.partition_states(states, n)
        assert len(parts) <= n
        assert all(parts.values())  # empty ranges are dropped
        union = [s for ss in parts.values() for s in ss]
        assert sorted(union) == sorted(set(states))  # covering
        seen = set()
        for ss in parts.values():  # pairwise disjoint
            assert not (set(ss) & seen)
            seen.update(ss)


# -- segment planning ---------------------------------------------------------


@both
def test_plan_segments_cuts_are_event_closed_and_partition_ops():
    h = _branchy(rounds=4, k=2)
    events = _events(h)
    hist = P.prepare(events, elide_trivial=True)
    segments = P.plan_segments(events, hist, 3)
    assert segments is not None and 2 <= len(segments) <= 3
    # Contiguous slices covering every event, op counts increasing to
    # the full op count.
    assert segments[0].event_lo == 0
    assert segments[-1].event_hi == len(events)
    for a, b in zip(segments, segments[1:]):
        assert a.event_hi == b.event_lo
        assert a.ops_hi < b.ops_hi
    assert segments[-1].ops_hi == len(hist.ops)
    for seg in segments[:-1]:
        # Event-closed: every op started in the prefix finished in it.
        open_ops = set()
        for le in events[: seg.event_hi]:
            key = (le.client_id, le.op_id)
            open_ops.add(key) if le.is_start else open_ops.discard(key)
        assert not open_ops, f"cut at {seg.event_hi} slices an op"
        # Op-consistent: ops_hi counts exactly the ops called before it.
        assert seg.ops_hi == sum(
            1 for op in hist.ops if op.call < seg.event_hi
        )
        # Boundary names come from the chain-hash prefix canon.
        assert not seg.key.startswith("seg:")


@both
def test_plan_segments_degenerate_histories():
    assert P.plan_segments([], P.prepare([]), 3) is None
    h = H()
    h.append_ok(1, [5], tail=1)
    events = _events(h)
    hist = P.prepare(events, elide_trivial=True)
    segs = P.plan_segments(events, hist, 3)  # no interior cut helps
    assert segs is not None and len(segs) == 1
    assert segs[0].event_hi == len(events)


@both
def test_complete_cuts_holds_early_accept_until_union_is_exact():
    """A history whose tail is all indefinite appends early-accepts —
    fine for a verdict, fatal for a partition whose end union seeds the
    next segment.  ``complete_cuts=True`` defers the accept until the
    requested cut's union is the exact reachable set."""
    h = H()
    a = h.call_append(1, [11])
    b = h.call_append(2, [12])
    h.finish(1, a, AppendIndefiniteFailure())
    h.finish(2, b, AppendIndefiniteFailure())
    hist = P.prepare(_events(h), elide_trivial=True)
    n = len(hist.ops)
    relaxed = P.check_frontier(hist, witness=False, snapshot_cuts=[n])
    assert relaxed.outcome == P.CheckOutcome.OK
    assert n not in (getattr(relaxed, "snapshots", None) or {})
    held = P.check_frontier(
        hist, witness=False, snapshot_cuts=[n], complete_cuts=True
    )
    assert held.outcome == P.CheckOutcome.OK
    union = set(getattr(held, "snapshots", {})[n])
    # Exact: every apply/skip interleaving of the two appends.
    assert union == {
        P.INIT_STATE,
        P.StreamState(tail=1, stream_hash=fold([11]), fencing_token=None),
        P.StreamState(tail=1, stream_hash=fold([12]), fencing_token=None),
        P.StreamState(tail=2, stream_hash=fold([11, 12]), fencing_token=None),
        P.StreamState(tail=2, stream_hash=fold([12, 11]), fencing_token=None),
    }


# -- the coordinator's merge fence --------------------------------------------


@both
def test_coordinator_fences_stale_and_duplicate_deltas(tmp_path):
    led = P.GrantLedger(str(tmp_path / "state" / P.GRANTS_SUBDIR))
    coord = P.Coordinator(search="s-unit", nodes=lambda: [], ledger=led)
    try:
        seg, part = "chain:deadbeef", "00000000-80000000"
        coord._epochs[(seg, part)] = 5
        body = {"verdict": 0, "states": []}
        # A zombie's stale epoch is refused, counted, journaled.
        assert coord._accept_delta(seg, part, 4, body) is False
        assert coord.fences == 1
        # An epoch never granted is equally stale.
        assert coord._accept_delta(seg, "ffffffff-100000000", 5, body) is False
        # The exact live epoch merges exactly once...
        assert coord._accept_delta(seg, part, 5, body) is True
        assert coord._results[(seg, part)] is body
        # ...and its duplicate is fenced, even at the same epoch.
        assert coord._accept_delta(seg, part, 5, body) is False
        assert coord.fences == 3
        assert coord.stale_accepted == 0
    finally:
        coord._pool.shutdown(wait=False)
        led.close()
    cold = P.read_grants_cold(str(tmp_path / "state"))
    assert cold is not None
    assert cold["searches"]["s-unit"]["fences"] == 3


@both
def test_coordinator_epoch_floor_monotone():
    coord = P.Coordinator(search="s", nodes=lambda: [], epoch_floor=41)
    try:
        assert coord._next_epoch() == 42  # restart fences the dead boot
        assert coord._next_epoch() == 43
    finally:
        coord._pool.shutdown(wait=False)


# -- grant ledger durability --------------------------------------------------


def _records(led) -> None:
    led.search(search="s1", segs=2, parts=2)
    led.grant(search="s1", seg="k1", part="p1", epoch=1, node="a", reason="grant")
    led.grant(search="s1", seg="k1", part="p2", epoch=2, node="b", reason="grant")
    led.delta(
        search="s1", seg="k1", part="p1", epoch=1, node="a",
        verdict=0, states=3, size=64,
    )
    led.done(search="s1", seg="k1", part="p1", epoch=1, reason="done")


def _seed_ledger(directory: str, ns=None):
    led = (ns or P).GrantLedger(directory)
    _records(led)
    return led


@both
def test_grant_ledger_torn_tail_recovers_valid_prefix(tmp_path):
    directory = str(tmp_path / "ledger")
    _seed_ledger(directory).close()
    # Tear the tail: the coordinator died mid-append of the ``done``
    # record, leaving a valid header and a truncated payload.
    segs = sorted(p for p in os.listdir(directory) if p.startswith("seg-"))
    path = os.path.join(directory, segs[-1])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    led = P.GrantLedger(directory)
    orphans, floors = led.recover()
    # The torn ``done`` is dropped, so p1's grant is open again — exactly
    # the honest reading: its closure never durably happened.
    assert sorted(o["part"] for o in orphans) == ["p1", "p2"]
    assert floors == {"s1": 2}
    assert led.recovery.torn_tail_bytes > 0
    assert led.recovery.records == 4
    # The writer rotates away from the damaged segment; new records land
    # and survive the next recovery.
    led.done(search="s1", seg="k1", part="p2", epoch=2, reason="done")
    led.close()
    led2 = P.GrantLedger(directory)
    orphans2, _ = led2.recover()
    assert sorted(o["part"] for o in orphans2) == ["p1"]
    led2.close()


@both
def test_grant_ledger_recover_clean(tmp_path):
    directory = str(tmp_path / "ledger")
    led = _seed_ledger(directory)
    orphans, floors = led.recover()
    assert [o["part"] for o in orphans] == ["p2"]  # p1 closed by done
    assert floors == {"s1": 2}
    led.verdict(search="s1", verdict=0, outcome="ok")
    orphans, _ = led.recover()
    assert orphans == []  # a verdict closes every record of the search
    led.close()


@both
def test_read_grants_cold_absent_and_present(tmp_path):
    empty = tmp_path / "no-ledger"
    empty.mkdir()
    assert P.read_grants_cold(str(empty)) is None
    state = tmp_path / "state"
    _seed_ledger(str(state / P.GRANTS_SUBDIR)).close()
    cold = P.read_grants_cold(str(state))
    s = cold["searches"]["s1"]
    assert s["verdict"] is None  # live at death
    assert [g["part"] for g in s["open_grants"]] == ["p2"]
    assert s["last_delta"]["p1"]["verdict"] == 0
    assert cold["open_total"] == 1
    assert cold["recovery"]["torn_tail_bytes"] == 0


# -- end-to-end: the coordinated route ---------------------------------------


def _backend_cfg(tmp_path, name: str, ns=None):
    ns = ns or P
    return ns.VerifydConfig(
        socket_path=str(tmp_path / f"{name}.sock"),
        workers=1,
        device="off",
        no_viz=True,
        stats_log=None,
        out_dir=str(tmp_path / f"viz-{name}"),
    )


def _router_cfg(tmp_path, names_, ns=None, **overrides):
    ns = ns or P
    kw = dict(
        listen=str(tmp_path / "router.sock"),
        backends=tuple(
            ns.BackendSpec(n, str(tmp_path / f"{n}.sock")) for n in names_
        ),
        probe_interval_s=30.0,
        state_dir=str(tmp_path / "router-state"),
    )
    kw.update(overrides)
    return ns.RouterConfig(**kw)


@both
def test_distributed_submit_verdict_parity_ok(tmp_path):
    text = _text(_branchy(rounds=3, k=2, base=900))
    hist = P.prepare(list(P.ev.iter_history(text)), elide_trivial=True)
    oracle = P.check_frontier_auto(hist)
    assert oracle.outcome == P.CheckOutcome.OK
    names_ = ("a", "b", "c")
    with P.Verifyd(_backend_cfg(tmp_path, "a")), P.Verifyd(
        _backend_cfg(tmp_path, "b")
    ), P.Verifyd(_backend_cfg(tmp_path, "c")), P.VerifydRouter(
        _router_cfg(tmp_path, names_)
    ) as router:
        client = P.VerifydClient(router.cfg.listen)
        reply = client.submit(text, no_viz=True, distributed=True)
        assert reply["verdict"] == 0
        assert reply["outcome"] == "ok"
        assert reply["distributed"] is True
        assert reply["node"] == "distributed"
        assert reply["stale_accepted"] == 0
        # Three segments; the first carries only INIT, later boundaries
        # carry a branched union split across nodes.
        assert reply["partitions"] >= 3
        assert reply["grants"] >= reply["partitions"]
        assert set(reply["owners"].values()) <= set(names_)
        snap = client.stats()
        assert snap["distsearch"]["searches"] == 1
        assert snap["distsearch"]["ledger"] is True
    # The ledger closed the search: nothing left open post-mortem.
    cold = P.read_grants_cold(str(tmp_path / "router-state"))
    assert cold is not None and cold["open_total"] == 0
    (search_rec,) = cold["searches"].values()
    assert search_rec["verdict"] == 0 and search_rec["outcome"] == "ok"


@both
def test_distributed_submit_verdict_parity_illegal(tmp_path):
    h = _branchy(rounds=2, k=2, base=1300)
    h.check_tail_ok(99, tail=50)  # impossible: at most 2 records applied
    text = _text(h)
    hist = P.prepare(list(P.ev.iter_history(text)), elide_trivial=True)
    assert P.check_frontier_auto(hist).outcome == P.CheckOutcome.ILLEGAL
    with P.Verifyd(_backend_cfg(tmp_path, "a")), P.Verifyd(
        _backend_cfg(tmp_path, "b")
    ), P.VerifydRouter(_router_cfg(tmp_path, ("a", "b"))) as router:
        client = P.VerifydClient(router.cfg.listen)
        reply = client.submit(text, no_viz=True, distributed=True)
        assert reply["verdict"] == 1
        assert reply["outcome"] == "illegal"
        assert reply["distributed"] is True
        assert reply["stale_accepted"] == 0


@both
def test_distributed_falls_back_on_single_backend(tmp_path):
    text = _text(_branchy(rounds=2, k=2, base=1700))
    with P.Verifyd(_backend_cfg(tmp_path, "a")), P.VerifydRouter(
        _router_cfg(tmp_path, ("a",))
    ) as router:
        client = P.VerifydClient(router.cfg.listen)
        # One healthy node can't host a fleet search: the route degrades
        # to the plain single-node submit — correct, just not parallel.
        reply = client.submit(text, no_viz=True, distributed=True)
        assert reply["verdict"] == 0
        assert not reply.get("distributed")
        assert reply["node"] == "a"
        assert client.stats()["distsearch"]["fallbacks"] == 1


# -- tests/test_progress.py: the progress-rate stall clock ----------------------


class _WatchStub:
    """A backend client stub for the coordinator's progress poll."""

    def __init__(self):
        self.row = None  # None → answer UnknownJob (owner never reports)

    def watch(self, fingerprint=None, timeout=None):
        if self.row is None:
            raise P.VerifydError("UnknownJob", "no such job")
        return {"progress": [dict(self.row)]}


def _coordinator(stub):
    return P.Coordinator(
        search="c" * 64,
        nodes=lambda: [("a", stub)],
        config=P.DistSearchConfig(progress_poll_s=0.5),
    )


def _poll_until_harvest(coord, attempt, now: float) -> float:
    """Launch one poll and harvest it; returns the harvest timestamp."""
    import time

    coord._poll_progress(attempt, now)
    assert attempt.poll_future is not None
    while not attempt.poll_future.done():
        time.sleep(0.005)
    now += 0.01
    coord._poll_progress(attempt, now)
    return now


@both
def test_stall_clock_advances_only_with_progress():
    stub = _WatchStub()
    coord = _coordinator(stub)
    try:
        a = P._Attempt(part="p0", epoch=1, node="a", future=None)
        granted_at = a.last_advance

        # Owner reports ops=5: the stall clock advances past grant time.
        stub.row = {"ops_committed": 5, "total_ops": 40, "states_expanded": 9}
        t1 = _poll_until_harvest(coord, a, now=granted_at + 10.0)
        assert a.ops == 5 and a.last_advance == t1 > granted_at
        assert coord.progress["p0"]["ops_committed"] == 5
        assert coord.progress["p0"]["node"] == "a"

        # Same numbers again: the search stopped moving — the clock does
        # not advance, so the straggler budget now runs against it.
        t2 = _poll_until_harvest(coord, a, now=t1 + 1.0)
        assert a.last_advance == t1 < t2
        assert coord.progress["p0"]["stalled_s"] > 0

        # It moves again: fresh clock.
        stub.row = {"ops_committed": 11, "total_ops": 40, "states_expanded": 20}
        t3 = _poll_until_harvest(coord, a, now=t2 + 1.0)
        assert a.ops == 11 and a.last_advance == t3

        snap = coord.progress_snapshot()
        assert snap["partitions"]["p0"]["ops_committed"] == 11
    finally:
        coord._pool.shutdown(wait=False)


@both
def test_silent_owner_degrades_to_wall_clock_rule():
    stub = _WatchStub()  # row stays None: every watch answers UnknownJob
    coord = _coordinator(stub)
    try:
        a = P._Attempt(part="p0", epoch=1, node="a", future=None)
        granted_at = a.last_advance
        t1 = _poll_until_harvest(coord, a, now=granted_at + 10.0)
        _poll_until_harvest(coord, a, now=t1 + 1.0)
        # No heartbeat ever seen: the stall clock never moved off grant
        # time (legacy wall-clock stealing) and the steal reason stays
        # the legacy "steal", not "stall-steal".
        assert a.last_advance == granted_at
        assert a.ops == -1 and a.expanded == -1
        assert "p0" not in coord.progress
    finally:
        coord._pool.shutdown(wait=False)


@both
def test_stall_steal_reason_is_counted():
    counts: dict[str, int] = {}
    stub = _WatchStub()

    class _Seg:
        key = "seg0"

    class _GrantStub:
        def grant(self, **kw):
            return {"ok": True}

        def delta(self, *a, **kw):
            return {"verdict": 2}

    coord = P.Coordinator(
        search="c" * 64,
        nodes=lambda: [("a", stub)],
        config=P.DistSearchConfig(progress_poll_s=0.5),
        counter=lambda key, n=1: counts.__setitem__(
            key, counts.get(key, 0) + n
        ),
    )
    try:
        coord._grant_and_ship(
            _Seg(), "", "p0", (), "a", _GrantStub(), "stall-steal"
        )
        assert coord.stall_steals == 1 and coord.steals == 1
        assert counts.get("stall_stolen") == 1 and counts.get("stolen") == 1
        coord._grant_and_ship(
            _Seg(), "", "p1", (), "a", _GrantStub(), "steal"
        )
        assert coord.stall_steals == 1 and coord.steals == 2
        assert counts.get("stall_stolen") == 1 and counts.get("stolen") == 2
    finally:
        coord._pool.shutdown(wait=False)


# -- side by side: the canon ---------------------------------------------------


def _seeded_states(seed: int, n: int) -> list[tuple]:
    rng = random.Random(seed)
    return [(rng.randrange(64), rng.randrange(1 << 64), rng.choice([None, rng.randrange(1 << 20)]))
            for _ in range(n)]


def _states(ns, rows):
    return [ns.StreamState(tail=t, stream_hash=h, fencing_token=tok) for t, h, tok in rows]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_states_and_partitions_equal_jax(seed):
    rows = _seeded_states(seed, 300)
    assert json.dumps(T.pack_states(_states(T, rows)), separators=(",", ":")) == json.dumps(
        J.pack_states(_states(J, rows)), separators=(",", ":"))
    for n in (1, 2, 3, 4, 7, 16):
        pp, jp = T.partition_states(_states(T, rows), n), J.partition_states(_states(J, rows), n)
        assert list(pp) == list(jp)
        assert {k: T.pack_states(v) for k, v in pp.items()} == {k: J.pack_states(v) for k, v in jp.items()}


def test_part_ranges_and_ids_equal_jax():
    for n in list(range(1, 33)) + [100, 1000]:
        assert T.part_ranges(n) == J.part_ranges(n)
        assert [T.part_id(lo, hi) for lo, hi in T.part_ranges(n)] == [J.part_id(lo, hi) for lo, hi in J.part_ranges(n)]


def _seeded_histories() -> list[str]:
    adv_j = importlib.import_module("s2_verification_tpu.collector.adversarial")
    out = [_text(_branchy(rounds=r, k=k, base=100 * r + k)) for r, k in ((1, 1), (3, 2), (5, 2), (4, 3))]
    for seed in range(3):
        buf = io.StringIO()
        jev.write_history(adv_j.adversarial_events(4, batch=3, seed=seed), buf)
        out.append(buf.getvalue())
    return out


@pytest.mark.parametrize("segments", [1, 2, 3, 5])
def test_segment_plans_equal_jax(segments):
    for text in _seeded_histories():
        plans = []
        for ns in (J, T):
            events = list(ns.ev.iter_history(text))
            hist = ns.prepare(events, elide_trivial=True)
            plan = ns.plan_segments(events, hist, segments)
            plans.append([(s.index, s.key, s.event_lo, s.event_hi, s.ops_hi) for s in plan])
            plans.append(ns.distsearch._closed_event_cuts(events))
        assert plans[2:] == plans[:2]


def test_grant_ledger_bytes_equal_jax(tmp_path):
    """The same records, under the same boot id, give the same segment
    bytes in each package."""
    blobs = []
    for ns, sub in ((J, "j"), (T, "p")):
        led = ns.GrantLedger(str(tmp_path / sub))
        led.boot = "0123456789abcdef"
        _records(led)
        led.verdict(search="s1", verdict=0, outcome="ok")
        led.close()
        blobs.append({n: (tmp_path / sub / n).read_bytes() for n in sorted(os.listdir(tmp_path / sub))})
    assert blobs[1] == blobs[0]
    assert sum(len(b) for b in blobs[0].values()) > 0


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax-to-port", "port-to-jax"])
def test_grant_ledgers_read_across_packages(tmp_path, writer, reader):
    W, R = names(writer), names(reader)
    state = tmp_path / "state"
    led = _seed_ledger(str(state / W.GRANTS_SUBDIR), W)
    led.grant(search="s2", seg="k9", part="p9", epoch=7, node="c", reason="steal")
    led.close()
    back = R.GrantLedger(str(state / R.GRANTS_SUBDIR))
    own = W.GrantLedger(str(state / W.GRANTS_SUBDIR))
    try:
        assert back.recover() == own.recover()
    finally:
        back.close(), own.close()
    assert R.read_grants_cold(str(state)) == W.read_grants_cold(str(state))
    cold = R.read_grants_cold(str(state))
    assert cold["open_total"] == 2 and sorted(cold["searches"]) == ["s1", "s2"]
    # The post-mortem reads the ledger too (a router's state dir).
    flight = importlib.import_module(f"{reader}.obs.flight")
    pm = flight.postmortem(str(state))
    assert pm["distsearch"] == cold
    assert "distributed search" in flight.render_postmortem(pm)


# -- across packages: the daemon's ops ----------------------------------------


def _frames(text: str) -> list[dict]:
    carry = {"n": 0, "s": [[0, 0, None]]}
    seg = "chain:00"
    return [
        {"op": "grant", "search": "s", "seg": seg, "part": "p", "epoch": 3},
        {"op": "grant", "search": "s", "seg": seg, "part": "p", "epoch": 2},  # fenced
        {"op": "delta", "search": "s", "seg": seg, "part": "p", "epoch": 2, "carry": carry, "history": text},
        {"op": "delta", "search": "s", "seg": seg, "part": "p", "epoch": 3, "carry": carry, "history": text},
        {"op": "grant", "search": "s", "seg": seg, "part": "q", "epoch": 4},
        {"op": "partition_done", "search": "s", "part": "q", "epoch": 3},  # fenced
        {"op": "partition_done", "search": "s", "part": "q", "epoch": 4},
        {"op": "partition_done", "search": "s", "part": "q", "epoch": 4},  # already closed
        {"op": "grant", "search": "", "part": "p", "epoch": 1},  # decode error
        {"op": "delta", "search": "s", "seg": seg, "part": "r", "epoch": "x"},  # decode error
    ]


def _answer(ns, tmp_path, frames) -> list[dict]:
    replies = []
    with ns.Verifyd(_backend_cfg(tmp_path, "a", ns)) as d:
        conn = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        conn.connect(d.cfg.socket_path)
        conn.settimeout(60)
        rfile = conn.makefile("rb")
        for frame in frames:
            conn.sendall(ns.encode_frame(frame))
            replies.append(json.loads(rfile.readline()))
        rfile.close()
        conn.close()
    for r in replies:
        for k in ("trace_id", "wall_s", "job", "queue_wait_s"):
            (r.get("ok") or {}).pop(k, None)
    return replies


def test_daemons_answer_the_fleet_ops_as_jax_does(tmp_path):
    """``grant``, ``delta`` and ``partition_done`` answer the same bodies
    in both daemons: grants, the epoch fences, a partition's verdict and
    its end-of-segment union, closures and decode errors."""
    text = _text(_branchy(rounds=2, k=2, base=300))
    (tmp_path / "j").mkdir(), (tmp_path / "p").mkdir()
    jr = _answer(J, tmp_path / "j", _frames(text))
    pr = _answer(T, tmp_path / "p", _frames(text))
    assert pr == jr
    assert [("ok" in r, (r.get("err") or {}).get("class")) for r in pr] == [
        (True, None), (False, "EpochFenced"), (False, "EpochFenced"), (True, None), (True, None),
        (False, "EpochFenced"), (True, None), (True, None), (False, "DecodeError"), (False, "DecodeError"),
    ]
    body = pr[3]["ok"]
    assert (body["verdict"], body["scope"], body["part"], body["epoch"]) == (0, "partition", "p", 3)
    hist = T.prepare(list(T.ev.iter_history(text)), elide_trivial=True)
    exact = T.check_frontier(hist, witness=False, snapshot_cuts=[len(hist.ops)], complete_cuts=True)
    assert body["states"] == T.pack_states(exact.snapshots[len(hist.ops)])
    assert [pr[6]["ok"]["closed"], pr[7]["ok"]["closed"]] == [True, False]


# -- across packages: the coordinated route ------------------------------------


def _distributed(tmp_path, router_ns, daemon_ns, text, n=3) -> tuple[dict, list]:
    """``submit --distributed`` of ``text`` through a router of
    ``router_ns`` over ``n`` daemons of ``daemon_ns``: the reply and each
    segment's merged union (packed) and verdict, as the coordinator saw
    them."""
    seen = []
    real = router_ns.Coordinator._run_segment

    def recording(self, seg, seg_text, parts, final=False):
        merged, verdict = real(self, seg, seg_text, parts, final=final)
        union = router_ns.pack_states(merged) if isinstance(merged, (tuple, list, set, frozenset)) else merged
        seen.append((seg.key, sorted(parts), union, verdict))
        return merged, verdict

    router_ns.Coordinator._run_segment = recording
    names_ = tuple("abcdefg"[:n])
    try:
        ds = [daemon_ns.Verifyd(_backend_cfg(tmp_path, x, daemon_ns)).__enter__() for x in names_]
        try:
            with router_ns.VerifydRouter(_router_cfg(tmp_path, names_, router_ns)) as router:
                reply = router_ns.VerifydClient(router.cfg.listen).submit(text, no_viz=True, distributed=True)
        finally:
            for d in ds:
                d.__exit__(None, None, None)
    finally:
        router_ns.Coordinator._run_segment = real
    cold = router_ns.read_grants_cold(str(tmp_path / "router-state"))
    assert cold["open_total"] == 0
    return reply, seen


def _dist_histories() -> dict:
    ok = _branchy(rounds=4, k=3, base=2100)
    bad = _branchy(rounds=3, k=2, base=2500)
    bad.check_tail_ok(99, tail=50)
    return {"ok": _text(ok), "illegal": _text(bad)}


@pytest.mark.parametrize("verdict", ["ok", "illegal"])
def test_distributed_verdict_and_unions_equal_the_jax_routers(tmp_path, verdict):
    text = _dist_histories()[verdict]
    (tmp_path / "j").mkdir(), (tmp_path / "p").mkdir()
    jreply, jseen = _distributed(tmp_path / "j", J, J, text)
    preply, pseen = _distributed(tmp_path / "p", T, T, text)
    assert preply["distributed"] is jreply["distributed"] is True
    for key in ("verdict", "outcome", "partitions", "grants", "regrants", "fences", "stale_accepted", "epochs"):
        assert preply[key] == jreply[key], key
    assert pseen == jseen
    assert len(pseen) >= 2
    hist = T.prepare(list(T.ev.iter_history(text)), elide_trivial=True)
    assert preply["verdict"] == {"ok": 0, "illegal": 1}[T.check_frontier_auto(hist).outcome.value]


@pytest.mark.parametrize("router_pkg,daemon_pkg", [(PORT, JAX), (JAX, PORT)], ids=["port-over-jax", "jax-over-port"])
def test_a_router_coordinates_the_other_packages_daemons(tmp_path, router_pkg, daemon_pkg):
    text = _dist_histories()["ok"]
    (tmp_path / "s").mkdir(), (tmp_path / "m").mkdir()
    R, D = names(router_pkg), names(daemon_pkg)
    want, want_seen = _distributed(tmp_path / "s", J, J, text, n=2)
    got, seen = _distributed(tmp_path / "m", R, D, text, n=2)
    assert (got["verdict"], got["partitions"], got["stale_accepted"]) == (
        want["verdict"], want["partitions"], want["stale_accepted"])
    assert seen == want_seen


@pytest.mark.parametrize("writer", PACKAGES)
def test_doctor_reads_a_routers_grant_ledger_like_jax(tmp_path, writer, capsys):
    """``doctor --state-dir`` on a router's state dir (the grant ledger,
    no flight ring) prints the distributed-search section and exits as
    the JAX command does, whichever package wrote the ledger."""
    W = names(writer)
    state = tmp_path / "state"
    _seed_ledger(str(state / W.GRANTS_SUBDIR), W).close()
    got = {}
    for pkg in PACKAGES:
        cli = importlib.import_module(f"{pkg}.cli")
        rc = cli.main(["doctor", "--state-dir", str(state)])
        text = capsys.readouterr().out
        rc_json = cli.main(["doctor", "--state-dir", str(state), "--json"])
        pm = json.loads(capsys.readouterr().out)
        got[pkg] = (rc, rc_json, pm["distsearch"], text)
    assert got[PORT][:3] == got[JAX][:3]
    assert got[PORT][2]["open_total"] == 1
    assert "distributed search" in got[PORT][3] and "s1" in got[PORT][3]
