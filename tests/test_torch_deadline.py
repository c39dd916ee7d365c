"""End-to-end deadlines in the port's daemon and router: the seven cases
of ``tests/test_deadline.py`` (the token, admission refusal, queue expiry,
mid-search cancellation on the CPU path and in a supervised child, and the
router's deadline decrement across failover and its refusal of a third
node once the deadline is spent), each run over both packages.  The
supervised case also checks the poison ledger under ``--state-dir``: a
cancel of ours charges no crash.

Every case asserts the observable promises of cooperative cancellation:
the client gets a definite ``DeadlineExceeded`` (never a fake verdict),
the worker or lease is freed within deadline + grace, and
``verifyd_jobs_cancelled_total{reason=...}`` counts the event.
"""

import json
import threading
import time

import pytest

from helpers import H, fold

from test_torch_service import JAX, time_limit
from test_torch_service import _h_text as _text
from test_torch_service import pkg  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(60):
        yield


def good_history(base: int = 100) -> str:
    h = H()
    h.append_ok(1, [base + 1], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([base + 1]))
    return _text(h)


def _fingerprint(pkg, text: str) -> str:
    return pkg.cache.history_fingerprint(
        pkg.entries.prepare(list(pkg.events.iter_history(text)), elide_trivial=True)
    )


def _daemon_cfg(pkg, tmp_path, **overrides):
    kw = dict(
        socket_path=str(tmp_path / "verifyd.sock"),
        workers=1,
        device="off",
        time_budget_s=10.0,
        unbounded_close=False,
        out_dir=str(tmp_path / "viz"),
        stats_log=str(tmp_path / "stats.jsonl"),
    )
    kw.update(overrides)
    return pkg.daemon.VerifydConfig(**kw)


def _events(tmp_path) -> list[dict]:
    with open(tmp_path / "stats.jsonl", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _cancelled(daemon, reason: str) -> float:
    return daemon.registry.get("verifyd_jobs_cancelled_total").value(
        reason=reason
    )


def _sleepy_cpu_check(monkeypatch, pkg):
    """A CPU stage that honestly consumes its budget and never decides —
    the shape of a history the oracle cannot close quickly."""

    def sleepy(hist, budget):
        time.sleep(min(budget if budget is not None else 0.5, 2.0))
        return pkg.oracle.CheckResult(outcome=pkg.oracle.CheckOutcome.UNKNOWN), "oracle"

    monkeypatch.setattr(pkg.scheduler, "_cpu_check", sleepy)


# -- the token itself --------------------------------------------------------


def test_cancel_token_deadline_and_first_reason_wins(pkg):
    tok = pkg.overload.CancelToken(time.monotonic() + 60.0)
    assert tok.check() is None
    assert 59.0 < tok.remaining() <= 60.0
    assert tok.cancel("client_gone") is True
    assert tok.cancel("shutdown") is False  # first reason sticks
    assert tok.check() == "client_gone"

    expired = pkg.overload.CancelToken(time.monotonic() - 0.01)
    assert expired.check() == "deadline"  # auto-cancels on the clock
    assert expired.remaining() == 0.0

    unbounded = pkg.overload.CancelToken()
    assert unbounded.check() is None and unbounded.remaining() is None


# -- admission ---------------------------------------------------------------


def test_deadline_already_expired_at_admission(tmp_path, pkg):
    cfg = _daemon_cfg(pkg, tmp_path)
    with pkg.daemon.Verifyd(cfg) as daemon:
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=30)
        with pytest.raises(pkg.client.VerifydError) as ei:
            client.submit(good_history(), no_viz=True, deadline_s=0.0)
        assert ei.value.cls == "DeadlineExceeded"
        assert ei.value.extra.get("reason") == "deadline"
        shed = daemon.registry.get("verifyd_admission_shed_total")
        assert shed.value(reason="deadline") == 1
        # Shed before the journal/queue: nothing was admitted.
        assert daemon.stats.snapshot()["completed"] == 0
    events = _events(tmp_path)
    assert [e for e in events if e["ev"] == "admission_shed"]


# -- queue expiry (cancellation boundary #1) ---------------------------------


def test_deadline_expires_in_queue_never_starts(tmp_path, monkeypatch, pkg):
    _sleepy_cpu_check(monkeypatch, pkg)
    cfg = _daemon_cfg(pkg, tmp_path, time_budget_s=0.8)
    with pkg.daemon.Verifyd(cfg) as daemon:
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=30)
        blocker_reply = {}

        def blocker():
            blocker_reply.update(
                client.submit(good_history(100), client="slow", no_viz=True)
            )

        t = threading.Thread(target=blocker)
        t.start()
        time.sleep(0.2)  # the worker is now inside the sleepy search
        with pytest.raises(pkg.client.VerifydError) as ei:
            pkg.client.VerifydClient(cfg.socket_path, timeout=30).submit(
                good_history(200), client="doomed", no_viz=True,
                deadline_s=0.2,
            )
        t.join(timeout=10)
        assert ei.value.cls == "DeadlineExceeded"
        assert blocker_reply["outcome"] == "unknown"  # bystander unharmed
        assert _cancelled(daemon, "deadline") == 1
    events = _events(tmp_path)
    cancels = [e for e in events if e["ev"] == "job_cancelled"]
    assert len(cancels) == 1
    c = cancels[0]
    assert c["reason"] == "deadline" and c["started"] is False
    assert c["queue_wait_s"] >= 0.2  # it sat out its whole budget queued
    # Never started: no start event for the doomed client.
    assert not [
        e for e in events if e["ev"] == "start" and e["client"] == "doomed"
    ]


# -- mid-search expiry on the CPU path (boundary #2) -------------------------


def test_deadline_expires_mid_cpu_search(tmp_path, monkeypatch, pkg):
    _sleepy_cpu_check(monkeypatch, pkg)
    cfg = _daemon_cfg(pkg, tmp_path, time_budget_s=30.0, deadline_grace_s=1.0)
    with pkg.daemon.Verifyd(cfg) as daemon:
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=30)
        t0 = time.monotonic()
        with pytest.raises(pkg.client.VerifydError) as ei:
            client.submit(good_history(), no_viz=True, deadline_s=0.4)
        elapsed = time.monotonic() - t0
        assert ei.value.cls == "DeadlineExceeded"
        # The 30s CPU budget was clamped to the 0.4s remaining: the
        # worker freed within deadline + grace (+ scheduling slack).
        assert elapsed < 0.4 + 1.0 + 2.0
        assert _cancelled(daemon, "deadline") == 1
    cancels = [e for e in _events(tmp_path) if e["ev"] == "job_cancelled"]
    assert len(cancels) == 1 and cancels[0]["started"] is True


# -- mid-search expiry on the supervised-child path --------------------------


def test_deadline_frees_supervised_child_and_lease(tmp_path, monkeypatch, pkg):
    """The hard case: the job is inside a supervised escalation child (a
    real subprocess) when the deadline passes.  The drive loop's cancel
    poll must SIGTERM the child, release the device lease, and answer
    DeadlineExceeded — all within deadline + grace.

    The child is made genuinely intractable by a ``sitecustomize.py``
    injected via PYTHONPATH that sleeps at interpreter startup — the
    real-subprocess analogue of a search that cannot finish in time."""

    def instant_unknown(hist, budget):
        return pkg.oracle.CheckResult(outcome=pkg.oracle.CheckOutcome.UNKNOWN), "oracle"

    monkeypatch.setattr(pkg.scheduler, "_cpu_check", instant_unknown)

    wedge = tmp_path / "wedge"
    wedge.mkdir()
    (wedge / "sitecustomize.py").write_text(
        "import os, time\n"
        "if os.environ.get('VERIFYD_TEST_WEDGE_CHILD') == '1':\n"
        "    time.sleep(120)\n",
        encoding="utf-8",
    )
    import os as _os

    existing = _os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv(
        "PYTHONPATH",
        str(wedge) + ((_os.pathsep + existing) if existing else ""),
    )
    monkeypatch.setenv("VERIFYD_TEST_WEDGE_CHILD", "1")

    text = good_history()
    cfg = _daemon_cfg(pkg, tmp_path,
        device="supervised",
        mesh_devices=1,
        spool_dir=str(tmp_path / "spool"),
        attempt_timeout_s=60.0,
        time_budget_s=0.05,
        deadline_grace_s=1.0,
        # The poison ledger lives under --state-dir; the port's child runs
        # on the CPU.
        state_dir=str(tmp_path / "state"),
        **({} if pkg.root == JAX else {"torch_device": "cpu"}),
    )
    with pkg.daemon.Verifyd(cfg) as daemon:
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=60)
        t0 = time.monotonic()
        with pytest.raises(pkg.client.VerifydError) as ei:
            client.submit(text, no_viz=True, deadline_s=1.0)
        elapsed = time.monotonic() - t0
        assert ei.value.cls == "DeadlineExceeded"
        # deadline (1.0) + grace (1.0) + spawn/kill slack.
        assert elapsed < 1.0 + 1.0 + 4.0
        # The lease went back to the pool the moment the child died.
        assert daemon.device_pool.snapshot()["in_use"] == 0
        assert _cancelled(daemon, "deadline") == 1
        # Our own SIGTERM is not a crash: the poison ledger stays clean.
        assert daemon.quarantine.crash_count(_fingerprint(pkg, text)) == 0
    cancels = [e for e in _events(tmp_path) if e["ev"] == "job_cancelled"]
    assert len(cancels) == 1
    assert cancels[0]["reason"] == "deadline" and cancels[0]["started"] is True


# -- router decrement across failover ----------------------------------------


def _router_cfg(pkg, tmp_path, names):
    return pkg.router.RouterConfig(
        listen=str(tmp_path / "router.sock"),
        backends=tuple(
            pkg.router.BackendSpec(n, str(tmp_path / f"{n}.sock")) for n in names
        ),
        probe_interval_s=30.0,
        breaker_failures=5,
        max_failovers=2,
    )


def _ring_key(pkg, text: str) -> str:
    """The router places by the prefix-affinity key, not the raw
    fingerprint (see VerifydRouter._affinity_key)."""
    hist = pkg.entries.prepare(list(pkg.events.iter_history(text)), elide_trivial=True)
    return pkg.router.VerifydRouter._affinity_key(hist, pkg.cache.history_fingerprint(hist))


def test_router_decrements_deadline_across_failover(tmp_path, pkg):
    """A failed attempt burns real wall clock; the next backend must see
    a *smaller* remaining budget, not the client's original number."""
    router = pkg.router.VerifydRouter(_router_cfg(pkg, tmp_path, ("a", "b")))
    calls = []

    def dying(text, **kw):
        calls.append(("dead", kw.get("deadline_s")))
        time.sleep(0.25)  # the budget this attempt burned
        raise pkg.client.VerifydUnavailable("Unavailable", "connect refused")

    def answering(text, **kw):
        calls.append(("live", kw.get("deadline_s")))
        return {"verdict": 0, "outcome": "ok", "cached": False}

    # Whichever node the ring prefers dies first; the other answers.
    order = router._candidate_order(_ring_key(pkg, good_history()))[0]
    order[0].client.submit = dying
    order[1].client.submit = answering

    reply = router._route_submit(
        {"op": "submit", "history": good_history(), "deadline": 2.0}
    )
    assert reply["ok"]["verdict"] == 0 and reply["ok"]["node"] == order[1].name
    assert [kind for kind, _ in calls] == ["dead", "live"]
    first, second = calls[0][1], calls[1][1]
    assert first is not None and first <= 2.0
    # The second attempt's budget is short the ~0.25s the first burned.
    assert second <= first - 0.2


def test_router_refuses_third_node_when_deadline_spent(tmp_path, pkg):
    router = pkg.router.VerifydRouter(_router_cfg(pkg, tmp_path, ("a", "b")))

    def dying(text, **kw):
        time.sleep(0.3)
        raise pkg.client.VerifydUnavailable("Unavailable", "connect refused")

    untouched = []
    order = router._candidate_order(_ring_key(pkg, good_history()))[0]
    order[0].client.submit = dying
    order[1].client.submit = lambda *a, **kw: untouched.append(1)

    reply = router._route_submit(
        {"op": "submit", "history": good_history(), "deadline": 0.2}
    )
    e = reply["err"]
    assert e["class"] == "DeadlineExceeded" and e["reason"] == "deadline"
    assert e["attempts"] == 1
    assert untouched == []  # no stale-clock handoff to a third node
