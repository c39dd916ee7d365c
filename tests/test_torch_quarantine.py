"""The poison-job quarantine ledger (``QuarantineStore`` under
``<state_dir>/quarantine``, the orphan replay's poison accounting, the
scheduler's ``note_success`` / ``note_crash``) beside the JAX package's.

- The cases of ``tests/test_quarantine.py``, run over both packages: the
  store's counts across reboots and release, a poison fingerprint
  quarantined within three boots while an innocent orphan of the same
  journal replays, and a queued-only orphan never charged.
- Across packages: a ledger and journal either package's daemon left
  behind are read by the other's daemon (the same crash counts, the same
  quarantine) and by its cold ``quarantine`` CLI, and the ledger file's
  bytes are the same for the same crashes.
- The one live-crash path: a supervised child killed past its attempt
  timeout (torch device ``cpu``) charges a ``child`` crash to its
  fingerprint, and a conclusive verdict forgives it.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import time
from types import SimpleNamespace

import pytest

from helpers import H, fold
from s2_verification_tpu.utils import events as jev

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    'prepare': ('checker.entries', 'prepare'),
    'history_fingerprint': ('service.cache', 'history_fingerprint'),
    'VerifydClient': ('service.client', 'VerifydClient'),
    'VerifydError': ('service.client', 'VerifydError'),
    'Verifyd': ('service.daemon', 'Verifyd'),
    'VerifydConfig': ('service.daemon', 'VerifydConfig'),
    'JobJournal': ('service.journal', 'JobJournal'),
    'QuarantineStore': ('service.overload', 'QuarantineStore'),
    'ev': ('utils', 'events'),
    'builtin_rules': ('obs.alerts', 'builtin_rules'),
}


@pytest.fixture(autouse=True, params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    for name, (mod, attr) in _NAMES.items():
        m = importlib.import_module(f"{request.param}.{mod}" if mod else request.param)
        setattr(P, name, getattr(m, attr) if attr else m)
    yield request.param


#: the time limits of the cases that need more than 60 s
LIMITS = {
    'test_a_killed_supervised_child_counts_one_child_crash': 120,
}


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Each case fails at its limit instead of hanging the run."""
    from test_torch_service import time_limit

    with time_limit(LIMITS.get(request.function.__name__, 60)):
        yield


# -- fixtures ----------------------------------------------------------------


def _text(h: H) -> str:
    buf = io.StringIO()
    jev.write_history(h.events, buf)  # the text both packages read
    return buf.getvalue()


def good_history(base: int = 100) -> str:
    h = H()
    h.append_ok(1, [base + 1], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([base + 1]))
    return _text(h)


def _fingerprint(text: str) -> str:
    return P.history_fingerprint(
        P.prepare(list(P.ev.iter_history(text)), elide_trivial=True)
    )


def _cfg(tmp_path, **overrides) -> P.VerifydConfig:
    kw = dict(
        socket_path=str(tmp_path / "verifyd.sock"),
        workers=1,
        device="off",
        time_budget_s=10.0,
        no_viz=True,
        out_dir=str(tmp_path / "viz"),
        stats_log=str(tmp_path / "stats.jsonl"),
        state_dir=str(tmp_path / "state"),
        quarantine_threshold=3,
    )
    kw.update(overrides)
    return P.VerifydConfig(**kw)


def _events(tmp_path) -> list[dict]:
    with open(tmp_path / "stats.jsonl", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _crash(daemon: P.Verifyd) -> None:
    """Tear a constructed-but-never-entered daemon down the way SIGKILL
    would leave it: durable files closed mid-promise, no done records,
    no graceful drain."""
    daemon.journal.close()
    daemon.cache.close()
    if daemon.flight is not None:
        daemon.flight.close()
    if daemon.archive is not None:
        daemon.archive.close()
    if daemon._stats_file is not None:
        with contextlib.suppress(OSError):
            daemon._stats_file.close()


# -- the store itself --------------------------------------------------------


def test_store_counts_persist_and_release(tmp_path):
    s = P.QuarantineStore(str(tmp_path / "q"), threshold=2)
    fp = "ab" * 32
    assert s.note_crash(fp) == 1
    assert not s.is_quarantined(fp)

    again = P.QuarantineStore(str(tmp_path / "q"), threshold=2)  # "reboot"
    assert again.crash_count(fp) == 1  # the ledger survived
    assert again.note_crash(fp) == 2
    assert again.is_quarantined(fp)
    entry = again.get(fp)
    assert entry["fingerprint"] == fp and entry["crashes"] == 2

    assert again.release(fp) is True
    assert not again.is_quarantined(fp)
    assert again.release(fp) is False  # idempotent: nothing held

    # A conclusive verdict forgives accumulated warm counts.
    s2 = P.QuarantineStore(str(tmp_path / "q2"), threshold=3)
    s2.note_crash(fp)
    s2.note_crash(fp)
    s2.note_success(fp)
    assert s2.crash_count(fp) == 0


# -- the crash-loop scenario across boots ------------------------------------


def test_poison_quarantined_within_three_boots_innocent_replays(tmp_path):
    """A fingerprint in flight at three successive daemon deaths is
    quarantined; an unrelated orphan sharing the journal still replays
    and completes; release re-admits the poison fingerprint."""
    poison_text = good_history(1000)
    innocent_text = good_history(2000)
    poison_fp = _fingerprint(poison_text)
    innocent_fp = _fingerprint(innocent_text)
    cfg = _cfg(tmp_path)

    # Boot 1 dies mid-job: write the journal the way a killed daemon
    # leaves it — poison accepted AND started, innocent only accepted.
    journal = P.JobJournal(str(tmp_path / "state" / "journal"))
    journal.accept(
        job=1, fingerprint=poison_fp, client="poison", priority=10,
        history=poison_text,
    )
    journal.started(job=1, fingerprint=poison_fp)
    journal.accept(
        job=2, fingerprint=innocent_fp, client="innocent", priority=10,
        history=innocent_text,
    )
    journal.close()

    # Boots 2 and 3: recovery re-admits both orphans and charges the
    # started one a crash; a worker picks the poison job up (run record)
    # and the daemon dies again before it can finish.
    for boot, expected_crashes in ((2, 1), (3, 2)):
        d = P.Verifyd(cfg)
        d._recover_orphans()
        assert d.quarantine.crash_count(poison_fp) == expected_crashes
        assert not d.quarantine.is_quarantined(poison_fp)
        # Both orphans were re-admitted — the innocent one is not
        # filtered, it simply never gets a run record.
        batch = d.queue.get_batch(batch_max=16, timeout=1.0)
        batch += d.queue.get_batch(batch_max=16, timeout=0.1)
        by_fp = {j.fingerprint: j for j in batch}
        assert set(by_fp) == {poison_fp, innocent_fp}, f"boot {boot}"
        d.journal.started(
            job=by_fp[poison_fp].id, fingerprint=poison_fp
        )
        _crash(d)

    # Boot 4: the third charged crash crosses the threshold.  The poison
    # fingerprint is quarantined instead of replayed; the innocent
    # orphan replays through a live worker and completes.
    with P.Verifyd(cfg) as d:
        assert d.quarantine.is_quarantined(poison_fp)
        assert d.quarantine.crash_count(poison_fp) == 3
        client = P.VerifydClient(cfg.socket_path, timeout=60)

        # The innocent orphan's verdict lands in the durable cache; the
        # original submitter's retry answers warm.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if d.stats.snapshot()["completed"] >= 1:
                break
            time.sleep(0.05)
        reply = client.submit(innocent_text, client="retry")
        assert reply["verdict"] == 0 and reply["cached"] is True

        # A fresh submit of the poison history is refused outright —
        # definite, so a router never fails it over to poison a peer.
        with pytest.raises(P.VerifydError) as ei:
            client.submit(poison_text, client="retry")
        assert ei.value.cls == "Quarantined"
        assert ei.value.extra.get("fingerprint") == poison_fp
        assert ei.value.extra.get("crashes") == 3

        # Operator loop: list -> release -> the job completes normally.
        listing = client.quarantine("list")
        assert listing["threshold"] == 3
        assert [e["fingerprint"] for e in listing["entries"]] == [poison_fp]
        inspect = client.quarantine("inspect", poison_fp)
        assert inspect["crashes"] == 3
        released = client.quarantine("release", poison_fp)
        assert released["released"] is True
        reply = client.submit(poison_text, client="retry")
        assert reply["verdict"] == 0
        # The conclusive verdict forgave the ledger entry for good.
        assert d.quarantine.crash_count(poison_fp) == 0
        assert d.registry.get("verifyd_quarantine_size").value() == 0

    events = _events(tmp_path)
    quarantined = [e for e in events if e["ev"] == "job_quarantined"]
    assert len(quarantined) == 1
    assert quarantined[0]["fingerprint"] == poison_fp
    assert quarantined[0]["crashes"] == 3
    skipped = [e for e in events if e["ev"] == "orphan_quarantined"]
    assert len(skipped) == 1 and skipped[0]["fingerprint"] == poison_fp
    # The alert engine's builtin rules page on the quarantine event.

    assert any(r.event == "job_quarantined" for r in P.builtin_rules())


def test_queued_only_orphan_is_never_charged(tmp_path):
    """An orphan with no run record — the daemon died before any worker
    touched it — accrues no crash count no matter how many boots it
    survives in the journal."""
    text = good_history(3000)
    fp = _fingerprint(text)
    cfg = _cfg(tmp_path, workers=1)

    journal = P.JobJournal(str(tmp_path / "state" / "journal"))
    journal.accept(
        job=1, fingerprint=fp, client="queued", priority=10, history=text
    )
    journal.close()

    for _ in range(4):  # well past the threshold of 3
        d = P.Verifyd(cfg)
        d._recover_orphans()
        assert d.quarantine.crash_count(fp) == 0
        _crash(d)

    with P.Verifyd(cfg) as d:
        assert not d.quarantine.is_quarantined(fp)
        client = P.VerifydClient(cfg.socket_path, timeout=60)
        assert client.submit(text, client="retry")["verdict"] == 0


# -- across packages and the live child crash ---------------------------------

PORT = PACKAGES[1]


def other(package: str) -> str:
    return PACKAGES[1 - PACKAGES.index(package)]


def _mod(package: str, path: str):
    return importlib.import_module(f"{package}.{path}")


def test_a_crash_loop_left_by_one_package_is_quarantined_by_the_other(tmp_path, package, capsys):
    """A journal left with the poison job running, then two boots of
    ``package``'s daemon that die running it again; the other package's
    daemon boots on the same state dir, charges the third crash, quarantines the poison fingerprint, replays the innocent orphan
    and names the poison in its cold ``quarantine list``."""
    poison_text, innocent_text = good_history(4000), good_history(5000)
    poison_fp, innocent_fp = _fingerprint(poison_text), _fingerprint(innocent_text)
    cfg = _cfg(tmp_path)
    journal = P.JobJournal(str(tmp_path / "state" / "journal"))
    journal.accept(job=1, fingerprint=poison_fp, client="poison", priority=10, history=poison_text)
    journal.started(job=1, fingerprint=poison_fp)
    journal.accept(job=2, fingerprint=innocent_fp, client="innocent", priority=10, history=innocent_text)
    journal.close()
    for _ in range(2):
        d = P.Verifyd(cfg)
        d._recover_orphans()
        batch = d.queue.get_batch(batch_max=16, timeout=1.0)
        batch += d.queue.get_batch(batch_max=16, timeout=0.1)
        poison_job = next(j for j in batch if j.fingerprint == poison_fp)
        d.journal.started(job=poison_job.id, fingerprint=poison_fp)
        _crash(d)

    theirs = _mod(other(package), "service.daemon")
    their_cfg = theirs.VerifydConfig(
        socket_path=str(tmp_path / "o.sock"), device="off", no_viz=True, state_dir=str(tmp_path / "state"),
        stats_log=str(tmp_path / "stats.jsonl"), quarantine_threshold=3,
    )
    with theirs.Verifyd(their_cfg) as d2:
        assert d2.quarantine.is_quarantined(poison_fp)
        assert d2.quarantine.crash_count(poison_fp) == 3
        deadline = time.monotonic() + 30
        while d2.stats.snapshot()["completed"] < 1:
            assert time.monotonic() < deadline, "the innocent orphan never replayed"
            time.sleep(0.05)
        client = _mod(other(package), "service.client").VerifydClient(their_cfg.socket_path, timeout=60)
        assert client.submit(innocent_text)["cached"] is True
    capsys.readouterr()
    assert _mod(other(package), "cli").main(["quarantine", "list", "--state-dir", str(tmp_path / "state")]) == 0
    listing = capsys.readouterr().out
    assert poison_fp[:36] in listing and "1 quarantined (threshold 3)" in listing
    assert P.QuarantineStore(str(tmp_path / "state" / "quarantine")).list()[0]["fingerprint"] == poison_fp


def test_the_same_crashes_write_the_same_ledger_bytes(tmp_path, package, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1722.5)
    paths = []
    for name, pkg in (("a", package), ("b", other(package))):
        store = _mod(pkg, "service.overload").QuarantineStore(str(tmp_path / name), threshold=2)
        for fp, kind in (("ab" * 32, "boot"), ("cd" * 32, "child"), ("ab" * 32, "child"), ("ef" * 32, "boot")):
            store.note_crash(fp, kind=kind)
        store.note_success("ef" * 32)
        paths.append(tmp_path / name / "quarantine.json")
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert json.loads(paths[0].read_text())["quarantined"]["ab" * 32]["kinds"] == {"boot": 1, "child": 1}


@pytest.mark.parametrize("package", [PORT], indirect=True)
def test_a_killed_supervised_child_counts_one_child_crash(tmp_path, package, monkeypatch):
    """With every CPU budget spent, the escalation's supervised child (torch
    device ``cpu``) is killed past a 0.3 s attempt timeout with no restart:
    the ledger charges one ``child`` crash to the fingerprint, below the
    threshold, and the job answers UNKNOWN; a conclusive verdict of the
    same history forgives it."""
    scheduler = _mod(package, "service.scheduler")
    oracle = _mod(package, "checker.oracle")
    real = scheduler._cpu_check
    monkeypatch.setattr(scheduler, "_cpu_check",
                        lambda hist, budget, **kw: (oracle.CheckResult(oracle.CheckOutcome.UNKNOWN), "native"))
    text = good_history(6000)
    fp = _fingerprint(text)
    cfg = _cfg(tmp_path, device="supervised", torch_device="cpu", attempt_timeout_s=0.3, max_restarts=0,
               time_budget_s=0.01, spool_dir=str(tmp_path / "spool"))
    with P.Verifyd(cfg) as d:
        client = P.VerifydClient(cfg.socket_path, timeout=60)
        first = client.submit(text, client="child")
        assert first["verdict"] == 2
        assert d.quarantine.crash_count(fp) == 1
        assert not d.quarantine.is_quarantined(fp)
        monkeypatch.setattr(scheduler, "_cpu_check", real)
        assert client.submit(text, client="again")["verdict"] == 0
        assert d.quarantine.crash_count(fp) == 0
    events = _events(tmp_path)
    assert "degrade" in [e["ev"] for e in events]
    with open(tmp_path / "state" / "quarantine" / "quarantine.json", encoding="utf-8") as f:
        assert json.load(f) == {"crashes": {}, "quarantined": {}}
