"""verifyd's durable state in the port — the segment log, the persistent
verdict cache under ``<state_dir>/verdicts``, the admission journal and its
orphan replay — beside the JAX package's.

- The cases of ``tests/test_durability.py``, run over both packages: the
  segment log's round trip, rotation, torn tail and corrupt record; the
  verdict cache's restart, torn tail and foreign records; the journal's
  orphans, compaction and duplicate collapse; and through a daemon, the
  restart that answers from the verdict segments without a checker, the
  orphan replay after an unclean stop (the state dir copied while the job
  sat in the queue, as a kill leaves it), and the invalid orphan reported.
- Side by side, exact: the same journal records and verdicts give the
  same segment bytes and the same orphan lists in each package.
- Across packages: a state dir one package's daemon was killed on replays
  its orphan in the other's daemon, whose verdict segments the first
  package's daemon then answers from.
- A real kill: ``serve --state-dir`` of the port as a process, SIGKILLed
  with a job accepted; ``doctor`` names the orphan, the next boot replays
  it, and the verdict equals an uninterrupted run's.
- The escalation's orphan: a job killed mid-escalation (the inline device
  search on the CPU, every CPU budget spent) replays after the restart to
  the verdict, witness and statistics of an uninterrupted run.
- A full disk: ENOSPC on the journal degrades durability visibly (the
  reply's ``durable: false``, ``/healthz``, the ``stats`` op, the gauge)
  and recovers when the disk does.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import shutil
import signal
import socket as _socket
import struct
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from helpers import H, fold
from s2_verification_tpu.utils import events as jev

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    'VerdictCache': ('service.cache', 'VerdictCache'),
    'history_fingerprint': ('service.cache', 'history_fingerprint'),
    'VerifydClient': ('service.client', 'VerifydClient'),
    'Verifyd': ('service.daemon', 'Verifyd'),
    'VerifydConfig': ('service.daemon', 'VerifydConfig'),
    'JobJournal': ('service.journal', 'JobJournal'),
    'encode_frame': ('service.protocol', 'encode_frame'),
    'ev': ('utils', 'events'),
    'SegmentLog': ('utils.seglog', 'SegmentLog'),
    'prepare': ('checker.entries', 'prepare'),
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
    'test_a_sigkilled_serve_replays_its_orphan_and_doctor_names_it': 120,
    'test_serve_with_every_durable_flag_answers_the_other_packages_cli_live_and_cold': 120,
    'test_an_orphan_killed_mid_escalation_replays_to_an_uninterrupted_runs_answer': 120,
}


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Each case fails at its limit instead of hanging the run."""
    from test_torch_service import time_limit

    with time_limit(LIMITS.get(request.function.__name__, 60)):
        yield


# -- fixtures (mirrors test_service.py) --------------------------------------


def _text(h: H) -> str:
    buf = io.StringIO()
    jev.write_history(h.events, buf)  # the text both packages read
    return buf.getvalue()


def good_history() -> str:
    h = H()
    h.append_ok(1, [111], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([111]))
    h.append_ok(2, [222, 333], tail=3)
    h.read_ok(1, tail=3, stream_hash=fold([111, 222, 333]))
    return _text(h)


def _daemon_cfg(tmp_path, **overrides) -> P.VerifydConfig:
    kw = dict(
        socket_path=str(tmp_path / "verifyd.sock"),
        workers=1,
        device="off",
        time_budget_s=10.0,
        no_viz=True,
        out_dir=str(tmp_path / "viz"),
        stats_log=str(tmp_path / "stats.jsonl"),
        state_dir=str(tmp_path / "state"),
    )
    kw.update(overrides)
    return P.VerifydConfig(**kw)


def _segments(directory) -> list[str]:
    return sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith("seg-")
    )


# -- segment log --------------------------------------------------------------


def test_seglog_round_trip_and_rotation(tmp_path):
    d = str(tmp_path / "log")
    log = P.SegmentLog(d, max_segment_bytes=64)
    payloads = [f"rec-{i}".encode() for i in range(20)]
    for p in payloads:
        log.append(p)
    log.close()
    assert len(_segments(d)) > 1  # 20 records cannot fit one 64-byte segment

    log2 = P.SegmentLog(d)
    assert log2.replay_all() == payloads
    rec = log2.recovery
    assert rec.records == 20 and rec.torn_tail_bytes == 0 and rec.bad_segments == 0
    log2.close()


def test_seglog_max_segments_drops_oldest(tmp_path):
    d = str(tmp_path / "log")
    log = P.SegmentLog(d, max_segment_bytes=64, max_segments=2)
    for i in range(30):
        log.append(f"rec-{i:04d}".encode())
    log.close()
    assert len(_segments(d)) <= 2
    replayed = P.SegmentLog(d).replay_all()
    # the newest records survive; the oldest aged out with their segment
    assert replayed and replayed[-1] == b"rec-0029"
    assert b"rec-0000" not in replayed


def test_seglog_torn_final_record_recovers_prefix(tmp_path):
    d = str(tmp_path / "log")
    log = P.SegmentLog(d)
    for i in range(5):
        log.append(f"rec-{i}".encode())
    log.close()
    seg = _segments(d)[-1]
    # tear mid-record: drop the last 3 bytes (a crashed write)
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 3)

    log2 = P.SegmentLog(d)
    assert log2.replay_all() == [f"rec-{i}".encode() for i in range(4)]
    rec = log2.recovery
    assert rec.torn_tail_bytes > 0 and rec.bad_segments == 0
    # appends after a torn tail go to a FRESH segment — the damaged file
    # is never extended past its valid prefix
    log2.append(b"after-tear")
    log2.close()
    assert len(_segments(d)) == 2
    assert P.SegmentLog(d).replay_all() == [
        b"rec-0",
        b"rec-1",
        b"rec-2",
        b"rec-3",
        b"after-tear",
    ]


def test_seglog_corrupted_record_drops_segment_tail(tmp_path):
    d = str(tmp_path / "log")
    log = P.SegmentLog(d)
    for i in range(5):
        log.append(f"rec-{i}".encode())
    log.close()
    seg = _segments(d)[-1]
    hdr = struct.calcsize("<II")
    rec_size = hdr + len(b"rec-0")
    # flip a payload byte inside record 2: its CRC fails, and nothing
    # past it in the segment can be trusted (lengths may be lies too)
    with open(seg, "r+b") as f:
        f.seek(2 * rec_size + hdr)
        b = f.read(1)
        f.seek(2 * rec_size + hdr)
        f.write(bytes([b[0] ^ 0xFF]))

    log2 = P.SegmentLog(d)
    assert log2.replay_all() == [b"rec-0", b"rec-1"]
    assert log2.recovery.dropped_records_possible
    log2.close()


# -- persistent verdict cache -------------------------------------------------


def test_verdict_cache_restart_round_trip(tmp_path):
    d = str(tmp_path / "verdicts")
    c = P.VerdictCache(capacity=16, persist_dir=d)
    c.put("fp-a", {"verdict": 0, "outcome": "ok"})
    c.put("fp-b", {"verdict": 1, "outcome": "illegal"})
    c.close()

    c2 = P.VerdictCache(capacity=16, persist_dir=d)
    assert c2.loaded == 2
    assert c2.get("fp-a") == {"verdict": 0, "outcome": "ok"}
    assert c2.get("fp-b")["verdict"] == 1
    c2.close()


def test_verdict_cache_torn_tail_keeps_valid_prefix(tmp_path):
    d = str(tmp_path / "verdicts")
    c = P.VerdictCache(capacity=16, persist_dir=d)
    c.put("fp-a", {"verdict": 0})
    c.put("fp-b", {"verdict": 1})
    c.close()
    seg = _segments(d)[-1]
    with open(seg, "r+b") as f:  # tear the final (fp-b) record
        f.truncate(os.path.getsize(seg) - 2)

    c2 = P.VerdictCache(capacity=16, persist_dir=d)
    assert c2.loaded == 1
    assert c2.get("fp-a") == {"verdict": 0}
    assert c2.get("fp-b") is None  # lost verdict = re-search, never wrong
    assert c2.recovery.torn_tail_bytes > 0
    c2.close()


def test_verdict_cache_foreign_records_skipped(tmp_path):
    d = str(tmp_path / "verdicts")
    log = P.SegmentLog(d)
    log.append(b"not json at all")
    log.append(json.dumps({"fp": "fp-x", "p": {"verdict": 2}}).encode())
    log.append(json.dumps({"wrong": "shape"}).encode())
    log.close()
    c = P.VerdictCache(capacity=16, persist_dir=d)
    assert c.loaded == 1 and c.get("fp-x") == {"verdict": 2}
    c.close()


# -- admission journal --------------------------------------------------------


def test_journal_orphans_and_compaction(tmp_path):
    d = str(tmp_path / "journal")
    j = P.JobJournal(d)
    j.accept(job=1, fingerprint="fp-1", client="a", priority=10, history="h1")
    j.accept(job=2, fingerprint="fp-2", client="b", priority=5, history="h2")
    j.accept(job=3, fingerprint="fp-3", client="c", priority=1, history="h3")
    j.done(job=1, fingerprint="fp-1", verdict=0, outcome="ok")
    j.reject(job=3)  # queue-full after the accept landed: record closed
    j.close()

    j2 = P.JobJournal(d)  # a new boot
    orphans = j2.orphans()
    assert [o["fp"] for o in orphans] == ["fp-2"]
    assert orphans[0]["history"] == "h2" and orphans[0]["client"] == "b"

    # re-accept under the new boot, then compact: prior boot disappears
    j2.accept(job=1, fingerprint="fp-2", client="b", priority=5, history="h2")
    j2.compact()
    j2.done(job=1, fingerprint="fp-2", verdict=0, outcome="ok")
    j2.close()
    assert P.JobJournal(d).orphans() == []


def test_journal_duplicate_fingerprints_collapse(tmp_path):
    j = P.JobJournal(str(tmp_path / "journal"))
    j.accept(job=1, fingerprint="fp-same", client="a", priority=10, history="h")
    j.accept(job=2, fingerprint="fp-same", client="a", priority=10, history="h")
    j.close()
    j2 = P.JobJournal(str(tmp_path / "journal"))
    assert len(j2.orphans()) == 1  # one re-run; the cache answers the twin
    j2.close()


# -- daemon-level restart behavior -------------------------------------------


def test_daemon_restart_answers_cached_without_checker(tmp_path):
    good = good_history()
    cfg = _daemon_cfg(tmp_path)
    with P.Verifyd(cfg):
        client = P.VerifydClient(cfg.socket_path, timeout=120)
        first = client.submit(good, client="dur")
        assert first["verdict"] == 0 and first["cached"] is False

    cfg2 = _daemon_cfg(tmp_path, socket_path=str(tmp_path / "v2.sock"))
    with P.Verifyd(cfg2) as daemon2:
        assert daemon2.cache.loaded == 1
        client = P.VerifydClient(cfg2.socket_path, timeout=120)
        again = client.submit(good, client="dur")
        assert again["verdict"] == 0 and again["cached"] is True
        snap = client.stats()
        # the fingerprint was answered at admission: no job ever ran
        assert snap["completed"] == 0 and snap["cache_loaded"] == 1


def test_daemon_orphan_replay_after_unclean_stop(tmp_path):
    good = good_history()
    # Boot 1: workers=0 — the job is accepted (journaled) but never run.
    # A copy of the state dir taken while it sits in the queue is what a
    # kill at that instant leaves on disk (every append is flushed): no
    # done record.  A worker then drains the job, so none is parked when
    # the daemon stops.
    cfg = _daemon_cfg(tmp_path, workers=0, state_dir=str(tmp_path / "live"))
    with P.Verifyd(cfg) as daemon:
        with _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM) as s:
            s.connect(cfg.socket_path)
            s.sendall(
                P.encode_frame({"op": "submit", "history": good, "client": "w"})
            )
            deadline = time.monotonic() + 10
            while daemon.stats.snapshot()["admitted"] < 1:
                assert time.monotonic() < deadline, "job never admitted"
                time.sleep(0.01)
            shutil.copytree(tmp_path / "live", tmp_path / "state")
            daemon.scheduler.start(1)
            assert json.loads(s.makefile().readline())["ok"]["verdict"] == 0

    # Boot 2 (on the copy): replay must re-run the orphan and cache its
    # verdict.
    cfg2 = _daemon_cfg(tmp_path, socket_path=str(tmp_path / "v2.sock"))
    with P.Verifyd(cfg2) as daemon2:
        client = P.VerifydClient(cfg2.socket_path, timeout=120)
        deadline = time.monotonic() + 60
        while True:
            snap = client.stats()
            if snap["orphans_recovered"] >= 1 and snap["completed"] >= 1:
                break
            assert time.monotonic() < deadline, f"orphan never re-ran: {snap}"
            time.sleep(0.05)
        reply = client.submit(good, client="w2")
        assert reply["verdict"] == 0 and reply["cached"] is True
        # at-least-once promise kept and closed: the journal is clean now
        assert daemon2.journal.orphans() == []

    # Boot 3: nothing left to recover.
    cfg3 = _daemon_cfg(tmp_path, socket_path=str(tmp_path / "v3.sock"))
    with P.Verifyd(cfg3) as daemon3:
        assert daemon3.stats.snapshot()["orphans_recovered"] == 0


def test_daemon_orphan_with_invalid_history_is_reported(tmp_path):
    state = str(tmp_path / "state")
    j = P.JobJournal(os.path.join(state, "journal"))
    j.accept(job=1, fingerprint="fp-junk", client="x", priority=10, history="{broken\n")
    j.close()
    cfg = _daemon_cfg(tmp_path)
    with P.Verifyd(cfg) as daemon:
        snap = daemon.stats.snapshot()
        assert snap["orphans_recovered"] == 0  # reported, not resurrected
    with open(tmp_path / "stats.jsonl", encoding="utf-8") as f:
        events = [json.loads(line) for line in f if line.strip()]
    assert any(e["ev"] == "orphan_invalid" for e in events)


def test_fingerprint_of_history(tmp_path):
    """Regression guard: the durable cache keys on the same fingerprint
    across process lifetimes (no per-boot salt may sneak in)."""

    hist = P.prepare(list(P.ev.iter_history(good_history())), elide_trivial=True)
    assert P.history_fingerprint(hist) == P.history_fingerprint(hist)


# -- side by side, across packages, and a real kill ---------------------------

ROOT = Path(__file__).resolve().parent.parent
PORT = PACKAGES[1]


def other(package: str) -> str:
    return PACKAGES[1 - PACKAGES.index(package)]


def _mod(package: str, path: str):
    return importlib.import_module(f"{package}.{path}")


def _seg_bytes(directory) -> dict:
    return {p.name: p.read_bytes() for p in sorted(Path(directory).glob("seg-*"))}


def _journal_run(package: str, directory, boot: str) -> list:
    j = _mod(package, "service.journal").JobJournal(str(directory))
    j.boot = boot
    for job, fp in ((1, "fp-1"), (2, "fp-2"), (3, "fp-3"), (4, "fp-2")):
        j.accept(job=job, fingerprint=fp, client=f"c{job}", priority=job, history=f"h{job}\n")
    j.started(job=2, fingerprint="fp-2")
    j.done(job=1, fingerprint="fp-1", verdict=0, outcome="ok")
    j.reject(job=3)
    j.close()
    j2 = _mod(package, "service.journal").JobJournal(str(directory))
    try:
        return j2.orphans()
    finally:
        j2.close()


def test_the_same_records_give_the_same_journal_and_verdict_bytes(tmp_path, package):
    mine = _journal_run(package, tmp_path / "a" / "journal", "0123456789abcdef")
    theirs = _journal_run(other(package), tmp_path / "b" / "journal", "0123456789abcdef")
    assert mine == theirs and [o["fp"] for o in mine] == ["fp-2"] and mine[0]["started"]
    assert _seg_bytes(tmp_path / "a" / "journal") == _seg_bytes(tmp_path / "b" / "journal")
    for name, pkg in (("a", package), ("b", other(package))):
        c = _mod(pkg, "service.cache").VerdictCache(capacity=16, persist_dir=str(tmp_path / name / "verdicts"))
        c.put("fp-a", {"verdict": 0, "outcome": "ok", "backend": "native", "ops": 4})
        c.put("fp-b", {"verdict": 1, "outcome": "illegal", "backend": "device-inline"})
        c.close()
    assert _seg_bytes(tmp_path / "a" / "verdicts") == _seg_bytes(tmp_path / "b" / "verdicts")


def test_a_state_dir_killed_under_one_package_replays_in_the_other(tmp_path, package):
    """``package``'s daemon is killed with a job queued (its state dir
    copied then); the other package's daemon replays the orphan and writes
    its verdict; ``package``'s daemon then answers it from those verdict
    segments with no checker."""
    good = good_history()
    cfg = _daemon_cfg(tmp_path, workers=0, state_dir=str(tmp_path / "live"))
    with P.Verifyd(cfg) as daemon:
        with _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM) as s:
            s.connect(cfg.socket_path)
            s.sendall(P.encode_frame({"op": "submit", "history": good, "client": "killed"}))
            deadline = time.monotonic() + 10
            while daemon.stats.snapshot()["admitted"] < 1:
                assert time.monotonic() < deadline, "job never admitted"
                time.sleep(0.01)
            shutil.copytree(tmp_path / "live", tmp_path / "state")
            daemon.scheduler.start(1)
            assert json.loads(s.makefile().readline())["ok"]["verdict"] == 0
    theirs = _mod(other(package), "service.daemon")
    tcfg = theirs.VerifydConfig(socket_path=str(tmp_path / "o.sock"), device="off", no_viz=True,
                                stats_log=None, state_dir=str(tmp_path / "state"))
    with theirs.Verifyd(tcfg) as d2:
        deadline = time.monotonic() + 30
        while d2.stats.snapshot()["completed"] < 1:
            assert time.monotonic() < deadline, "the orphan never replayed"
            time.sleep(0.05)
        assert d2.stats.snapshot()["orphans_recovered"] == 1
    cfg3 = _daemon_cfg(tmp_path, socket_path=str(tmp_path / "v3.sock"))
    with P.Verifyd(cfg3) as d3:
        assert d3.stats.snapshot()["orphans_recovered"] == 0
        again = P.VerifydClient(cfg3.socket_path, timeout=60).submit(good, client="retry")
        assert again["verdict"] == 0 and again["cached"] is True
        assert d3.stats.snapshot()["completed"] == 0


@pytest.mark.parametrize("package", [PORT], indirect=True)
def test_a_sigkilled_serve_replays_its_orphan_and_doctor_names_it(tmp_path, package, capsys):
    """The port's ``serve --state-dir`` as a process, with no worker, is
    SIGKILLed once it has accepted a job: both packages' ``doctor`` report
    an unclean death naming the orphan, and the next boot replays it to
    the verdict an uninterrupted daemon gives."""
    good = good_history()
    state, sock = tmp_path / "state", tmp_path / "v.sock"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])}
    proc = subprocess.Popen(
        [sys.executable, "-m", "s2_verification_tpu_torch", "serve", "-socket", str(sock), "--device", "off",
         "--workers", "0", "--state-dir", str(state), "--stats-log", "", "--no-viz"],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.monotonic() + 60
        while not sock.exists():
            assert proc.poll() is None and time.monotonic() < deadline, "serve never came up"
            time.sleep(0.05)
        client = P.VerifydClient(str(sock), timeout=30)
        with _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM) as s:
            s.connect(str(sock))
            s.sendall(P.encode_frame({"op": "submit", "history": good, "client": "killed"}))
            while client.stats()["admitted"] < 1:
                assert time.monotonic() < deadline, "job never admitted"
                time.sleep(0.02)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    sock.unlink()
    for pkg in PACKAGES:
        capsys.readouterr()
        assert _mod(pkg, "cli").main(["doctor", "--state-dir", str(state), "--tail", "5"]) == 1
        report = capsys.readouterr().out
        assert "UNCLEAN DEATH" in report
        assert "orphaned journal entries (accepted, never closed): 1" in report
        assert "client=killed" in report
    with P.Verifyd(_daemon_cfg(tmp_path, socket_path=str(sock), state_dir=str(state))) as d:
        deadline = time.monotonic() + 30
        while d.stats.snapshot()["completed"] < 1:
            assert time.monotonic() < deadline, "the orphan never replayed"
            time.sleep(0.05)
        replayed = P.VerifydClient(str(sock), timeout=30).submit(good, client="retry")
    assert replayed["cached"] is True
    (tmp_path / "fresh").mkdir()
    with P.Verifyd(_daemon_cfg(tmp_path / "fresh", state_dir=None)) as d:
        fresh = P.VerifydClient(d.cfg.socket_path, timeout=30).submit(good, client="fresh")
    assert {f: replayed[f] for f in ("verdict", "outcome", "backend", "ops", "shape")} == {
        f: fresh[f] for f in ("verdict", "outcome", "backend", "ops", "shape")
    }


@pytest.mark.parametrize("package", [PORT], indirect=True)
def test_an_orphan_killed_mid_escalation_replays_to_an_uninterrupted_runs_answer(tmp_path, package, monkeypatch):
    """The journal a daemon killed during an inline escalation leaves (the
    job accepted and started, no done) replays after the restart: the
    boot charges one crash to the fingerprint, and the replayed escalation
    on the CPU gives the verdict, witness, steps and statistics of the
    same job in a daemon never killed."""
    from s2_verification_tpu_torch.collector.adversarial import adversarial_events

    scheduler, oracle = _mod(package, "service.scheduler"), _mod(package, "checker.oracle")
    seen = []
    real_finish = scheduler.Scheduler._finish

    def finish(self, job, res, backend, **kw):
        seen.append(res)
        return real_finish(self, job, res, backend, **kw)

    monkeypatch.setattr(scheduler, "_cpu_check",
                        lambda hist, budget, **kw: (oracle.CheckResult(oracle.CheckOutcome.UNKNOWN), "native"))
    monkeypatch.setattr(scheduler.Scheduler, "_finish", finish)
    buf = io.StringIO()
    P.ev.write_history(adversarial_events(6, batch=4, seed=0), buf)
    text = buf.getvalue()
    fp = P.history_fingerprint(P.prepare(list(P.ev.iter_history(text)), elide_trivial=True))
    kw = dict(device="inline", torch_device="cpu", time_budget_s=0.01, profile=True)

    (tmp_path / "fresh").mkdir()
    with P.Verifyd(_daemon_cfg(tmp_path / "fresh", state_dir=None, **kw)) as d:
        fresh = P.VerifydClient(d.cfg.socket_path, timeout=120).submit(text, client="fresh")
    j = P.JobJournal(str(tmp_path / "state" / "journal"))
    j.accept(job=7, fingerprint=fp, client="killed", priority=10, history=text)
    j.started(job=7, fingerprint=fp)
    j.close()
    with P.Verifyd(_daemon_cfg(tmp_path, **kw)) as d:
        assert d.quarantine.crash_count(fp) == 1
        deadline = time.monotonic() + 120
        while d.stats.snapshot()["completed"] < 1:
            assert time.monotonic() < deadline, "the orphan never replayed"
            time.sleep(0.05)
        replayed = P.VerifydClient(d.cfg.socket_path, timeout=120).submit(text, client="retry")
        # the conclusive replay forgave the boot's crash
        assert d.quarantine.crash_count(fp) == 0
    fresh_res, replay_res = seen
    assert replayed["cached"] is True and fresh["backend"] == "device-inline"
    for f in ("verdict", "outcome", "backend", "ops", "shape"):
        assert replayed[f] == fresh[f], f
    assert replayed["profile"]["layers"] == fresh["profile"]["layers"]
    assert replay_res.linearization == fresh_res.linearization and replay_res.steps == fresh_res.steps
    for f in ("layers", "max_frontier", "expanded", "auto_closed", "pruned"):
        assert getattr(replay_res.stats, f) == getattr(fresh_res.stats, f), f


DURABLE_FLAGS = ("state_dir", "fsync", "telemetry_dir", "telemetry_sample", "metrics_port", "dashboard_sample",
                 "alert_url", "alert_rule", "alert_dedup", "quarantine_threshold", "drain_timeout")


def test_serve_takes_the_durability_and_ops_flags_with_the_same_defaults(package):
    def serve_defaults(pkg):
        parser = _mod(pkg, "cli").build_parser()
        ns = parser.parse_args(["serve", "-socket", "/nonexistent.sock"])
        return {f: getattr(ns, f) for f in DURABLE_FLAGS}

    mine = serve_defaults(package)
    assert mine == serve_defaults(other(package))
    assert mine["state_dir"] is None and mine["metrics_port"] is None and mine["quarantine_threshold"] == 3
    ns = _mod(package, "cli").build_parser().parse_args(
        ["serve", "-socket", "s", "--state-dir", "D", "--fsync", "--telemetry-dir", "T", "--metrics-port", "0",
         "--alert-url", "http://127.0.0.1:9/a", "--alert-rule", "done", "--alert-rule", "done.wall_s>30"]
    )
    assert (ns.state_dir, ns.fsync, ns.telemetry_dir, ns.metrics_port, ns.alert_url, ns.alert_rule) == (
        "D", True, "T", 0, "http://127.0.0.1:9/a", ["done", "done.wall_s>30"]
    )


def test_serve_with_every_durable_flag_answers_the_other_packages_cli_live_and_cold(tmp_path, package, capsys):
    """``package``'s ``serve`` with ``--state-dir --fsync --telemetry-dir
    --metrics-port 0 --alert-url --alert-rule`` as a process: /metrics and
    /dashboard answer, and the other package's ``tsq``, ``profiles`` and
    ``quarantine`` read it through ``--socket``; after a clean shutdown the
    same commands read the directories cold and ``doctor`` exits 0."""
    import urllib.request

    good = good_history()
    sock, state, tel = tmp_path / "v.sock", tmp_path / "state", tmp_path / "tel"
    hist = tmp_path / "good.jsonl"
    hist.write_text(good)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", package, "serve", "-socket", str(sock), "--device", "off", "--no-viz",
         "--stats-log", "", "--state-dir", str(state), "--fsync", "--telemetry-dir", str(tel),
         "--telemetry-sample", "0.1", "--metrics-port", "0", "--alert-url", "http://127.0.0.1:9/unreachable",
         "--alert-rule", "done.wall_s>3600"],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    theirs = _mod(other(package), "cli")

    def said(argv) -> str:
        capsys.readouterr()
        assert theirs.main(argv) == 0, argv
        return capsys.readouterr().out

    try:
        deadline = time.monotonic() + 90
        while not sock.exists():
            assert proc.poll() is None and time.monotonic() < deadline, "serve never came up"
            time.sleep(0.05)
        assert theirs.main(["submit", "-file", str(hist), "-socket", str(sock), "-no-viz"]) == 0
        client = P.VerifydClient(str(sock), timeout=30)
        port = client.stats()["metrics_port"]
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "verifyd_jobs_completed_total" in metrics
        assert "<svg" in urllib.request.urlopen(f"http://127.0.0.1:{port}/dashboard", timeout=10).read().decode()
        while json.loads(said(["tsq", "--socket", str(sock), "--metric", "jobs_completed", "--json"]))["points"] < 1:
            assert time.monotonic() < deadline, "no telemetry point"
            time.sleep(0.1)
        live = json.loads(said(["profiles", "--socket", str(sock), "--export", "-"]).splitlines()[0])
        assert live["verdict"] == 0 and live["client"] == "cli"
        assert said(["quarantine", "list", "--socket", str(sock)]).strip() == "quarantine empty"
        client.shutdown()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    cold = json.loads(said(["tsq", "--telemetry-dir", str(tel), "--metric", "jobs_completed", "--json"]))
    assert cold["series"]['verifyd_jobs_completed_total{verdict="ok"}'][-1][1] == 1.0
    assert json.loads(said(["profiles", "--state-dir", str(state), "--export", "-"]).splitlines()[0]) == live
    assert said(["quarantine", "list", "--state-dir", str(state)]).strip() == "quarantine empty"
    assert "clean shutdown" in said(["doctor", "--state-dir", str(state)])


def test_a_full_disk_degrades_durability_visibly_and_recovers(tmp_path, package, monkeypatch):
    """ENOSPC injected on the journal (``VERIFYD_FAULT_ENOSPC_FILE``): the
    job is still answered but with ``durable: false``, ``/healthz`` names
    the journal, the ``stats`` op and the gauge show the degraded writer;
    with the disk back, the next append re-arms it and health clears."""
    import urllib.error
    import urllib.request

    fault = tmp_path / "enospc"
    fault.write_text("journal\n")
    monkeypatch.setenv("VERIFYD_FAULT_ENOSPC_FILE", str(fault))
    cfg = _daemon_cfg(tmp_path, metrics_port=0)
    with P.Verifyd(cfg) as d:
        d._journal_writer.reprobe_s = 0.0  # re-probe on every append
        client = P.VerifydClient(cfg.socket_path, timeout=60)
        first = client.submit(good_history(), client="full")
        assert first["verdict"] == 0 and first["durable"] is False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{d.metrics_port}/healthz", timeout=10)
        assert ei.value.code == 503
        assert "journal" in json.dumps(json.loads(ei.value.read())["reasons"])
        assert client.stats()["writer_degraded_events"] == 1
        assert d.registry.get("verifyd_writer_degraded").value(writer="journal") == 1
        fault.unlink()
        h = H()
        h.append_ok(1, [9], tail=1)
        buf = io.StringIO()
        jev.write_history(h.events, buf)
        second = client.submit(buf.getvalue(), client="freed")
        assert second["durable"] is True
        assert d.health.healthz()[0] is True
        assert d.registry.get("verifyd_writer_degraded").value(writer="journal") == 0
    events = [json.loads(line)["ev"] for line in open(tmp_path / "stats.jsonl", encoding="utf-8")]
    assert events.count("writer_degraded") == 1 and events.count("writer_recovered") == 1
