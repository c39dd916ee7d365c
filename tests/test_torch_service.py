"""verifyd in the port (service/daemon.py and the modules under it), held
against the JAX package's daemon.

- The cases of ``tests/test_service.py`` (round trip against the one-shot
  CLI, the verdict cache, backpressure, decode errors and artifacts, the
  execution-time cache twin, ``serve`` / ``submit`` as subprocesses, the
  queue and cache units, a wedged escalation degrading to the CPU close),
  each run over both packages.  Its ``shape_key`` and supervision cases
  are in ``test_torch_supervise.py``, its stats cases in
  ``test_torch_obs.py``.
- The ``watch`` stream (``tests/test_progress.py``): the heartbeat table's
  EWMA / ETA math and partition lookup, and ``watch`` through the daemon
  on a live job, an unknown job and with heartbeats off, over both
  packages.
- Parity across the packages, all exact:
  - ``encode_frame`` / ``sign_frame`` bytes and ``history_fingerprint``
    on seeded collector histories (regular, match-seq-num, fencing),
    adversarial k=7 and a refused history;
  - the JAX daemon and the port's answer the same submits with the same
    verdict, outcome, cached and backend, and the same error class and
    message for a decode error, an oversized frame and a full queue;
  - each package's client against the other's daemon (wire
    compatibility);
  - the ``--stats-log`` event names and their key sets for one job
    sequence;
  - the real escalation on the CPU: with every CPU budget spent, adversarial
    k=7 through the port's supervised and inline escalations (torch device
    ``cpu``) gives the verdict, witness and search statistics of the JAX
    daemon's supervised escalation under ``JAX_PLATFORMS=cpu``.
- Prefix resume and cross-job batching: their config fields build a
  daemon that answers, ``serve --prefix`` and ``serve --batching`` start
  and answer, and ``follow`` is served (an error frame without
  ``--prefix``); the distributed search's ops (``grant``, ``delta``,
  ``partition_done``) answer as the JAX daemon's do.  Prefix resume and batching are held
  against the JAX package in ``test_torch_{prefix,batcher}.py``, the
  durability and ops layer in
  ``test_torch_{durability,quarantine,tsdb,archive,alerts,obs}.py``.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import signal
import socket as _socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from helpers import H, fold
from s2_verification_tpu.utils import events as jev
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.collector.collect import CollectConfig, collect_history
from s2_verification_tpu_torch.utils import events as pev

ROOT = Path(__file__).resolve().parent.parent

#: Thread budget.  Each pytest-xdist worker, and each child it spawns
#: (through ``OMP_NUM_THREADS``), gets an intra-op pool sized to its share
#: of the cores.  A pool as wide as the machine in every worker
#: oversubscribes the host: torch's OpenMP threads spin-wait for their
#: siblings, and a CPU search that takes seconds alone runs past the
#: limits here.  Collection imports this module in every worker, and a
#: run without xdist keeps the full pool.
_THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ.setdefault("OMP_NUM_THREADS", str(_THREADS))
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")
JAX, PORT = PACKAGES


def package(root: str) -> SimpleNamespace:
    """The serving modules of one package, by short name."""
    return SimpleNamespace(
        root=root,
        **{
            name: importlib.import_module(f"{root}.{path}")
            for name, path in (
                ("daemon", "service.daemon"),
                ("client", "service.client"),
                ("protocol", "service.protocol"),
                ("cache", "service.cache"),
                ("queue", "service.queue"),
                ("scheduler", "service.scheduler"),
                ("overload", "service.overload"),
                ("progress", "service.progress"),
                ("router", "service.router"),
                ("entries", "checker.entries"),
                ("oracle", "checker.oracle"),
                ("events", "utils.events"),
                ("cli", "cli"),
            )
        },
    )


@pytest.fixture(params=PACKAGES)
def pkg(request) -> SimpleNamespace:
    return package(request.param)


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raise ``TimeoutError`` in the test's thread once ``seconds`` pass: a
    daemon that stops answering fails its test instead of hanging the run."""

    def expired(signum, frame):
        raise TimeoutError(f"the test ran past its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


#: the time limits of the tests that need more than :data:`DEFAULT_LIMIT`
LIMITS = {
    "test_serve_submit_cli_round_trip": 120,
    "test_escalations_on_the_cpu_equal_the_jax_daemons_supervised": 300,
}
DEFAULT_LIMIT = 60


@pytest.fixture(autouse=True)
def _time_limit(request):
    with time_limit(LIMITS.get(request.function.__name__, DEFAULT_LIMIT)):
        yield


# -- histories (text: both daemons read the same bytes) -----------------------


def text_of(events) -> str:
    buf = io.StringIO()
    pev.write_history(events, buf)
    return buf.getvalue()


def _h_text(h: H) -> str:
    buf = io.StringIO()
    jev.write_history(h.events, buf)
    return buf.getvalue()


def good_history() -> str:
    """Linearizable: two clients, reads observe the folded appends."""
    h = H()
    h.append_ok(1, [111], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([111]))
    h.append_ok(2, [222, 333], tail=3)
    h.read_ok(1, tail=3, stream_hash=fold([111, 222, 333]))
    return _h_text(h)


def bad_history() -> str:
    """Non-linearizable: the read reports a stream hash no serialization
    of the appends can produce."""
    h = H()
    h.append_ok(1, [111], tail=1)
    h.read_ok(2, tail=1, stream_hash=12345)
    return _h_text(h)


def parity_histories() -> dict[str, str]:
    """The seeded histories the packages are held to, by name."""
    out = {
        f"{wf}": text_of(collect_history(CollectConfig(3, 25, wf, seed=7)))
        for wf in ("regular", "match-seq-num", "fencing")
    }
    out["adversarial-k7"] = text_of(adversarial_events(7, batch=100, seed=0))
    out["refused"] = text_of(adversarial_events(5, batch=3, seed=1, unsatisfiable=True))
    out["good"] = good_history()
    out["bad"] = bad_history()
    return out


def _write(tmp_path, name: str, text: str) -> str:
    p = tmp_path / name
    p.write_text(text, encoding="utf-8")
    return str(p)


def _daemon_cfg(pkg, tmp_path, **overrides):
    kw = dict(
        socket_path=str(tmp_path / "verifyd.sock"),
        workers=1,
        device="off",
        time_budget_s=10.0,
        out_dir=str(tmp_path / "viz"),
        stats_log=str(tmp_path / "stats.jsonl"),
    )
    kw.update(overrides)
    return pkg.daemon.VerifydConfig(**kw)


def _events(path) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _raw_reply(sock: _socket.socket) -> dict:
    buf = b""
    sock.settimeout(120)
    while not buf.endswith(b"\n"):
        chunk = sock.recv(1 << 16)
        assert chunk, "daemon closed mid-reply"
        buf += chunk
    return json.loads(buf)


# -- tests/test_service.py, over both packages --------------------------------


def test_daemon_round_trip_matches_one_shot_cli(tmp_path, pkg):
    good, bad = good_history(), bad_history()
    good_path = _write(tmp_path, "good.jsonl", good)
    bad_path = _write(tmp_path, "bad.jsonl", bad)

    one_shot_good = pkg.cli.main(["check", "-file", good_path, "-no-viz"])
    one_shot_bad = pkg.cli.main(["check", "-file", bad_path, "-no-viz"])
    assert (one_shot_good, one_shot_bad) == (0, 1)

    cfg = _daemon_cfg(pkg, tmp_path)
    with pkg.daemon.Verifyd(cfg):
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=120)

        pong = client.ping()
        assert pong["server"] == "verifyd" and pong["protocol"] == 1

        r_good = client.submit(good, client="t", no_viz=True)
        r_bad = client.submit(bad, client="t", no_viz=True)
        assert r_good["verdict"] == one_shot_good
        assert r_bad["verdict"] == one_shot_bad
        assert r_good["outcome"] == "ok" and r_bad["outcome"] == "illegal"
        assert not r_good["cached"] and not r_bad["cached"]

        r_dup = client.submit(good, client="t", no_viz=True)
        assert r_dup["verdict"] == one_shot_good
        assert r_dup["cached"] is True

        snap = client.stats()
        assert snap["submitted"] == 3
        assert snap["completed"] == 2
        assert snap["cache_hits"] == 1
        assert snap["cache_entries"] == 2

    by_ev: dict = {}
    for e in _events(tmp_path / "stats.jsonl"):
        by_ev.setdefault(e["ev"], []).append(e)
    assert len(by_ev["cache_hit"]) == 1
    hit = by_ev["cache_hit"][0]
    assert hit["fingerprint"] == pkg.cache.history_fingerprint(
        pkg.entries.prepare(list(pkg.events.iter_history(good)), elide_trivial=True)
    )
    assert len(by_ev["done"]) == 2
    assert {e["verdict"] for e in by_ev["done"]} == {0, 1}
    assert by_ev["serve_stop"][0]["cache_hits"] == 1


def _hold_one(cfg, daemon) -> _socket.socket:
    """Occupy the queue's single slot with a submit whose reply is never
    awaited (workers=0: nothing drains)."""
    holder = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    holder.connect(cfg.socket_path)
    holder.sendall(
        json.dumps({"op": "submit", "history": good_history(), "client": "hog"}).encode() + b"\n"
    )
    deadline = time.monotonic() + 10
    while len(daemon.queue) < 1:
        assert time.monotonic() < deadline, "first job never admitted"
        time.sleep(0.01)
    return holder


def test_queue_full_rejected_with_backpressure_reply(tmp_path, pkg):
    cfg = _daemon_cfg(pkg, tmp_path, workers=0, queue_depth=1)
    with pkg.daemon.Verifyd(cfg) as daemon:
        holder = _hold_one(cfg, daemon)
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=10)
        with pytest.raises(pkg.client.VerifydBusy) as ei:
            client.submit(bad_history(), client="t")
        assert ei.value.cls == "QueueFull"
        assert ei.value.retry_after_s > 0
        assert ei.value.extra["depth"] == 1
        assert client.stats()["rejected"] == 1
        holder.close()
        daemon.scheduler.start(1)  # drain the held job: its handler ends
    rejects = [e for e in _events(tmp_path / "stats.jsonl") if e["ev"] == "reject"]
    assert len(rejects) == 1 and rejects[0]["retry_after_s"] > 0


def test_submit_decode_error_and_artifact(tmp_path, pkg):
    cfg = _daemon_cfg(pkg, tmp_path)
    with pkg.daemon.Verifyd(cfg):
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=120)
        with pytest.raises(pkg.client.VerifydError) as ei:
            client.submit('{"not": "an event"}\n', client="t")
        assert ei.value.cls == "DecodeError"
        reply = client.submit(bad_history(), client="t")
        assert reply["artifact"] and os.path.exists(reply["artifact"])
        assert reply["artifact"].endswith(".html")
        assert os.path.dirname(reply["artifact"]) == str(tmp_path / "viz")


def test_in_flight_duplicate_answered_from_cache_at_execution(tmp_path, pkg):
    cfg = _daemon_cfg(pkg, tmp_path, workers=0, queue_depth=8)
    with pkg.daemon.Verifyd(cfg) as daemon:
        socks = []
        for _ in range(2):
            s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            s.connect(cfg.socket_path)
            s.sendall(pkg.protocol.encode_frame(
                {"op": "submit", "history": good_history(), "client": "dup", "no_viz": True}
            ))
            socks.append(s)
        deadline = time.monotonic() + 10
        while len(daemon.queue) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        daemon.scheduler.start(1)  # now let one worker drain both
        replies = []
        for s in socks:
            replies.append(_raw_reply(s)["ok"])
            s.close()
        assert [r["verdict"] for r in replies] == [0, 0]
        assert sorted(r["cached"] for r in replies) == [False, True]
    hits = [e for e in _events(tmp_path / "stats.jsonl") if e["ev"] == "cache_hit"]
    assert len(hits) == 1 and hits[0]["stage"] == "execute"


def _serve(pkg, tmp_path, sock, *extra) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    return subprocess.Popen(
        [sys.executable, "-m", pkg.root, "serve", "-socket", sock, "--device", "off",
         "-out-dir", str(tmp_path / "viz"), "--stats-log", str(tmp_path / "stats.jsonl"), *extra],
        env=env,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
        cwd=str(tmp_path),
    )


def _wait_for(proc: subprocess.Popen, sock: str, timeout: float = 120) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(sock):
        assert proc.poll() is None, f"serve exited early: {proc.stderr.read().decode()[-2000:]}"
        assert time.monotonic() < deadline, "daemon socket never appeared"
        time.sleep(0.05)


def test_serve_submit_cli_round_trip(tmp_path, pkg):
    sock = str(tmp_path / "verifyd.sock")
    good_path = _write(tmp_path, "good.jsonl", good_history())
    bad_path = _write(tmp_path, "bad.jsonl", bad_history())
    proc = _serve(pkg, tmp_path, sock)
    try:
        _wait_for(proc, sock)
        submit = pkg.cli.main
        assert submit(["submit", "-file", good_path, "-socket", sock, "-no-viz"]) == 0
        assert submit(["submit", "-file", bad_path, "-socket", sock, "-no-viz"]) == 1
        cap = io.StringIO()
        with contextlib.redirect_stdout(cap):
            rc = submit(["submit", "-file", good_path, "-socket", sock, "-no-viz", "-stats"])
        assert rc == 0
        line = json.loads(cap.getvalue().strip())
        assert line["cached"] is True and line["outcome"] == "ok"
        junk = _write(tmp_path, "junk.jsonl", "{broken\n")
        assert submit(["submit", "-file", junk, "-socket", sock]) == 64
        pkg.client.VerifydClient(sock).shutdown()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def test_submit_without_daemon_is_unavailable(tmp_path, pkg):
    good_path = _write(tmp_path, "good.jsonl", good_history())
    rc = pkg.cli.main(["submit", "-file", good_path, "-socket", str(tmp_path / "nope.sock")])
    assert rc == 69  # EX_UNAVAILABLE


def test_serve_refuses_stale_socket(tmp_path, pkg):
    stale = tmp_path / "stale.sock"
    stale.write_text("")
    assert pkg.cli.main(["serve", "-socket", str(stale)]) == 64


def _job(pkg, i, priority=10, shape="4x2x1"):
    return pkg.queue.Job(
        id=i, client="u", priority=priority, shape=shape,
        fingerprint=f"v1:{i:016x}:1", events=[], hist=None,
    )


def test_admission_queue_priority_and_shape_grouping(pkg):
    q = pkg.queue.AdmissionQueue(depth=8, retry_hint=lambda d: 1.0)
    q.put(_job(pkg, 1, priority=10, shape="A"))
    q.put(_job(pkg, 2, priority=1, shape="B"))
    q.put(_job(pkg, 3, priority=5, shape="B"))
    q.put(_job(pkg, 4, priority=7, shape="A"))
    assert [j.id for j in q.get_batch(16, timeout=1)] == [2, 3]
    assert [j.id for j in q.get_batch(16, timeout=1)] == [4, 1]


def test_admission_queue_rejects_at_depth(pkg):
    q = pkg.queue.AdmissionQueue(depth=2, retry_hint=lambda d: 2.5)
    q.put(_job(pkg, 1))
    q.put(_job(pkg, 2))
    with pytest.raises(pkg.queue.QueueFull) as ei:
        q.put(_job(pkg, 3))
    assert ei.value.depth == 2 and ei.value.retry_after_s == 2.5
    assert len(q) == 2


def test_fingerprint_stable_and_discriminating(pkg):
    def fp(text):
        return pkg.cache.history_fingerprint(
            pkg.entries.prepare(list(pkg.events.iter_history(text)), elide_trivial=True)
        )

    assert fp(good_history()) == fp(good_history())
    assert fp(good_history()) != fp(bad_history())
    assert fp(good_history()).startswith("v2:")


def test_verdict_cache_lru_and_isolation(pkg):
    c = pkg.cache.VerdictCache(capacity=2)
    c.put("a", {"verdict": 0})
    c.put("b", {"verdict": 1})
    got = c.get("a")
    got["verdict"] = 99  # caller mutation must not poison the cache
    assert c.get("a")["verdict"] == 0
    c.put("c", {"verdict": 2})  # evicts b (a was refreshed by the gets)
    assert c.get("b") is None and c.get("a") is not None


def test_wedged_device_job_degrades_to_cpu(tmp_path, monkeypatch, pkg):
    real_cpu_check = pkg.scheduler._cpu_check

    def budget_always_expires(hist, budget):
        if budget is None:  # the unbounded close: answer for real
            return real_cpu_check(hist, None)
        return pkg.oracle.CheckResult(outcome=pkg.oracle.CheckOutcome.UNKNOWN), "oracle"

    monkeypatch.setattr(pkg.scheduler, "_cpu_check", budget_always_expires)
    monkeypatch.setattr(
        pkg.scheduler.Scheduler, "_escalate_device", lambda self, job: (None, "device-supervised")
    )
    cfg = _daemon_cfg(pkg, tmp_path, device="supervised", time_budget_s=1.0, unbounded_close=True)
    with pkg.daemon.Verifyd(cfg):
        client = pkg.client.VerifydClient(cfg.socket_path, timeout=120)
        reply = client.submit(good_history(), client="wedge", no_viz=True)
    assert reply["verdict"] == 0
    assert reply["backend"].endswith("-unbounded")
    events = _events(tmp_path / "stats.jsonl")
    degrades = [e for e in events if e["ev"] == "degrade"]
    assert len(degrades) == 1 and degrades[0]["to"] == "cpu"
    stops = [e for e in events if e["ev"] == "serve_stop"]
    assert stops and stops[0]["degraded"] == 1


# -- the watch stream (tests/test_progress.py), over both packages -------------


class Clock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


def test_jobprogress_ewma_and_eta(pkg):
    clock = Clock()
    table = pkg.progress.JobProgress(interval_s=0.5, ewma_alpha=0.3, time_fn=clock)
    sink = table.sink_for(7, fingerprint="fp7", shape="2x4x8")
    # Registered at job start: watch sees the row before any heartbeat.
    rows = table.rows()
    assert [r["job"] for r in rows] == [7]
    assert rows[0]["ops_committed"] == 0 and rows[0]["heartbeats"] == 0
    sink.update(ops_committed=0, total_ops=100)  # baseline
    clock.tick(1.0)
    sink.update(ops_committed=10, total_ops=100)
    row = table.get(7)
    assert row["ops_rate"] == pytest.approx(10.0)
    assert row["eta_s"] == pytest.approx(9.0)
    assert row["progress_ratio"] == pytest.approx(0.1)
    clock.tick(1.0)
    sink.update(ops_committed=20, total_ops=100)
    assert table.get(7)["eta_s"] == pytest.approx(8.0)
    # A stalled interval drags the EWMA down and pushes the ETA out.
    clock.tick(1.0)
    sink.update(ops_committed=20, total_ops=100)
    row = table.get(7)
    assert row["ops_rate"] == pytest.approx(7.0)
    assert row["eta_s"] == pytest.approx(80 / 7.0, rel=1e-3)
    # Monotone fold: a regressing sample can never move ops backwards.
    clock.tick(1.0)
    sink.update(ops_committed=5, total_ops=100)
    assert table.get(7)["ops_committed"] == 20
    table.finish(7, outcome="ok")
    assert table.rows() == []
    done = table.get(7)
    assert done["done"] is True and done["outcome"] == "ok"


def test_jobprogress_find_by_partition_prefix(pkg):
    table = pkg.progress.JobProgress(interval_s=0.5, time_fn=Clock())
    table.sink_for(1, fingerprint="ppart:abcd1234abcd1234/p0")
    table.sink_for(2, fingerprint="ppart:abcd1234abcd1234/p1")
    table.sink_for(3, fingerprint="other")
    hits = table.find("ppart:abcd1234abcd1234/", prefix=True)
    assert [r["job"] for r in hits] == [1, 2]
    assert table.find("other") and not table.find("nope")


def _slow_engine(pkg, total: int = 30, step_s: float = 0.02):
    """A stand-in CPU engine that reports per-layer progress the way
    check_frontier does, slow enough for a watcher to sample it live."""

    def run(hist, budget, profile=False, progress=None):
        for i in range(1, total + 1):
            if progress is not None:
                progress.update(
                    ops_committed=i, total_ops=total, frontier_width=3 + (i % 5),
                    states_expanded=i * 7, layer=i, engine="frontier", final=(i == total),
                )
            time.sleep(step_s)
        return pkg.oracle.CheckResult(pkg.oracle.CheckOutcome.OK), "frontier"

    return run


def test_watch_live_job_monotone_then_done(tmp_path, monkeypatch, pkg):
    monkeypatch.setattr(pkg.scheduler, "_cpu_check", _slow_engine(pkg))
    cfg = _daemon_cfg(pkg, tmp_path, progress_interval_s=0.05, no_viz=True)
    with pkg.daemon.Verifyd(cfg):
        client = pkg.client.VerifydClient(cfg.socket_path)
        reply: dict = {}
        t = threading.Thread(
            target=lambda: reply.update(pkg.client.VerifydClient(cfg.socket_path).submit(good_history(), timeout=60)),
            daemon=True,
        )
        t.start()
        seen: list[dict] = []
        deadline = time.monotonic() + 30
        while t.is_alive() and time.monotonic() < deadline:
            seen.extend(client.watch().get("progress") or [])
            time.sleep(0.02)
        t.join(timeout=30)
        assert not t.is_alive() and reply.get("verdict") == 0
        assert len(seen) >= 2
        ops = [r["ops_committed"] for r in seen]
        assert ops == sorted(ops) and ops[-1] > ops[0]
        assert all(r["engine"] in ("other", "frontier") for r in seen)
        # The finished job still answers by id, from the done ring.
        assert client.watch(job=seen[-1]["job"])["progress"][0]["done"] is True


def test_watch_unknown_job_is_definite(tmp_path, pkg):
    cfg = _daemon_cfg(pkg, tmp_path)
    with pkg.daemon.Verifyd(cfg):
        client = pkg.client.VerifydClient(cfg.socket_path)
        with pytest.raises(pkg.client.VerifydError) as exc:
            client.watch(job=999999)
        assert exc.value.cls == pkg.protocol.ERR_UNKNOWN_JOB
        with pytest.raises(pkg.client.VerifydError) as exc:
            client.watch(fingerprint="no-such-fp")
        assert exc.value.cls == pkg.protocol.ERR_UNKNOWN_JOB
        # No selector: an empty board, not an error.
        assert client.watch()["progress"] == []


def test_watch_refused_when_heartbeats_disabled(tmp_path, pkg):
    cfg = _daemon_cfg(pkg, tmp_path, progress_interval_s=0.0)
    with pkg.daemon.Verifyd(cfg):
        with pytest.raises(pkg.client.VerifydError) as exc:
            pkg.client.VerifydClient(cfg.socket_path).watch()
        assert exc.value.cls == pkg.protocol.ERR_DECODE


# -- parity across the packages ----------------------------------------------

jax_pkg, port_pkg = package(JAX), package(PORT)

FRAMES = [
    {"op": "ping"},
    {"op": "submit", "history": good_history(), "client": "c", "priority": 3, "no_viz": True,
     "deadline": 2.5, "trace": {"trace_id": "0" * 31 + "1", "sent_wall": 1.5}},
    {"op": "shutdown", "drain": True, "timeout": 30.0},
    {"ok": {"verdict": 0, "outcome": "ok", "backend": "native", "cached": False, "wall_s": 0.01}},
    {"err": {"class": "QueueFull", "msg": "full", "retry_after_s": 1.0, "depth": 1}},
    {"op": "submit", "records": [{"event": {"Start": "x"}}], "é": "ünïcode"},
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_are_byte_identical(i):
    frame = FRAMES[i]
    jp, pp = jax_pkg.protocol, port_pkg.protocol
    assert pp.encode_frame(frame) == jp.encode_frame(frame)
    for secret in (b"s3cret", b"another-secret"):
        assert pp.sign_frame(frame, secret) == jp.sign_frame(frame, secret)
        assert pp.encode_frame(pp.sign_frame(frame, secret)) == jp.encode_frame(jp.sign_frame(frame, secret))
        assert pp.verify_frame(jp.sign_frame(frame, secret), secret)
        assert jp.verify_frame(pp.sign_frame(frame, secret), secret)
    assert pp.decode_frame(jp.encode_frame(frame)) == jp.decode_frame(jp.encode_frame(frame))


def test_protocol_constants_are_the_jax_packages():
    jp, pp = jax_pkg.protocol, port_pkg.protocol
    names = [n for n in dir(jp) if n.startswith(("ERR_", "EXIT_")) or n in (
        "MAX_FRAME_BYTES", "PROTOCOL_VERSION", "VERDICT_EXIT")]
    assert len(names) > 10
    assert {n: getattr(pp, n) for n in names} == {n: getattr(jp, n) for n in names}


@pytest.mark.parametrize("name", list(parity_histories()))
def test_fingerprints_and_shapes_equal_the_jax_packages(name):
    text = parity_histories()[name]
    out = {}
    for p in (jax_pkg, port_pkg):
        hist = p.entries.prepare(list(p.events.iter_history(text)), elide_trivial=True)
        fast = importlib.import_module(f"{p.root}.service.fastprep").fast_prepare(text=text)
        assert p.cache.history_fingerprint(fast.hist) == p.cache.history_fingerprint(hist)
        out[p.root] = (p.cache.history_fingerprint(hist), p.scheduler.shape_key(hist))
    assert out[PORT] == out[JAX]


REPLY_FIELDS = ("verdict", "outcome", "cached", "backend", "ops", "shape")


def _replies(p, tmp_path, client_pkg=None) -> dict:
    """Each parity history submitted twice to ``p``'s daemon (the second a
    cache hit) by ``client_pkg``'s client; then a decode error, an
    oversized frame and a full queue.  The reply fields that do not depend
    on time, ids or paths."""
    client_pkg = client_pkg or p
    out: dict = {}
    cfg = _daemon_cfg(p, tmp_path, no_viz=True, frame_max_bytes=1 << 16)
    with p.daemon.Verifyd(cfg):
        c = client_pkg.client.VerifydClient(cfg.socket_path, timeout=120)
        for name, text in parity_histories().items():
            for k in (0, 1):
                r = c.submit(text, client="parity")
                out[f"{name}#{k}"] = {f: r.get(f) for f in REPLY_FIELDS}
        with pytest.raises(client_pkg.client.VerifydError) as ei:
            c.submit('{"not": "an event"}\n', client="parity")
        out["decode"] = (ei.value.cls, ei.value.msg)
        big = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        big.connect(cfg.socket_path)
        # The daemon answers and closes once the frame passes its limit, which
        # can land before the rest of the frame is sent: the reply is read
        # all the same.
        with contextlib.suppress(BrokenPipeError):
            big.sendall(json.dumps({"op": "submit", "history": "x" * (1 << 17)}).encode() + b"\n")
        out["oversized"] = _raw_reply(big)
        big.close()
    sub = tmp_path / "q"
    sub.mkdir()
    cfg = _daemon_cfg(p, sub, workers=0, queue_depth=1)
    with p.daemon.Verifyd(cfg) as daemon:
        holder = _hold_one(cfg, daemon)
        with pytest.raises(client_pkg.client.VerifydBusy) as ei:
            client_pkg.client.VerifydClient(cfg.socket_path, timeout=10).submit(bad_history())
        out["queue_full"] = (ei.value.cls, ei.value.msg, ei.value.extra.get("depth"))
        holder.close()
        daemon.scheduler.start(1)  # drain the held job: its handler ends
    return out


def test_two_daemons_answer_alike(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _replies(jax_pkg, tmp_path / "j")
    got = _replies(port_pkg, tmp_path / "p")
    assert got == want
    assert want["adversarial-k7#1"]["cached"] is True and want["refused#0"]["verdict"] == 1


@pytest.mark.parametrize("daemon_pkg,client_pkg", [(JAX, PORT), (PORT, JAX)])
def test_clients_interoperate_across_the_packages(tmp_path, daemon_pkg, client_pkg):
    """A JAX client gets from the port's daemon what it gets from the JAX
    daemon, and the port's client from the JAX daemon what it gets from
    the port's."""
    d, c = package(daemon_pkg), package(client_pkg)
    (tmp_path / "cross").mkdir()
    (tmp_path / "same").mkdir()
    assert _replies(d, tmp_path / "cross", client_pkg=c) == _replies(c, tmp_path / "same")


def _event_shapes(p, tmp_path) -> list:
    """(event name, sorted keys) of every stats-log line for one job
    sequence, in order, without the daemon's own start/stop lines' pids."""
    cfg = _daemon_cfg(p, tmp_path, no_viz=True, sentinel_min_samples=1)
    with p.daemon.Verifyd(cfg):
        c = p.client.VerifydClient(cfg.socket_path, timeout=120)
        for name, text in parity_histories().items():
            c.submit(text, client="events")
        c.submit(good_history(), client="events")
        with pytest.raises(p.client.VerifydError):
            c.submit('{"not": "an event"}\n', client="events")
        with pytest.raises(p.client.VerifydError):
            c.submit(text_of(adversarial_events(3, batch=2, seed=9)), client="events", deadline_s=0.0)
    return [(e["ev"], sorted(e)) for e in _events(tmp_path / "stats.jsonl")]


def test_stats_log_events_and_keys_equal_the_jax_daemons(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _event_shapes(jax_pkg, tmp_path / "j")
    got = _event_shapes(port_pkg, tmp_path / "p")
    assert [e for e, _ in got] == [e for e, _ in want]
    assert got == want
    assert {"serve_start", "admit", "start", "done", "cache_hit", "decode_error", "admission_shed",
            "serve_stop"} <= {e for e, _ in want}


def _escalated(p, tmp_path, monkeypatch, **cfg_kw) -> tuple:
    """Adversarial k=7 through ``p``'s daemon with the CPU budget always
    spent: the reply and the deciding result's witness and statistics."""
    seen = []
    real_finish = p.scheduler.Scheduler._finish

    def unknown(hist, budget, **kw):
        return p.oracle.CheckResult(outcome=p.oracle.CheckOutcome.UNKNOWN), "native"

    def finish(self, job, res, backend, **kw):
        seen.append(res)
        return real_finish(self, job, res, backend, **kw)

    monkeypatch.setattr(p.scheduler, "_cpu_check", unknown)
    monkeypatch.setattr(p.scheduler.Scheduler, "_finish", finish)
    cfg = _daemon_cfg(p, tmp_path, time_budget_s=0.01, no_viz=True, profile=True,
                      spool_dir=str(tmp_path / "spool"), **cfg_kw)
    with p.daemon.Verifyd(cfg):
        c = p.client.VerifydClient(cfg.socket_path, timeout=300)
        reply = c.submit(parity_histories()["adversarial-k7"], client="esc")
        launches = c.stats()["introspection"].get("launches")
    (res,) = seen
    stats = {k: getattr(res.stats, k) for k in ("layers", "max_frontier", "expanded", "auto_closed", "pruned")}
    events = [e["ev"] for e in _events(tmp_path / "stats.jsonl")]
    return reply, res.linearization, res.steps, stats, events, launches


def test_escalations_on_the_cpu_equal_the_jax_daemons_supervised(tmp_path, monkeypatch):
    (tmp_path / "j").mkdir()
    jrep, jlin, jsteps, jstats, jevents, _ = _escalated(jax_pkg, tmp_path / "j", monkeypatch,
                                                        device="supervised")
    assert jrep["backend"] == "device-supervised" and jrep["verdict"] == 0
    assert "degrade" not in jevents
    for mode in ("supervised", "inline"):
        (tmp_path / mode).mkdir()
        rep, lin, steps, stats, events, launches = _escalated(
            port_pkg, tmp_path / mode, monkeypatch, device=mode, torch_device="cpu"
        )
        assert rep["backend"] == f"device-{mode}" and "degrade" not in events
        assert {f: rep[f] for f in REPLY_FIELDS if f != "backend"} == {
            f: jrep[f] for f in REPLY_FIELDS if f != "backend"
        }
        assert (lin, steps, stats) == (jlin, jsteps, jstats)
        assert rep["profile"]["layers"] == jrep["profile"]["layers"]
        # On the CPU the wrappers run the plain fold: nothing counts, but
        # a supervised child reports its (zero) launches.
        assert launches["inline"].get("fold_lanes", 0) == 0
        assert launches["children"] == ({"fold_lanes": 0} if mode == "supervised" else {})


# -- the ported features, and the refusals left ---------------------------------

#: the config fields of prefix resume and batching, each with what it needs
#: here (a vmap launch group runs on the CPU only when told)
PORTED_FIELDS = {
    "prefix_enabled": dict(prefix_enabled=True),
    "batching": dict(batching=True, batch_engine="vmap", torch_device="cpu"),
}


@pytest.mark.parametrize("field_name", list(PORTED_FIELDS))
def test_ported_config_fields_build_and_answer(tmp_path, field_name):
    cfg = _daemon_cfg(port_pkg, tmp_path, **PORTED_FIELDS[field_name])
    with port_pkg.daemon.Verifyd(cfg) as d:
        assert (d.prefix is not None) == (field_name == "prefix_enabled")
        assert (d.scheduler._batcher is not None) == (field_name == "batching")
        c = port_pkg.client.VerifydClient(cfg.socket_path, timeout=30)
        assert c.submit(good_history(), no_viz=True)["verdict"] == 0
        assert c.submit(bad_history(), no_viz=True)["verdict"] == 1


PORTED_FLAGS = {
    "--prefix": ["--prefix"],
    "--batching": ["--batching", "--batch-engine", "native"],
}


@pytest.mark.parametrize("flag", list(PORTED_FLAGS))
def test_serve_starts_with_the_flag_and_answers(tmp_path, flag):
    sock = str(tmp_path / "verifyd.sock")
    proc = _serve(port_pkg, tmp_path, sock, *PORTED_FLAGS[flag])
    try:
        _wait_for(proc, sock)
        c = port_pkg.client.VerifydClient(sock, timeout=30)
        assert c.submit(good_history(), no_viz=True)["verdict"] == 0
        c.shutdown()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


#: the distributed search's peer ops: each op's frames, after a grant
FLEET_OPS = {
    "grant": [{"op": "grant", "search": "x", "seg": "k", "part": "0", "epoch": 1}],
    "delta": [{"op": "grant", "search": "x", "seg": "k", "part": "0", "epoch": 1},
              {"op": "delta", "search": "x", "seg": "k", "part": "0", "epoch": 1, "history": good_history(),
               "carry": {"n": 0, "s": [[0, 0, None]]}}],
    "partition_done": [{"op": "grant", "search": "x", "seg": "k", "part": "0", "epoch": 1},
                       {"op": "partition_done", "search": "x", "part": "0", "epoch": 1}],
}
SERVED_OPS = {"follow": "needs the prefix store"}


@pytest.mark.parametrize("op", list(FLEET_OPS) + list(SERVED_OPS))
def test_unported_op_answers_an_error_naming_the_module(tmp_path, op):
    """The distributed search's ops, which the port once refused, answer
    as the JAX daemon's do (a grant, a partition verdict with its
    end-of-segment union, a closed grant), and no error frame names a
    missing module; ``follow`` is served, and a daemon without
    ``--prefix`` answers it with the JAX daemon's error."""
    if op in FLEET_OPS:
        bodies = []
        for pkg in (jax_pkg, port_pkg):
            sub = tmp_path / pkg.root[-1]  # short: a unix socket path has a length limit
            sub.mkdir()
            cfg = _daemon_cfg(pkg, sub)
            with pkg.daemon.Verifyd(cfg):
                conn = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
                conn.connect(cfg.socket_path)
                replies = []
                for frame in FLEET_OPS[op]:
                    conn.sendall(pkg.protocol.encode_frame(frame))
                    replies.append(_raw_reply(conn))
                # The connection answers the next frame too.
                conn.sendall(pkg.protocol.encode_frame({"op": "ping"}))
                assert _raw_reply(conn)["ok"]["server"] == "verifyd"
                conn.close()
            assert all("ok" in r for r in replies), replies
            volatile = ("trace_id", "wall_s", "queue_wait_s")
            bodies.append([{k: v for k, v in r["ok"].items() if k not in volatile} for r in replies])
        assert bodies[1] == bodies[0]
        last = bodies[1][-1]
        if op == "delta":
            assert (last["verdict"], last["scope"], last["epoch"]) == (0, "partition", 1) and last["states"]
        if op == "partition_done":
            assert last["closed"] is True
        return
    cfg = _daemon_cfg(port_pkg, tmp_path)
    frame = {"op": op, "history": good_history(), "stream": "s", "search": "x", "part": "0", "epoch": 1}
    with port_pkg.daemon.Verifyd(cfg):
        conn = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        conn.connect(cfg.socket_path)
        conn.sendall(port_pkg.protocol.encode_frame(frame))
        reply = _raw_reply(conn)
        assert reply["err"]["class"] == "DecodeError"
        assert SERVED_OPS[op] in reply["err"]["msg"], reply
        # The refusal never closes the connection: it answers the next frame.
        conn.sendall(port_pkg.protocol.encode_frame({"op": "ping"}))
        assert _raw_reply(conn)["ok"]["server"] == "verifyd"
        conn.close()
        c = port_pkg.client.VerifydClient(cfg.socket_path, timeout=30)
        assert c.submit(good_history(), no_viz=True)["verdict"] == 0
    if op in SERVED_OPS:
        (tmp_path / "prefix").mkdir()
        pcfg = _daemon_cfg(port_pkg, tmp_path / "prefix", prefix_enabled=True)
        with port_pkg.daemon.Verifyd(pcfg):
            conn = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            conn.connect(pcfg.socket_path)
            conn.sendall(port_pkg.protocol.encode_frame(frame))
            body = _raw_reply(conn)["ok"]
            conn.close()
        assert (body["verdict"], body["scope"], body["stream"], body["window"]) == (0, "window", "s", 0)


def test_inline_daemon_without_a_card_raises_at_build(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_pkg.daemon.Verifyd(_daemon_cfg(port_pkg, tmp_path, device="inline"))
    assert port_pkg.cli.main(["serve", "-socket", str(tmp_path / "v.sock"), "--device", "inline"]) == 64
