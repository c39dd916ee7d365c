"""The profile archive (obs/archive.py) beside the JAX package's.

- The cases of ``tests/test_archive.py``, run over both packages: the
  ``done``-event fold with lease-wait correlation, corpus dedup, the cold
  readers on a missing or unclosed archive, the filter algebra, and
  through a daemon: profiles that survive a restart (cold and through the
  ``profiles`` op), the op refused without ``--state-dir``, and the
  archive in the ``stats`` snapshot.  (Its replay-harness case is marked
  slow in the JAX suite and is not ported.)
- Side by side, exact: the same events and histories give the same
  segment bytes in each package's archive.
- Across packages: a daemon's archive read cold by the other package's
  readers and its ``profiles`` CLI, and answered by the other package's
  daemon through the ``profiles`` op.
"""

import importlib
import io
import json
import os
from types import SimpleNamespace

import pytest

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    'ProfileArchive': ('obs.archive', 'ProfileArchive'),
    'filter_records': ('obs.archive', 'filter_records'),
    'read_archive': ('obs.archive', 'read_archive'),
    'read_corpus': ('obs.archive', 'read_corpus'),
    'CollectConfig': ('collector.collect', 'CollectConfig'),
    'collect_history': ('collector.collect', 'collect_history'),
    'VerifydClient': ('service.client', 'VerifydClient'),
    'Verifyd': ('service.daemon', 'Verifyd'),
    'VerifydConfig': ('service.daemon', 'VerifydConfig'),
    'ev': ('utils', 'events'),
    'VerifydError': ('service.client', 'VerifydError'),
}


@pytest.fixture(autouse=True, params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    for name, (mod, attr) in _NAMES.items():
        m = importlib.import_module(f"{request.param}.{mod}" if mod else request.param)
        setattr(P, name, getattr(m, attr) if attr else m)
    yield request.param


@pytest.fixture(autouse=True)
def _time_limit():
    """Each case fails after 60 s instead of hanging the run."""
    from test_torch_service import time_limit

    with time_limit(60):
        yield



def _done(job, **kw):
    ev = {
        "ev": "done",
        "t": 100.0 + job,
        "job": job,
        "client": "t",
        "shape": "4x2x8",
        "backend": "native",
        "verdict": 0,
        "wall_s": 0.01 * job,
        "queue_wait_s": 0.001,
        "ops": 8,
        "fingerprint": f"v1:{job:016x}:8",
        "profile": {"layers": 3},
    }
    ev.update(kw)
    return ev


# -- unit: the fold and the cold readers ------------------------------------


def test_archive_round_trip(tmp_path):
    d = str(tmp_path / "profiles")
    a = P.ProfileArchive(d)
    a.observe_event({"ev": "lease_grant", "job": 2, "wait_s": 0.25})
    a.observe_event(_done(1))
    a.observe_event(_done(2, verdict=1, backend="device-mesh[4]"))
    a.observe_event({"ev": "accept", "job": 3})  # not a done: ignored
    assert a.add_history("v1:%016x:8" % 1, "line1\n")
    assert not a.add_history("v1:%016x:8" % 1, "line1\n")  # dedup by fp
    assert len(a) == 2
    a.close()

    b = P.ProfileArchive(d)
    assert len(b) == 2
    recs = b.query()
    assert [r["job"] for r in recs] == [1, 2]
    assert recs[0]["fp"] == "v1:%016x:8" % 1
    assert recs[0]["profile"] == {"layers": 3}
    # lease_grant wait correlated onto job 2's record only
    assert "lease_wait_s" not in recs[0]
    assert recs[1]["lease_wait_s"] == 0.25
    assert b.history("v1:%016x:8" % 1) == "line1\n"
    b.close()


def test_cold_readers_tolerate_missing_state(tmp_path):
    assert P.read_archive(str(tmp_path)) == []
    assert P.read_corpus(str(tmp_path)) == {}


def test_cold_readers_see_unclosed_appends(tmp_path):
    state = str(tmp_path)
    a = P.ProfileArchive(os.path.join(state, "profiles"))
    a.observe_event(_done(1))
    a.add_history("v1:%016x:8" % 1, "line1\n")
    a.close()
    recs = P.read_archive(state)
    assert len(recs) == 1 and recs[0]["job"] == 1
    assert P.read_corpus(state) == {"v1:%016x:8" % 1: "line1\n"}


def test_filter_records_algebra():
    recs = [
        _done(1),
        _done(2, shape="8x4x16", wall_s=5.0),
        _done(3, verdict=2, backend="device-mesh[2]", client="u"),
        _done(4, t=500.0),
    ]
    for r in recs:
        r["fp"] = r.pop("fingerprint")
    assert [r["job"] for r in P.filter_records(recs, shape="8x4x16")] == [2]
    assert [r["job"] for r in P.filter_records(recs, backend="device")] == [3]
    assert [r["job"] for r in P.filter_records(recs, verdict=2)] == [3]
    assert [r["job"] for r in P.filter_records(recs, client="u")] == [3]
    assert [r["job"] for r in P.filter_records(recs, since=200.0)] == [4]
    # slowest ranks by wall desc and wins over limit
    slow = P.filter_records(recs, slowest=2, limit=1)
    assert [r["job"] for r in slow] == [2, 4]
    # limit keeps the newest N in recorded order
    assert [r["job"] for r in P.filter_records(recs, limit=2)] == [3, 4]
    # returned records are copies, not aliases
    P.filter_records(recs)[0]["job"] = 999
    assert recs[0]["job"] == 1


# -- end to end: archive a workload, kill the daemon, query + replay --------


@pytest.fixture
def archived_state(tmp_path):
    """A state dir left behind by a daemon that verified three histories."""

    tmp = tmp_path
    state = str(tmp / "state")
    sock = str(tmp / "verifyd.sock")
    texts = []
    for seed in range(3):
        hist = P.collect_history(
            P.CollectConfig(
                num_concurrent_clients=2, num_ops_per_client=8, seed=seed
            )
        )
        buf = io.StringIO()
        P.ev.write_history(hist, buf)
        texts.append(buf.getvalue())

    cfg = P.VerifydConfig(
        socket_path=sock,
        state_dir=state,
        device="off",
        no_viz=True,
        stats_log=None,
        out_dir=str(tmp / "viz"),
    )
    verdicts = []
    with P.Verifyd(cfg):
        client = P.VerifydClient(sock)
        for text in texts:
            reply = client.submit(text, client="e2e")
            verdicts.append(reply["verdict"])
    return {"state": state, "sock": sock, "cfg": cfg, "verdicts": verdicts}


def test_profiles_survive_restart(archived_state):
    # Cold: straight off the segment logs, no daemon.
    cold = P.read_archive(archived_state["state"])
    assert len(cold) == 3
    corpus = P.read_corpus(archived_state["state"])
    assert set(corpus) == {r["fp"] for r in cold}
    for rec in cold:
        assert rec["shape"] and rec["wall_s"] is not None
        assert rec.get("profile") is None or isinstance(rec["profile"], dict)

    # Warm: a restarted daemon replays the archive and answers the op.
    with P.Verifyd(archived_state["cfg"]):
        client = P.VerifydClient(archived_state["sock"])
        reply = client.profiles()
        assert reply["total"] == 3
        assert len(reply["records"]) == 3
        one = client.profiles(slowest=1)
        assert len(one["records"]) == 1
        assert one["records"][0]["wall_s"] == max(r["wall_s"] for r in cold)


def test_profiles_op_without_state_dir_is_decode_error(tmp_path):
    sock = str(tmp_path / "verifyd.sock")
    cfg = P.VerifydConfig(
        socket_path=sock, device="off", no_viz=True, stats_log=None
    )
    with P.Verifyd(cfg):
        client = P.VerifydClient(sock)
        with pytest.raises(P.VerifydError) as ei:
            client.profiles()
        assert ei.value.cls == "DecodeError"


def test_archive_in_stats_snapshot(archived_state):
    with P.Verifyd(archived_state["cfg"]):
        client = P.VerifydClient(archived_state["sock"])
        snap = client.stats()
        assert snap["archive"]["records"] == 3
        assert snap["archive"]["histories"] == 3


# -- side by side and across packages -----------------------------------------


def other(package: str) -> str:
    return PACKAGES[1 - PACKAGES.index(package)]


def _mod(package: str, path: str):
    return importlib.import_module(f"{package}.{path}")


def _fill(package: str, directory) -> None:
    a = _mod(package, "obs.archive").ProfileArchive(str(directory))
    a.observe_event({"ev": "lease_grant", "job": 2, "wait_s": 0.25})
    for job in (1, 2, 3):
        a.observe_event(_done(job, verdict=job % 2, backend="device-inline" if job == 3 else "native"))
        a.add_history(f"v1:{job:016x}:8", f"line{job}\n")
    a.add_history("v1:%016x:8" % 1, "line1\n")
    a.close()


def _seg_bytes(directory) -> dict:
    return {
        str(p.relative_to(directory)): p.read_bytes()
        for p in sorted(directory.rglob("seg-*"))
    }


def test_the_same_events_give_the_same_archive_bytes(tmp_path, package):
    _fill(package, tmp_path / "a" / "profiles")
    _fill(other(package), tmp_path / "b" / "profiles")
    mine, theirs = _seg_bytes(tmp_path / "a"), _seg_bytes(tmp_path / "b")
    assert len(mine) == 2 and mine == theirs


def test_a_daemons_archive_answers_in_the_other_package(archived_state, package, capsys):
    """``package``'s daemon left the state dir: the other package's cold
    readers and ``profiles --state-dir`` read it, and the other package's
    daemon answers ``profiles`` from it."""
    state = archived_state["state"]
    theirs = _mod(other(package), "obs.archive")
    assert theirs.read_archive(state) == P.read_archive(state)
    assert theirs.read_corpus(state) == P.read_corpus(state)
    capsys.readouterr()
    assert _mod(other(package), "cli").main(["profiles", "--state-dir", state, "--export", "-"]) == 0
    exported = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert exported == P.read_archive(state)
    daemon, client = _mod(other(package), "service.daemon"), _mod(other(package), "service.client")
    cfg = daemon.VerifydConfig(socket_path=str(archived_state["sock"]) + ".2", state_dir=state,
                               device="off", no_viz=True, stats_log=None)
    with daemon.Verifyd(cfg):
        reply = client.VerifydClient(cfg.socket_path).profiles(slowest=3)
    assert reply["total"] == 3
    assert sorted(r["fp"] for r in reply["records"]) == sorted(r["fp"] for r in exported)
