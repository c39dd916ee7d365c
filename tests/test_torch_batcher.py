"""Continuous batching in the port — the batched engines' daemon options
(``checker/batched.py``) and the batcher (``service/batcher.py``) behind
``serve --batching`` — held against the JAX package.

- Per lane, ``check_batch_native`` and ``check_batch_vmap`` (the port's on
  ``device="cpu"``) give the JAX engines' verdicts, ``layers``, ``skipped``
  reasons, ``on_lane`` order and progress samples, with and without
  ``prune``, on the campaign matrix and on seeded collected groups;
  ``time_budget_s`` on a lane and ``default_engine`` are the JAX
  package's.
- The four batcher cases of ``tests/test_batched.py`` (a lane cancelled
  and one past its deadline mid-launch, per-lane ``done`` attribution,
  late-join), each for ``native`` and for ``vmap`` on ``torch_device="cpu"``,
  with the ``batch_launch`` event's ``lanes``, ``decided``,
  ``early_exits`` and ``occupancy`` equal to the JAX batcher's on the same
  group.
- A vmap launch whose kernel fails answers its lanes with the error and
  runs nothing on another device; a vmap batching daemon with no card
  raises ``DeviceUnavailable`` when it is built (``serve`` exits 64), and
  a daemon's burst through the vmap engine answers as one-shot checks do.
"""

from __future__ import annotations

import importlib
import io
import json
import threading
from types import SimpleNamespace

import pytest
import torch

from helpers import H, fold
from s2_verification_tpu.checker.progress import ProgressSink as JaxSink
from s2_verification_tpu.collector.campaign import builtin_campaigns, collect_labeled
from s2_verification_tpu.utils import events as jev
from s2_verification_tpu.utils.events import AppendIndefiniteFailure
from s2_verification_tpu_torch.checker.progress import ProgressSink as PortSink

from test_torch_batched import _collect, _pair
from test_torch_progress import Clock
from test_torch_service import time_limit

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")
JAX, PORT = PACKAGES


def package(root: str) -> SimpleNamespace:
    return SimpleNamespace(root=root, **{
        name: importlib.import_module(f"{root}.{path}")
        for name, path in (
            ("batched", "checker.batched"),
            ("encode", "models.encode"),
            ("entries", "checker.entries"),
            ("native", "checker.native"),
            ("cache", "service.cache"),
            ("overload", "service.overload"),
            ("queue", "service.queue"),
            ("scheduler", "service.scheduler"),
            ("stats", "service.stats"),
            ("batcher", "service.batcher"),
            ("daemon", "service.daemon"),
            ("client", "service.client"),
            ("events", "utils.events"),
            ("cli", "cli"),
        )
    })


J, P = package(JAX), package(PORT)
ENGINES = ("native", "vmap")


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(120):
        yield


# -- the batched engines' options ---------------------------------------------------


def _groups() -> dict:
    """Launch groups of (JAX, port) History pairs: the campaign matrix at
    seed 11, and seeded collected histories over the three workflows."""
    matrix = [_pair(collect_labeled(c, seed=11)[0]) for c in builtin_campaigns().values()]
    collected = [_pair(_collect(wf, seed)) for wf in ("regular", "match-seq-num", "fencing") for seed in (3, 4)]
    return {"campaign-matrix": matrix, "collected": collected}


GROUPS = _groups()


def _lanes(pkg, hists, budgets=None):
    encs = pkg.encode.encode_batch(hists)
    return [pkg.batched.BatchLane(h, e, None if budgets is None else budgets[i])
            for i, (h, e) in enumerate(zip(hists, encs))]


def _run(pkg, entry, hists, prune):
    """One engine over ``hists``: per-lane views, ``on_lane`` order and
    every lane's heartbeats (a sink each, on a stepping clock)."""
    beats = [[] for _ in hists]
    sink_cls = JaxSink if pkg is J else PortSink
    sinks = [sink_cls(beats[i].append, min_interval_s=0.5, time_fn=Clock(step=1.0)) for i in range(len(hists))]
    kw = dict(skip=lambda i: "deadline" if i == 1 else None, progress=sinks, prune=prune)
    seen = []
    if entry == "check_batch_native":
        kw.update(on_lane=lambda i, v: seen.append((i, v.skipped)), profile=True)
    elif pkg is P:
        kw["device"] = "cpu"
    verdicts = getattr(pkg.batched, entry)(_lanes(pkg, hists), **kw)
    views = [(v.engine, v.result and v.result.outcome.value, v.layers, v.skipped) for v in verdicts]
    if entry == "check_batch_native":
        views = [view + (v.result and (v.result.linearization, v.result.steps, sorted(v.result.profile)),)
                 for view, v in zip(views, verdicts)]
    return views, seen, beats


@pytest.mark.parametrize("prune", [False, True], ids=["plain", "prune"])
@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("entry", ["check_batch_native", "check_batch_vmap"])
def test_batched_engines_match_jax_per_lane(entry, group, prune):
    pairs = GROUPS[group]
    jax_out = _run(J, entry, [j for j, _ in pairs], prune)
    port_out = _run(P, entry, [p for _, p in pairs], prune)
    assert port_out == jax_out
    views, seen, beats = port_out
    assert views[1][3] == "deadline" and all(v[3] is None for i, v in enumerate(views) if i != 1)
    if entry == "check_batch_native":
        assert [i for i, _ in seen] == list(range(len(pairs)))  # every lane, the skipped one included
    assert all(b and b[-1]["final"] for i, b in enumerate(beats) if i != 1)


def test_lane_budget_and_default_engine_are_the_jax_packages():
    pairs = GROUPS["collected"]
    budgets = [0.0, None, 5.0, 0.0, None, 1.0]
    got = {}
    for who, pkg, hists in (("jax", J, [j for j, _ in pairs]), ("port", P, [p for _, p in pairs])):
        verdicts = pkg.batched.check_batch_native(_lanes(pkg, hists, budgets))
        got[who] = [v.result.outcome.value for v in verdicts]
    assert got["port"] == got["jax"]
    assert P.batched.BatchLane(None, None).time_budget_s is None
    assert P.batched.default_engine() == J.batched.default_engine() == "native"


# -- the batcher against a real Scheduler --------------------------------------------


def _ok_history(i: int) -> H:
    """Serial two-client history, payloads varied by ``i`` (same shape,
    distinct fingerprint)."""
    h = H()
    h.append_ok(1, [100 + i], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([100 + i]))
    h.append_ok(2, [200 + i, 300 + i], tail=3)
    h.read_ok(1, tail=3, stream_hash=fold([100 + i, 200 + i, 300 + i]))
    return h


def _branching_history(i: int) -> H:
    """Two concurrent indefinite appends and a read that needs both, in
    order: nothing is forced, so the lane really searches."""
    h = H()
    a, b = h.call_append(1, [100 + i]), h.call_append(2, [200 + i])
    h.finish(1, a, AppendIndefiniteFailure())
    h.finish(2, b, AppendIndefiniteFailure())
    h.read_ok(3, tail=2, stream_hash=fold([100 + i, 200 + i]))
    return h


def _trip_token(pkg, reason: str, after_checks: int):
    """A CancelToken that cancels itself with ``reason`` on its
    ``after_checks + 1``-th ``check()`` — a cancel or deadline landing
    mid-launch, deterministically."""

    class Trip(pkg.overload.CancelToken):
        def __init__(self) -> None:
            super().__init__()
            self._left = after_checks

        def check(self):
            if self._left <= 0:
                self.cancel(reason)
            else:
                self._left -= 1
            return super().check()

    return Trip()


def _make_sched(pkg, tmp_path, engine, sink=None):
    kw = dict(torch_device="cpu") if pkg is P else {}
    return pkg.scheduler.Scheduler(
        pkg.queue.AdmissionQueue(depth=64),
        pkg.cache.VerdictCache(),
        pkg.stats.ServiceStats(sink=sink),
        device="off",
        time_budget_s=10.0,
        out_dir=str(tmp_path),
        batching=True,
        batch_engine=engine,
        **kw,
    )


def _make_job(pkg, jid: int, h: H, token=None):
    buf = io.StringIO()
    jev.write_history(h.events, buf)
    events = list(pkg.events.iter_history(buf.getvalue()))
    hist = pkg.entries.prepare(events, elide_trivial=True)
    box: dict = {}
    job = pkg.queue.Job(
        id=jid,
        client="t",
        priority=10,
        shape=pkg.scheduler.shape_key(hist),
        fingerprint=pkg.cache.history_fingerprint(hist),
        events=events,
        hist=hist,
        no_viz=True,
        cancel=token or pkg.overload.CancelToken(),
    )
    job.resolve = lambda reply: box.update(reply)
    return job, box


def _events(sink) -> list[dict]:
    return [json.loads(line) for line in sink.getvalue().splitlines() if line.strip()]


LAUNCH_FIELDS = ("engine", "lanes", "decided", "early_exits", "occupancy", "late_join")


def _launches(sink) -> list[dict]:
    return [{f: e[f] for f in LAUNCH_FIELDS} for e in _events(sink) if e["ev"] == "batch_launch"]


@pytest.mark.parametrize("engine", ENGINES)
def test_batcher_lane_cancel_and_deadline_mid_launch(tmp_path, engine):
    """One launch where lane 1's client hangs up and lane 2's deadline
    expires after prestart admitted them: both answered as cancelled, the
    other lanes decided, and the launch event is the JAX batcher's."""
    out = {}
    for pkg in (J, P):
        sink = io.StringIO()
        sched = _make_sched(pkg, tmp_path / pkg.root, engine, sink)
        jobs_boxes = [
            _make_job(pkg, 1, _ok_history(1)),
            _make_job(pkg, 2, _ok_history(2), _trip_token(pkg, "client_gone", 1)),
            _make_job(pkg, 3, _ok_history(3), _trip_token(pkg, "deadline", 1)),
            _make_job(pkg, 4, _ok_history(4)),
        ]
        sched._batcher.run_group([j for j, _ in jobs_boxes])
        boxes = [b for _, b in jobs_boxes]
        assert boxes[0]["ok"]["verdict"] == 0 and boxes[3]["ok"]["verdict"] == 0
        assert boxes[0]["ok"]["backend"] == f"batch-{engine}"
        assert (boxes[1]["err"]["class"], boxes[1]["err"]["reason"]) == ("Cancelled", "client_gone")
        assert (boxes[2]["err"]["class"], boxes[2]["err"]["reason"]) == ("DeadlineExceeded", "deadline")
        out[pkg.root] = _launches(sink)
    assert out[PORT] == out[JAX] and (out[PORT][0]["lanes"], out[PORT][0]["decided"]) == (4, 2)


@pytest.mark.parametrize("engine", ENGINES)
def test_batcher_per_lane_done_attribution(tmp_path, engine):
    """Every batched job emits its own done event whose wall_s is its own
    pick→decide span, bounded by the launch wall; the aggregate counters
    and metric families fold the launch."""
    out = {}
    for pkg in (J, P):
        sink = io.StringIO()
        sched = _make_sched(pkg, tmp_path / pkg.root, engine, sink)
        jobs_boxes = [_make_job(pkg, i + 1, _ok_history(i)) for i in range(4)]
        sched._batcher.run_group([j for j, _ in jobs_boxes])
        for _, box in jobs_boxes:
            assert box["ok"]["verdict"] == 0
            assert box["ok"]["backend"] == f"batch-{engine}"
        events = _events(sink)
        launch = [e for e in events if e["ev"] == "batch_launch"][0]
        done = [e for e in events if e["ev"] == "done"]
        assert sorted(e["job"] for e in done) == [1, 2, 3, 4]
        for e in done:
            assert e["backend"] == f"batch-{engine}"
            assert 0.0 <= e["wall_s"] <= launch["wall_s"] + 0.5
        snap = sched.stats.snapshot()
        assert (snap["batch_launches"], snap["batch_lanes"]) == (1, 4)
        families = json.dumps(snap["metrics"])
        for family in ("verifyd_batch_launch_lanes", "verifyd_batch_launch_occupancy_ratio") + (
                ("verifyd_batch_early_exits_total",) if engine == "native" else ()):
            assert family in families
        out[pkg.root] = (_launches(sink), snap["batch_early_exits"])
    assert out[PORT] == out[JAX]
    assert out[PORT][0][0]["early_exits"] == (3 if engine == "native" else 0)


@pytest.mark.parametrize("engine", ENGINES)
def test_batcher_late_join_drains_queue(tmp_path, engine):
    """Jobs queued while a launch is in flight join the next launch
    boundary (drain_shape), not the next worker pick."""
    out = {}
    for pkg in (J, P):
        sink = io.StringIO()
        sched = _make_sched(pkg, tmp_path / pkg.root, engine, sink)
        first = [_make_job(pkg, i + 1, _ok_history(i)) for i in range(2)]
        late = [_make_job(pkg, i + 10, _ok_history(i + 10)) for i in range(2)]
        for j, _ in late:
            sched.queue.put(j)
        sched._batcher.run_group([j for j, _ in first])
        for _, box in first + late:
            assert box["ok"]["verdict"] == 0
        assert len(sched.queue) == 0
        out[pkg.root] = _launches(sink)
    assert out[PORT] == out[JAX]
    assert [e["late_join"] for e in out[PORT]] == [False, True]


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_native_skip_and_on_lane_order(engine):
    """The skip boundary before each lane and the per-lane callback
    (``check_batch_native``); under vmap, the skip before the launch."""
    out = {}
    for pkg in (J, P):
        hists = [_make_job(pkg, i, _ok_history(i))[0].hist for i in range(3)]
        lanes = _lanes(pkg, hists)
        seen: list[int] = []
        skip = lambda i: "deadline" if i == 1 else None  # noqa: E731
        if engine == "native":
            verdicts = pkg.batched.check_batch_native(lanes, skip=skip, on_lane=lambda i, v: seen.append(i))
            assert seen == [0, 1, 2]
        else:
            kw = dict(device="cpu") if pkg is P else {}
            verdicts = pkg.batched.check_batch_vmap(lanes, skip=skip, **kw)
        assert verdicts[1].skipped == "deadline" and verdicts[1].result is None
        out[pkg.root] = [(v.result and v.result.outcome.value, v.layers, v.skipped) for v in verdicts]
    assert out[PORT] == out[JAX]


# -- the card: no quiet fallback ------------------------------------------------------


def test_a_failed_vmap_launch_answers_its_lanes_and_runs_nothing_else(tmp_path, monkeypatch):
    sink = io.StringIO()
    sched = _make_sched(P, tmp_path, "vmap", sink)
    ran = []
    monkeypatch.setattr(P.batched, "_mega_launch", lambda *a: (_ for _ in ()).throw(RuntimeError("no kernel")))
    monkeypatch.setattr(sched, "_portfolio", lambda job: ran.append(job.id))
    jobs_boxes = [_make_job(P, i + 1, _branching_history(i)) for i in range(3)]
    assert all(j.hist.ops for j, _ in jobs_boxes)
    sched._batcher.run_group([j for j, _ in jobs_boxes])
    for _, box in jobs_boxes:
        assert box["err"]["class"] == "InternalError" and "no kernel" in box["err"]["msg"]
    assert ran == []
    names = [e["ev"] for e in _events(sink)]
    assert "batch_launch" not in names and names.count("job_error") == 3


def _daemon_cfg(tmp_path, **kw):
    return P.daemon.VerifydConfig(socket_path=str(tmp_path / "v.sock"), device="off", no_viz=True,
                                  stats_log=str(tmp_path / "stats.jsonl"), **kw)


@pytest.mark.parametrize("engine", ["vmap", "auto"])
def test_vmap_batching_daemon_without_a_card_raises_at_build(tmp_path, monkeypatch, engine):
    from s2_verification_tpu_torch.checker.device import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if engine == "auto":
        # auto is vmap only where the native engine does not build.
        monkeypatch.setattr(P.batched, "native_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        P.daemon.Verifyd(_daemon_cfg(tmp_path, batching=True, batch_engine=engine))
    assert not (tmp_path / "v.sock").exists()
    argv = ["serve", "-socket", str(tmp_path / "v.sock"), "--device", "off", "--batching", "--batch-engine", engine]
    assert P.cli.main(argv) == 64


def test_a_vmap_burst_answers_as_one_shot_checks(tmp_path):
    """A daemon parked with no worker collects a burst of submits, then one
    worker runs each shape group as one vmap launch: every verdict is the
    one-shot answer, and the stats op counts the launches."""
    from s2_verification_tpu_torch.checker.oracle import check

    texts, want, shapes = [], [], set()
    for i in range(6):
        h = _ok_history(i)
        if i % 3 == 2:
            h.read_ok(1, tail=3, stream_hash=12345)  # not linearizable
        buf = io.StringIO()
        jev.write_history(h.events, buf)
        texts.append(buf.getvalue())
        hist = P.entries.prepare(list(P.events.iter_history(texts[-1])), elide_trivial=True)
        want.append(0 if check(hist).ok else 1)
        shapes.add(P.scheduler.shape_key(hist))
    cfg = _daemon_cfg(tmp_path, workers=0, batching=True, batch_engine="vmap", torch_device="cpu")
    with P.daemon.Verifyd(cfg) as d:
        client = P.client.VerifydClient(cfg.socket_path, timeout=60)
        replies = [None] * len(texts)

        def submit(i):
            replies[i] = client.submit(texts[i], no_viz=True)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        while len(d.queue) < len(texts):
            threading.Event().wait(0.01)
        d.scheduler.start(1)
        for t in threads:
            t.join()
        snap = client.stats()
    assert [r["verdict"] for r in replies] == want
    assert {r["backend"] for r in replies} == {"batch-vmap"}
    # One launch a shape: the illegal twins carry one more op.
    assert snap["batch_launches"] == len(shapes) == 2 and snap["batch_lanes"] == len(texts)
