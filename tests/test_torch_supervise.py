"""The supervised device escalation in the port (service/supervise.py),
held against the JAX package's.

- A wedged child (killed by its attempt timeout) exhausts its restart
  budget and returns ``None`` — the degrade signal (``tests/
  test_service.py:459``); ``shape_key`` buckets as the encoder pads and
  equals the JAX ``shape_key`` on the same histories.
- The spooled-heartbeat round trip of ``_progress_poll`` (``tests/
  test_progress.py:268, :303``), over both packages.
- Parity of the child: one seeded history at a time (adversarial k=7 and
  a collector history) goes through the JAX child (``python -m
  s2_verification_tpu.service.supervise H C O profile=1`` under
  ``JAX_PLATFORMS=cpu``) and the port's (``... device=cpu``); the results
  are equal in outcome, linearization, deepest, steps and every
  ``FrontierStats`` field the JAX package fills (the timeline without its
  wall times), and each package's ``_result_from_json`` reads the other's
  JSON.
- A ``devices=0,1`` grant with ``device=cpu`` runs the mesh in the child:
  the unsharded verdict, and ``stats.shards`` of length 2, folded into a
  ``ServiceStats``'s per-shard families.
- No fallback: a child without ``device=`` on a host without CUDA exits
  nonzero, writes no result and never decides on the CPU.
- A cancel at the deadline frees a wedged child and its lease (the
  daemon-free core of ``tests/test_deadline.py``'s supervised case).
- The supervising side leaves ``torch`` unimported, in a fresh
  interpreter, through a wedged check and a decided one.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from helpers import H, fold
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.collector.collect import CollectConfig, collect_history
from s2_verification_tpu_torch.service import supervise
from s2_verification_tpu_torch.service.devicepool import DevicePool
from s2_verification_tpu_torch.service.scheduler import shape_key
from s2_verification_tpu_torch.service.stats import ServiceStats
from s2_verification_tpu_torch.utils import events as ev

from test_torch_progress import Clock

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")
jsup = importlib.import_module("s2_verification_tpu.service.supervise")
jsched = importlib.import_module("s2_verification_tpu.service.scheduler")
jentries = importlib.import_module("s2_verification_tpu.checker.entries")
jev = importlib.import_module("s2_verification_tpu.utils.events")
JAX_STAT_FIELDS = [f.name for f in dataclasses.fields(importlib.import_module(
    "s2_verification_tpu.checker.frontier").FrontierStats)]


def _text(h: H) -> str:
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
    return _text(h)


def _write(path, events) -> str:
    with open(path, "w", encoding="utf-8") as f:
        ev.write_history(events, f)
    return str(path)


# -- the degrade signal and the shape key (test_service.py) ----------------------


def test_supervise_wedged_child_degrades_to_none(tmp_path):
    """A child that never finishes an attempt (the timeout kills it while it
    imports) exhausts its restart budget and returns None."""
    events = list(ev.iter_history(good_history()))
    res = supervise.supervised_device_check(
        events,
        spool_dir=str(tmp_path / "spool"),
        job_id=1,
        attempt_timeout_s=0.2,
        max_restarts=0,
        probe=False,
    )
    assert res is None
    assert os.listdir(tmp_path / "spool") == []  # spool files cleaned up


def test_shape_key_buckets_pad_like_the_encoder():
    small = prepare(list(ev.iter_history(good_history())), elide_trivial=True)
    assert shape_key(small) == "4x2x2"
    h = H()
    h.append_ok(1, [5, 6], tail=2)
    h.read_ok(2, tail=2, stream_hash=fold([5, 6]))
    h.append_ok(2, [7], tail=3)
    sib = prepare(list(ev.iter_history(_text(h))), elide_trivial=True)
    assert shape_key(sib) == shape_key(small)
    # The JAX scheduler's key on the same histories.
    for text in (good_history(), _text(h)):
        want = jsched.shape_key(jentries.prepare(list(jev.iter_history(text)), elide_trivial=True))
        assert shape_key(prepare(list(ev.iter_history(text)), elide_trivial=True)) == want
    for k, batch in ((5, 3), (7, 100), (10, 100)):
        evs = adversarial_events(k, batch=batch, seed=0)
        want = jsched.shape_key(jentries.prepare(list(jev.iter_history(_events_text(evs)))))
        assert shape_key(prepare(evs)) == want


def _events_text(events) -> str:
    buf = io.StringIO()
    ev.write_history(events, buf)
    return buf.getvalue()


# -- the spooled heartbeat (test_progress.py) ----------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_supervised_spool_roundtrip(tmp_path, pkg):
    poll_of = importlib.import_module(f"{pkg}.service.supervise")._progress_poll
    Sink = importlib.import_module(f"{pkg}.checker.progress").ProgressSink
    path = str(tmp_path / "job1.progress.json")

    def spool(rec):  # the child side: atomic overwrite of the latest beat
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f)
        os.replace(tmp, path)

    clock, out = Clock(), []
    parent_sink = Sink(out.append, min_interval_s=0.5, time_fn=clock)
    cancelled = []
    poll = poll_of(lambda: cancelled and cancelled[0] or None, parent_sink, path, min_interval_s=0.0)
    spool({"ops_committed": 5, "total_ops": 10, "layer": 2, "engine": "device"})
    assert poll() is None
    clock.tick(1.0)
    spool({"ops_committed": 7, "total_ops": 10, "layer": 4, "engine": "device"})
    poll()
    assert len(out) == 1
    assert out[0]["ops_committed"] == 7 and out[0]["engine"] == "device"
    clock.tick(1.0)
    poll()
    assert len(out) == 1
    cancelled.append("deadline")
    assert poll() == "deadline"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_supervised_spool_tolerates_garbage(tmp_path, pkg):
    poll_of = importlib.import_module(f"{pkg}.service.supervise")._progress_poll
    Sink = importlib.import_module(f"{pkg}.checker.progress").ProgressSink
    path = str(tmp_path / "job2.progress.json")
    with open(path, "w", encoding="utf-8") as f:
        f.write("not json{")
    sink = Sink(lambda rec: None, time_fn=Clock())
    poll = poll_of(lambda: None, sink, path, min_interval_s=0.0)
    assert poll() is None


# -- parity of the child ----------------------------------------------------------------


def _run_child(module: str, tmp_path, tag: str, hist_path: str, extras=(), env=None) -> tuple:
    ckpt, out = tmp_path / f"{tag}.ckpt.npz", tmp_path / f"{tag}.result.json"
    proc = subprocess.run(
        [sys.executable, "-m", module, hist_path, str(ckpt), str(out), *extras],
        cwd=ROOT, env={**os.environ, **(env or {})}, capture_output=True, text=True, timeout=600,
    )
    return proc, out


def _timeline_without_walls(timeline) -> list:
    return [{k: v for k, v in e.items() if k != "elapsed_s"} for e in timeline]


HISTORIES = {
    "adversarial-k7": lambda: adversarial_events(7, batch=100, seed=0),
    "collector-match-seq-num-3x60": lambda: collect_history(CollectConfig(3, 60, "match-seq-num", seed=7)),
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_child_matches_the_jax_child(tmp_path, name):
    hist_path = _write(tmp_path / "h.jsonl", HISTORIES[name]())
    pproc, pout = _run_child("s2_verification_tpu_torch.service.supervise", tmp_path, "port", hist_path,
                             ["profile=1", "device=cpu"])
    assert pproc.returncode == 0, pproc.stderr
    jproc, jout = _run_child("s2_verification_tpu.service.supervise", tmp_path, "jax", hist_path,
                             ["profile=1"], env={"JAX_PLATFORMS": "cpu"})
    assert jproc.returncode == 0, jproc.stderr
    pj, jj = json.loads(pout.read_text()), json.loads(jout.read_text())
    for key in ("outcome", "linearization", "deepest", "steps"):
        assert pj[key] == jj[key], key
    for f in JAX_STAT_FIELDS:
        if f == "timeline":
            assert _timeline_without_walls(pj["stats"][f]) == _timeline_without_walls(jj["stats"][f])
        else:
            assert pj["stats"][f] == jj["stats"][f], f
    # Each package reads the other's result JSON.
    for obj in (pj, jj):
        port_res, jax_res = supervise._result_from_json(obj), jsup._result_from_json(obj)
        assert port_res.outcome.value == jax_res.outcome.value == obj["outcome"]
        assert port_res.linearization == jax_res.linearization == obj["linearization"]
        assert port_res.deepest == jax_res.deepest and port_res.steps == jax_res.steps
        for f in JAX_STAT_FIELDS:
            assert getattr(port_res.stats, f) == getattr(jax_res.stats, f) == obj["stats"][f], f
        assert port_res.child_trace["spans"] and port_res.child_jit == jax_res.child_jit
    assert pj["stats"]["host_syncs"] > 0 and supervise._result_from_json(jj).stats.host_syncs == 0
    # On the CPU the fold runs its plain version: no kernel launch counted.
    assert pj["launches"] == {"fold_lanes": 0} and "launches" not in jj
    # The port's child ships its span ring home.
    assert {s["name"] for s in pj["trace"]["spans"]} >= {"child_prepare", "child_search"}
    # The conclusive runs leave no snapshot behind.
    assert not [p for p in os.listdir(tmp_path) if ".ckpt" in p]


def test_grant_of_two_cpu_shards_runs_the_mesh_in_the_child(tmp_path):
    events = adversarial_events(6, batch=4, seed=0)
    plain = pdev.check_device_auto(prepare(events), device="cpu", collect_stats=True)
    stats = ServiceStats(None)
    pool = DevicePool(2, stats=stats)
    lease = pool.acquire(size=2, job=3, timeout_s=0)
    try:
        res = supervise.supervised_device_check(
            events, spool_dir=str(tmp_path), job_id=3, devices=lease.indices, device="cpu",
            attempt_timeout_s=300, max_restarts=0,
        )
    finally:
        pool.release(lease)
    assert res is not None and res.outcome == plain.outcome and res.steps == plain.steps
    for f in ("layers", "max_frontier", "expanded", "auto_closed"):
        assert getattr(res.stats, f) == getattr(plain.stats, f), f
    assert [s["shard"] for s in res.stats.shards] == [0, 1]
    assert [s["device"] for s in res.stats.shards] == ["cpu", "cpu"]
    assert sum(s["peak_occupancy"] for s in res.stats.shards) >= res.stats.max_frontier
    stats.emit("done", job=3, wall_s=0.1, verdict=0, backend="device-mesh[2]", shards=res.stats.shards)
    text = stats.registry.render()
    for s in res.stats.shards:
        assert f'verifyd_shard_frontier_occupancy{{shard="{s["shard"]}"}} {s["peak_occupancy"]}' in text
    assert "verifyd_leases_granted_total 1" in text and "verifyd_devices_leased 0" in text


def test_child_without_a_device_needs_cuda_and_never_decides_on_the_cpu(tmp_path):
    hist_path = _write(tmp_path / "h.jsonl", adversarial_events(4, batch=2, seed=0))
    proc, out = _run_child("s2_verification_tpu_torch.service.supervise", tmp_path, "nocuda", hist_path,
                           env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "DeviceUnavailable" in proc.stderr
    assert not out.exists()
    # A grant without device= fails the same way, before any search.
    proc, out = _run_child("s2_verification_tpu_torch.service.supervise", tmp_path, "nocuda2", hist_path,
                           ["devices=0,1"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "DeviceUnavailable" in proc.stderr and not out.exists()


def test_grant_past_the_visible_cards_exits_with_the_jax_message(tmp_path, monkeypatch):
    import torch

    hist_path = _write(tmp_path / "h.jsonl", adversarial_events(4, batch=2, seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"device grant \[0, 1\] exceeds the 1 visible devices"):
        supervise._child_main([hist_path, str(tmp_path / "c"), str(tmp_path / "o"), "devices=0,1"])
    assert not (tmp_path / "o").exists()


def test_supervising_side_never_imports_torch(tmp_path):
    spool = str(tmp_path / "spool")
    code = f"""
import sys
from s2_verification_tpu_torch.checker import resilient
from s2_verification_tpu_torch.service import devicepool, scheduler, supervise
from s2_verification_tpu_torch.service.stats import ServiceStats
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
events = adversarial_events(4, batch=2, seed=0)
assert supervise.supervised_device_check(events, spool_dir={spool!r}, job_id=1,
                                         attempt_timeout_s=0.2, max_restarts=0, probe=False) is None
res = supervise.supervised_device_check(events, spool_dir={spool!r}, job_id=2, device="cpu",
                                        devices=[0], attempt_timeout_s=300, max_restarts=0)
assert res is not None and res.ok and len(res.stats.shards) == 1, res
assert 'torch' not in sys.modules, sorted(m for m in sys.modules if m.startswith('torch'))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cancel_frees_a_wedged_child_and_its_lease(tmp_path, monkeypatch):
    """The daemon-free core of ``tests/test_deadline.py``'s supervised case:
    a child wedged at interpreter start (a ``sitecustomize.py`` that
    sleeps) is cancelled at its deadline; ``drive`` SIGTERMs its process
    group, the check returns None with no relaunch within deadline + grace,
    and the lease goes back to the pool."""
    wedge = tmp_path / "wedge"
    wedge.mkdir()
    (wedge / "sitecustomize.py").write_text(
        "import os, time\nif os.environ.get('S2VTPU_TEST_WEDGE_CHILD') == '1':\n    time.sleep(120)\n"
    )
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(wedge), *filter(None, [os.environ.get("PYTHONPATH")])]))
    monkeypatch.setenv("S2VTPU_TEST_WEDGE_CHILD", "1")
    stats = ServiceStats(None)
    pool = DevicePool(1, stats=stats)
    said = []
    lease = pool.acquire(size=1, job=9, timeout_s=0)
    try:
        deadline = time.monotonic() + 1.0
        res = supervise.supervised_device_check(
            list(ev.iter_history(good_history())), spool_dir=str(tmp_path / "spool"), job_id=9,
            devices=lease.indices, device="cpu", attempt_timeout_s=60, grace_s=1.0, log=said.append,
            cancel=lambda: "deadline" if time.monotonic() >= deadline else None,
        )
        elapsed = time.monotonic() - (deadline - 1.0)
    finally:
        pool.release(lease)
    assert res is None
    assert elapsed < 1.0 + 1.0 + 4.0
    assert sum(1 for s in said if re.match(r"attempt \d+: ", s)) == 1, said
    assert any("cancelled (deadline)" in s for s in said), said
    assert pool.snapshot()["in_use"] == 0
    assert "verifyd_devices_leased 0" in stats.registry.render()
