"""Port parity: checkpoint and resume against the JAX device engine (the
JAX package's ``tests/test_checkpoint.py``, on the port).

Held integer-exact (tolerance 0), the JAX side on the CPU, the port with
``device="cpu"``:

- the history fingerprint equals the JAX engine's;
- a checkpointed run equals the JAX engine's at the same cadence (its
  segment budget), the speculation counters included;
- a run preempted mid-way (a ``run_search`` that raises
  ``KeyboardInterrupt``) resumes to the uninterrupted run's verdict and
  statistics: in core, in the chunked tier with a smaller bucket than the
  snapshot's, and in the spill;
- a beam snapshot refuses an exhaustive resume; corrupt, other-history,
  stale-format and stale-encoding files raise ``CheckpointError``;
- ``check_device_auto``'s conceded-beam marker, and the CLI's
  ``-checkpoint`` with a stale file (exit 64);
- across engines: a snapshot written by the JAX engine (in core, and the
  spill's ``.spill.npz``) resumes in the port to the JAX engine's resumed
  result, and a port snapshot resumes in the JAX engine to the port's (the
  port's spill snapshot also keeps the statistics so far, which the JAX
  engine does not read).
"""

import contextlib
import importlib
import json
import logging
import os
import shutil

import numpy as np
import pytest

from s2_verification_tpu.collector.collect import CollectConfig, collect_history
from s2_verification_tpu.collector.fake_s2 import FaultPlan
from s2_verification_tpu.models.encode import encode_history as jax_encode
from s2_verification_tpu_torch import cli as pcli
from s2_verification_tpu_torch.checker import checkpoint as pck
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, check
from s2_verification_tpu_torch.models.encode import encode_history

from test_torch_chunked import STAT_FIELDS
from test_torch_device import TABLE_CASES, assert_replays, assert_results_equal, both, jax_adversarial, jdev
from test_torch_encode import jax_text

jck = importlib.import_module("s2_verification_tpu.checker.checkpoint")


@pytest.fixture(scope="module")
def hists():
    """The JAX package's checkpoint-test history (both engines' views)."""
    return both(
        collect_history(
            CollectConfig(
                num_concurrent_clients=3, num_ops_per_client=25, workflow="regular", seed=13,
                faults=FaultPlan.chaos(0.15),
            )
        )
    )


def assert_same(rj, rp, hp):
    assert_results_equal(rj, rp, hp)
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(rj.stats, f), f


@contextlib.contextmanager
def preempting(mod, n, slabs_only=False):
    """Make ``mod.run_search`` raise ``KeyboardInterrupt`` after its ``n``-th
    call (counting only one-layer spill slabs with ``slabs_only``)."""
    real = mod.run_search
    calls = {"n": 0}

    def interrupting(*a, **kw):
        out = real(*a, **kw)
        if not slabs_only or int(a[2]) == 1:
            calls["n"] += 1
            if calls["n"] == n:
                raise KeyboardInterrupt
        return out

    mod.run_search = interrupting
    try:
        yield calls
    finally:
        mod.run_search = real


def test_fingerprint_equals_jax_and_is_sensitive(hists):
    cases = [hists, *(both(TABLE_CASES[k]) for k in sorted(TABLE_CASES))]
    for hj, hp in cases:
        fp = pck.history_fingerprint(encode_history(hp))
        assert fp == jck.history_fingerprint(jax_encode(hj))
        assert fp.startswith(pck.ENCODING_FORMAT + ":")
    enc = encode_history(hists[1])
    enc.out_tail = enc.out_tail.copy()
    enc.out_tail[0] ^= 1
    assert pck.history_fingerprint(enc) != pck.history_fingerprint(encode_history(hists[1]))


@pytest.mark.parametrize("speculate", [False, True], ids=["plain", "prune-speculate_depth2"])
def test_checkpointed_run_matches_jax_at_the_same_cadence(hists, tmp_path, speculate):
    hj, hp = hists
    kw = dict(beam=False, max_frontier=256, checkpoint_every=3, collect_stats=True)
    if speculate:
        kw.update(prune=True, speculate_depth=2)
    rj = jdev.check_device(hj, checkpoint_path=str(tmp_path / "j.ck"), **kw)
    ck = str(tmp_path / "p.ck")
    rp = pdev.check_device(hp, checkpoint_path=ck, device="cpu", **kw)
    assert rp.outcome == check(hp).outcome
    assert not os.path.exists(ck)  # a conclusive verdict removes the snapshot
    assert_same(rj, rp, hp)
    if speculate:
        assert rp.stats.spec_launches > 1


def _resume_case(name, hp):
    """(history, first run's options, preempting call, resumed run's options)"""
    if name == "in-core":
        kw = dict(beam=False, max_frontier=256, checkpoint_every=4)
        return hp, kw, dict(n=3), kw
    if name == "chunked-smaller-bucket":
        _, hp = both(jax_adversarial(6, batch=4, seed=1))
        kw = dict(beam=False, max_frontier=64, start_frontier=16, device_rows_cap=4096, checkpoint_every=1)
        return hp, kw, dict(n=6), dict(kw, max_frontier=32, checkpoint_every=4)
    # An unsatisfiable history: every layer is streamed whole, so the counts
    # do not depend on where a resumed run goes back in core.
    _, hp = both(jax_adversarial(5, batch=4, seed=2, unsatisfiable=True))
    kw = dict(beam=False, max_frontier=32, start_frontier=32, spill=True)
    return hp, kw, dict(n=5, slabs_only=True), kw


@pytest.mark.parametrize("name", ["in-core", "chunked-smaller-bucket", "spill"])
def test_resume_after_preemption(hists, tmp_path, name):
    hp, first, cut, again = _resume_case(name, hists[1])
    ck = str(tmp_path / "search.ck")
    with preempting(pdev, **cut), pytest.raises(KeyboardInterrupt):
        pdev.check_device(hp, checkpoint_path=ck, device="cpu", **first)
    if name == "spill":
        assert os.path.exists(ck + ".spill.npz")
    else:
        saved = pck.load_checkpoint(ck)
        assert saved.fingerprint == pck.history_fingerprint(encode_history(hp))
        assert saved.f > 64 if name.startswith("chunked") else saved.layers_done >= 8
    res = pdev.check_device(hp, checkpoint_path=ck, device="cpu", collect_stats=True, **again)
    want = pdev.check_device(hp, checkpoint_path=str(tmp_path / "plain.ck"), device="cpu", collect_stats=True,
                             **first)
    assert res.outcome == want.outcome == check(hp).outcome
    for f in ("layers", "max_frontier", "expanded", "auto_closed", "pruned"):
        assert getattr(res.stats, f) == getattr(want.stats, f), f
    assert not os.path.exists(ck) and not os.path.exists(ck + ".spill.npz")
    if res.outcome == CheckOutcome.OK:
        assert_replays(hp, res.linearization)


def test_beam_snapshot_cannot_resume_exhaustive(hists, tmp_path):
    _, hp = hists
    ck = str(tmp_path / "search.ck")
    with preempting(pdev, 2), pytest.raises(KeyboardInterrupt):
        pdev.check_device(hp, beam=True, checkpoint_path=ck, checkpoint_every=3, device="cpu")
    assert pck.load_checkpoint(ck).beam
    with pytest.raises(pck.CheckpointError, match="beam"):
        pdev.check_device(hp, beam=False, checkpoint_path=ck, device="cpu")


def _snap(path, enc, fp, fmt=None):
    pck.save_checkpoint(
        path,
        pck.Checkpoint(
            fingerprint=fp, counts=np.zeros((2, enc.num_chains), np.int32), tail=np.zeros(2, np.uint32),
            hi=np.zeros(2, np.uint32), lo=np.zeros(2, np.uint32), tok=np.zeros(2, np.int32),
            valid=np.zeros(2, bool), f=2, beam=False, layers_done=0, stats={},
        ),
    )
    if fmt is not None:
        with np.load(path) as z:
            d = dict(z)
        meta = bytes(d["meta"]).decode().replace('"format": 2', f'"format": {fmt}')
        d["meta"] = np.frombuffer(meta.encode(), np.uint8)
        np.savez_compressed(path + ".npz", **d)
        os.replace(path + ".npz", path)


def test_bad_snapshots_raise_checkpoint_error(hists, tmp_path):
    _, hp = hists
    enc = encode_history(hp)
    ck = str(tmp_path / "search.ck")
    run = lambda **kw: pdev.check_device(hp, beam=False, checkpoint_path=ck, device="cpu", **kw)  # noqa: E731
    with open(ck, "wb") as fh:
        fh.write(b"not a zip archive")
    for load in (lambda: pck.load_checkpoint(ck), run):
        with pytest.raises(pck.CheckpointError, match="cannot read"):
            load()
    _snap(ck, enc, f"{pck.ENCODING_FORMAT}:deadbeef")
    with pytest.raises(pck.CheckpointError, match="fingerprint"):
        run()
    _snap(ck, enc, "deadbeef")  # a snapshot from before the format tag
    with pytest.raises(pck.CheckpointError, match="encoding format"):
        run()
    _snap(ck, enc, pck.history_fingerprint(enc), fmt=1)
    with pytest.raises(pck.CheckpointError, match="format 1"):
        run()
    os.remove(ck)
    spill_ck = ck + ".spill.npz"
    with open(spill_ck, "wb") as fh:
        fh.write(b"not a zip archive")
    with pytest.raises(pck.CheckpointError, match="cannot read spill checkpoint"):
        run(spill=True)
    np.savez_compressed(spill_ck, fingerprint=np.array(pck.history_fingerprint(enc)),
                        host=np.zeros((0, enc.num_chains + 4), np.int32), layers=np.int64(0),
                        deep=np.zeros(0, np.int32))
    for kw in (dict(spill=False), dict(spill=True, beam=True)):
        with pytest.raises(pck.CheckpointError, match="spill-enabled"):
            pdev.check_device(hp, **{"beam": False, **kw}, checkpoint_path=ck, device="cpu")


def test_auto_conceded_beam_marker(tmp_path, monkeypatch):
    hj, hp = both(jax_adversarial(6, batch=2, seed=3, unsatisfiable=True))
    kw = dict(beam_width=16, exhaustive_cap=4096, spill=False, collect_stats=True)
    ck = str(tmp_path / "auto.ck")
    real = pdev.check_device
    phases = []

    def spy(history, **k):
        phases.append(k["beam"])
        if not k["beam"] and k.get("checkpoint_path") and len(phases) == 2:
            raise KeyboardInterrupt  # preempted as the exhaustive phase starts
        return real(history, **k)

    monkeypatch.setattr(pdev, "check_device", spy)
    with pytest.raises(KeyboardInterrupt):
        pdev.check_device_auto(hp, checkpoint_path=ck, device="cpu", **kw)
    marker = ck + ".beam.conceded"
    with open(marker, encoding="utf-8") as fh:
        assert fh.read() == jck.history_fingerprint(jax_encode(hj))
    assert not os.path.exists(ck + ".beam")
    phases.clear()
    res = pdev.check_device_auto(hp, checkpoint_path=ck, device="cpu", **kw)
    assert phases == [False]  # the beam phase is not replayed
    assert not os.path.exists(marker)
    assert_same(jdev.check_device_auto(hj, device_rows_cap=0, **kw), res, hp)


def test_cli_stale_checkpoint_exits_64(tmp_path, caplog):
    path = tmp_path / "a.jsonl"
    path.write_text(jax_text(collect_history(CollectConfig(num_concurrent_clients=2, num_ops_per_client=5, seed=1))))
    ck = tmp_path / "run.ckpt"
    (tmp_path / "run.ckpt.beam").write_bytes(b"garbage")  # the beam phase loads <path>.beam first
    with caplog.at_level(logging.ERROR):
        rc = pcli.main(["check", "-file", str(path), "-backend=device", "-no-viz", "-device", "cpu",
                        "-checkpoint", str(ck)])
    assert rc == 64
    assert any("remove the file or point -checkpoint elsewhere" in r.getMessage() for r in caplog.records)


def _write_snapshot(mod, hist, kind, ck, device_kw):
    """Leave a snapshot of ``kind`` at ``ck`` from engine ``mod``."""
    if kind == "in-core":
        with preempting(mod, 3), pytest.raises(KeyboardInterrupt):
            mod.check_device(hist, beam=False, max_frontier=256, checkpoint_path=ck, checkpoint_every=4,
                             **device_kw)
    else:
        res = mod.check_device(hist, beam=False, max_frontier=32, start_frontier=32, spill=True,
                               spill_host_cap=64, checkpoint_path=ck, **device_kw)
        assert res.outcome.value == "unknown" and os.path.exists(ck + ".spill.npz")


@pytest.mark.parametrize("kind", ["in-core", "spill"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_resumes_across_engines(hists, tmp_path, writer, kind):
    hj, hp = hists if kind == "in-core" else both(jax_adversarial(6, batch=4, seed=1))
    engines = {"jax": (jdev, hj, {}), "port": (pdev, hp, {"device": "cpu"})}
    mod, hist, dkw = engines[writer]
    src = str(tmp_path / "src.ck")
    _write_snapshot(mod, hist, kind, src, dkw)
    resume = dict(beam=False, max_frontier=256, checkpoint_every=4, collect_stats=True)
    if kind == "spill":
        resume = dict(beam=False, max_frontier=32, start_frontier=32, spill=True, spill_host_cap=1 << 20,
                      collect_stats=True)
    saved = {}
    if os.path.exists(src + ".spill.npz"):
        with np.load(src + ".spill.npz") as z:
            saved = json.loads(bytes(z["stats"]).decode()) if "stats" in z else {}
    out = {}
    for who, (m, h, kw) in engines.items():
        ck = str(tmp_path / f"{who}.ck")
        for suffix in ("", ".spill.npz"):
            if os.path.exists(src + suffix):
                shutil.copy(src + suffix, ck + suffix)
        out[who] = m.check_device(h, checkpoint_path=ck, **kw, **resume)
        assert not os.path.exists(ck) and not os.path.exists(ck + ".spill.npz")
    assert out["port"].outcome == check(hp).outcome
    if saved:
        # The port's spill snapshot also keeps the statistics so far, which
        # the JAX engine does not read: it counts from the snapshot on.
        assert writer == "port" and saved["expanded"] > 0
        for f in ("expanded", "auto_closed"):
            setattr(out["jax"].stats, f, getattr(out["jax"].stats, f) + saved[f])
        out["jax"].stats.max_frontier = max(out["jax"].stats.max_frontier, saved["max_frontier"])
    assert_same(out["jax"], out["port"], hp)
