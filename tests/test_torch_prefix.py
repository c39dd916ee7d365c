"""Incremental verification in the port — ``checker/prefix.py``,
``service/prefixstore.py``, the host frontier's resume and snapshot cuts,
and the daemon's prefix path and ``follow`` op — held against the JAX
package.

- The prefix geometry on seeded collected histories (pending ops
  included): ``closed_boundaries``, ``has_open_ops``, ``boundary_counts``,
  ``choose_cuts``, ``PrefixCarry`` payloads, ``prefix_key``,
  ``prefix_accumulators``, ``affinity_key``, ``plan_for_submit`` and
  ``plan_for_window`` equal the JAX package's.
- The frontier: ``check_frontier`` and ``check_frontier_auto`` with
  ``snapshot_cuts``, ``init_counts`` / ``init_states`` (a resume from each
  snapshot), ``complete_cuts`` and a ``progress`` sink give the JAX
  engine's outcome, statistics, heartbeats and snapshots, the snapshots
  compared cut by cut as sets of states; ``state_digest`` is the JAX
  digest.
- The thirteen cases of ``tests/test_prefix.py`` (the router's edge-cache
  guard against window-scoped replies included), run over both packages.
- Across packages: the same submits give byte-equal prefix segments in
  each package's state dir, each ``read_cold`` reads the other's, and a
  follow lineage one package's daemon began on a state dir is continued by
  the other's with the same frontier tokens.
"""

from __future__ import annotations

import argparse
import glob
import importlib
import io
import json
import os
from pathlib import Path
from types import SimpleNamespace

import pytest

from helpers import H, fold
from s2_verification_tpu.checker import frontier as jfr
from s2_verification_tpu.checker import prefix as jpre
from s2_verification_tpu.checker.entries import prepare as jax_prepare
from s2_verification_tpu.checker.progress import ProgressSink as JaxSink
from s2_verification_tpu.models.stream import StreamState as JaxState
from s2_verification_tpu.service import prefixstore as jps
from s2_verification_tpu.service.cache import history_fingerprint as jax_fp
from s2_verification_tpu.utils import events as jev
from s2_verification_tpu.utils.events import AppendIndefiniteFailure
from s2_verification_tpu_torch.checker import frontier as pfr
from s2_verification_tpu_torch.checker import prefix as ppre
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.progress import ProgressSink as PortSink
from s2_verification_tpu_torch.models.stream import StreamState
from s2_verification_tpu_torch.service import prefixstore as pps
from s2_verification_tpu_torch.service.cache import history_fingerprint
from s2_verification_tpu_torch.utils import events as pev

from test_torch_encode import collected, jax_text
from test_torch_progress import Clock
from test_torch_service import time_limit

PACKAGES = ("s2_verification_tpu", "s2_verification_tpu_torch")
JAX, PORT = PACKAGES


def _text(h: H) -> str:
    buf = io.StringIO()
    jev.write_history(h.events, buf)  # the text both packages read
    return buf.getvalue()


def serial_lines(n_ops: int, seed: int = 0) -> list[str]:
    """A serial single-client all-OK history (2 JSONL lines per op): every
    op boundary is a closed cut."""
    h = H()
    hashes: list[int] = []
    for k in range(n_ops):
        if k % 2 == 0:
            hashes.append(1000 + k + seed)
            h.append_ok(1, [hashes[-1]], tail=len(hashes))
        else:
            h.read_ok(1, tail=len(hashes), stream_hash=fold(hashes))
    return [ln for ln in _text(h).splitlines() if ln.strip()]


def _join(lines: list[str]) -> str:
    return "\n".join(lines) + "\n"


def both(text: str):
    """(JAX History, port History) of one JSONL text, as the daemons
    prepare it (trivial ops elided)."""
    return (
        jax_prepare(list(jev.iter_history(text)), elide_trivial=True),
        prepare(list(pev.iter_history(text)), elide_trivial=True),
    )


def _truncated(text: str, drop: int) -> str:
    """``text`` without its last ``drop`` finish events: their calls stay
    open (pending ops)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    finishes = [i for i, ln in enumerate(lines) if not jev.decode_obj(json.loads(ln)).is_start]
    gone = set(finishes[-drop:])
    return _join([ln for i, ln in enumerate(lines) if i not in gone])


def _geometry_texts() -> dict:
    out = {}
    for wf in ("regular", "match-seq-num", "fencing"):
        for seed in (0, 1):
            text = jax_text(collected(wf, seed=seed, clients=3, ops=10))
            out[f"{wf}-{seed}"] = text
            if seed == 0:
                out[f"{wf}-{seed}-pending"] = _truncated(text, 2)
    out["serial"] = _join(serial_lines(24))
    # Rounds of two concurrent indefinite appends, then a check-tail that
    # saw exactly one of them: every round boundary is a closed cut whose
    # state union holds several states (2^r after round r).
    h = H()
    for r in range(4):
        a = h.call_append(1, [10 * r + 1])
        b = h.call_append(2, [10 * r + 2])
        h.finish(1, a, AppendIndefiniteFailure())
        h.finish(2, b, AppendIndefiniteFailure())
        h.check_tail_ok(3, tail=r + 1)
    out["branchy"] = _text(h)
    h = H()
    h.append_ok(1, [1], tail=1)
    h.read_ok(1, tail=1, stream_hash=fold([1]))
    h.append_ok(1, [2], tail=2)
    h.call_append(2, [3])  # never finishes
    out["serial-dangling"] = _text(h)
    return out


GEOMETRY = _geometry_texts()


def _states(states) -> list:
    return sorted((s.tail, s.stream_hash, s.fencing_token) for s in states)


def _plan_view(plan) -> dict | None:
    if plan is None:
        return None
    return {
        "kind": plan.kind,
        "carry": None if plan.carry is None else plan.carry.to_payload(),
        "resume_counts": plan.resume_counts,
        "snap_keys": plan.snap_keys,
        "base_ops": plan.base_ops,
        "base_events": plan.base_events,
        "stream": plan.stream,
        "window": plan.window,
        "probed": plan.probed,
        "refused": plan.refused,
        "resume_ops": plan.resume_ops,
    }


# -- the prefix geometry ---------------------------------------------------------


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_prefix_geometry_matches_jax(name):
    hj, hp = both(GEOMETRY[name])
    bounds = ppre.closed_boundaries(hp)
    assert bounds == jpre.closed_boundaries(hj)
    assert ppre.has_open_ops(hp) == jpre.has_open_ops(hj)
    assert [ppre.boundary_counts(hp, k) for k in bounds] == [jpre.boundary_counts(hj, k) for k in bounds]
    for max_cuts in (1, 3, 8):
        assert ppre.choose_cuts(hp, max_cuts) == jpre.choose_cuts(hj, max_cuts)
    keys = pps.prefix_accumulators(hp)
    assert keys == jps.prefix_accumulators(hj) and (keys or not bounds)
    lineage = dict(acc=0x1234_5678_9ABC_DEF0, ops_base=17, event_offset=40)
    assert pps.prefix_accumulators(hp, bounds[:2], **lineage) == jps.prefix_accumulators(hj, bounds[:2], **lineage)
    fp = history_fingerprint(hp)
    assert fp == jax_fp(hj)
    assert pps.affinity_key(hp, fp) == jps.affinity_key(hj, fp)
    if keys:
        acc, ops = pps.parse_prefix_key(keys[max(keys)])
        assert (acc, ops) == jps.parse_prefix_key(keys[max(keys)])
        assert pps.prefix_key(acc, ops) == jps.prefix_key(acc, ops) == keys[max(keys)]


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_prefix_plans_and_carries_match_jax(name):
    hj, hp = both(GEOMETRY[name])
    # A store that holds a carry at the middle closed cut (and one that is
    # empty): the submit plans, hit or miss, are the JAX package's.
    keys = pps.prefix_accumulators(hp)
    stores = {"jax": jps.PrefixStore(capacity=8), "port": pps.PrefixStore(capacity=8)}
    carries = {}
    if keys:
        mid = sorted(keys)[len(keys) // 2]
        for who, store, carry_cls, state_cls in (
            ("jax", stores["jax"], jpre.PrefixCarry, JaxState),
            ("port", stores["port"], ppre.PrefixCarry, StreamState),
        ):
            carry = carry_cls(ops=mid, states=(state_cls(tail=mid, stream_hash=mid * 7, fencing_token=None),))
            carries[who] = carry
            store.put(keys[mid], (jps if who == "jax" else pps).make_entry(carry, events=2 * mid))
        assert carries["port"].to_payload() == carries["jax"].to_payload()
        assert ppre.PrefixCarry.from_payload(carries["jax"].to_payload()) == carries["port"]
    for max_cuts, min_ops in ((8, 4), (3, 1), (8, 10_000)):
        pj = jps.plan_for_submit(stores["jax"], hj, max_cuts=max_cuts, min_ops=min_ops)
        pp = pps.plan_for_submit(stores["port"], hp, max_cuts=max_cuts, min_ops=min_ops)
        assert _plan_view(pp) == _plan_view(pj)
    # Windows: a first window, and one continuing a lineage.
    assert _plan_view(pps.plan_for_window(hp, token=None, entry=None, stream="s")) == _plan_view(
        jps.plan_for_window(hj, token=None, entry=None, stream="s")
    )
    token = "pv2:00000000deadbeef:5"
    entry = {"n": 5, "s": [[3, 99, None], [4, 100, "tok"]], "e": 12, "stream": "s", "w": 2}
    assert _plan_view(pps.plan_for_window(hp, token=token, entry=entry, stream="s")) == _plan_view(
        jps.plan_for_window(hj, token=token, entry=dict(entry), stream="s")
    )


# -- the frontier: resume and snapshot cuts ---------------------------------------

FRONTIER_STATS = ("layers", "max_frontier", "max_state_set", "auto_closed", "expanded", "pruned",
                  "prune_commits", "prune_dead", "prune_ranked")
FRONTIER_CASES = [n for n in GEOMETRY if not n.endswith("dangling")]


def _frontier_view(res) -> dict:
    st = getattr(res, "stats", None)
    snaps = getattr(res, "snapshots", None) or {}
    return {
        "outcome": res.outcome.value,
        "stats": None if st is None else {f: getattr(st, f) for f in FRONTIER_STATS},
        "snapshots": {k: _states(v) for k, v in snaps.items()},
        "final": None if res.final_states is None else _states(res.final_states),
        "linearization": res.linearization,
    }


@pytest.mark.parametrize("entry", ["check_frontier", "check_frontier_auto"])
@pytest.mark.parametrize("name", FRONTIER_CASES)
def test_frontier_snapshots_and_resume_match_jax(name, entry):
    hj, hp = both(GEOMETRY[name])
    cuts = jpre.closed_boundaries(hj)
    kw = dict(collect_stats=True, witness=False, snapshot_cuts=cuts)
    cold_j = getattr(jfr, entry)(hj, **kw)
    cold_p = getattr(pfr, entry)(hp, **kw)
    assert _frontier_view(cold_p) == _frontier_view(cold_j)
    if name == "branchy":
        assert any(len(v) > 1 for v in _frontier_view(cold_p)["snapshots"].values())
    # Resume from every snapshot (the last three): same outcome and stats
    # as the JAX engine's resume from the same carry.
    snaps = getattr(cold_p, "snapshots", None) or {}
    for k in sorted(snaps)[-3:]:
        counts = ppre.boundary_counts(hp, k)
        rj = getattr(jfr, entry)(
            hj, collect_stats=True, witness=False, init_counts=counts,
            init_states=[JaxState(*s) for s in _states(snaps[k])], snapshot_cuts=[c for c in cuts if c > k],
        )
        rp = getattr(pfr, entry)(
            hp, collect_stats=True, witness=False, init_counts=counts, init_states=snaps[k],
            snapshot_cuts=[c for c in cuts if c > k],
        )
        assert _frontier_view(rp) == _frontier_view(rj), k
        assert rp.outcome == cold_p.outcome


@pytest.mark.parametrize("name", FRONTIER_CASES)
def test_frontier_complete_cuts_and_progress_match_jax(name):
    hj, hp = both(GEOMETRY[name])
    cuts = jpre.closed_boundaries(hj)
    out = {}
    for who, mod, sink_cls in (("jax", jfr, JaxSink), ("port", pfr, PortSink)):
        beats = []
        sink = sink_cls(beats.append, min_interval_s=0.5, time_fn=Clock(step=1.0))
        res = mod.check_frontier(hp if who == "port" else hj, collect_stats=True, witness=False, snapshot_cuts=cuts,
                                 complete_cuts=True, progress=sink)
        out[who] = (_frontier_view(res), beats)
    assert out["port"] == out["jax"]
    if out["port"][0]["outcome"] == "ok" and cuts:
        # complete_cuts holds the accept until every requested union is
        # exact: the deepest cut is always among the snapshots.
        assert max(cuts) in out["port"][0]["snapshots"]


def test_state_digest_is_the_jax_digest():
    for s in [(0, 0, None), (3, 0xFFFF_FFFF_FFFF_FFFF, "tok"), (12, 42, "")]:
        assert pfr.state_digest(StreamState(*s)) == jfr.state_digest(JaxState(*s))
    assert "state_digest" in pfr.__all__


# -- tests/test_prefix.py, over both packages -----------------------------------

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    "prepare": ("checker.entries", "prepare"),
    "PrefixCarry": ("checker.prefix", "PrefixCarry"),
    "has_open_ops": ("checker.prefix", "has_open_ops"),
    "Campaign": ("collector.campaign", "Campaign"),
    "CampaignPhase": ("collector.campaign", "CampaignPhase"),
    "collect_labeled": ("collector.campaign", "collect_labeled"),
    "FaultPlan": ("collector.fake_s2", "FaultPlan"),
    "StreamState": ("models.stream", "StreamState"),
    "history_fingerprint": ("service.cache", "history_fingerprint"),
    "VerifydClient": ("service.client", "VerifydClient"),
    "VerifydError": ("service.client", "VerifydError"),
    "Verifyd": ("service.daemon", "Verifyd"),
    "VerifydConfig": ("service.daemon", "VerifydConfig"),
    "ps": ("service.prefixstore", None),
    "protocol": ("service.protocol", None),
    "BackendSpec": ("service.router", "BackendSpec"),
    "RouterConfig": ("service.router", "RouterConfig"),
    "VerifydRouter": ("service.router", "VerifydRouter"),
    "ev": ("utils.events", None),
    "cli": ("cli", None),
}


@pytest.fixture(params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    for name, (mod, attr) in _NAMES.items():
        m = importlib.import_module(f"{request.param}.{mod}")
        setattr(P, name, getattr(m, attr) if attr else m)
    with time_limit(120):
        yield request.param


def _prep(text: str):
    return P.prepare(list(P.ev.iter_history(text)), elide_trivial=True)


def _daemon_cfg(tmp_path, **overrides):
    kw = dict(
        socket_path=str(tmp_path / "verifyd.sock"),
        workers=1,
        device="off",
        time_budget_s=10.0,
        out_dir=str(tmp_path / "viz"),
        stats_log=str(tmp_path / "stats.jsonl"),
        no_viz=True,
        prefix_enabled=True,
    )
    kw.update(overrides)
    return P.VerifydConfig(**kw)


def _stats_events(tmp_path) -> list[dict]:
    with open(tmp_path / "stats.jsonl", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _closed_cut(lines: list[str], frac: float = 0.6) -> int:
    """Line index nearest ``frac`` through the stream where no call is
    open — an event cut no op spans (0 when none exists)."""
    open_ops: set = set()
    cuts = []
    for i, line in enumerate(lines):
        le = jev.decode_obj(json.loads(line))
        if le.is_start:
            open_ops.add((le.client_id, le.op_id))
        else:
            open_ops.discard((le.client_id, le.op_id))
        if not open_ops:
            cuts.append(i + 1)
    interior = [c for c in cuts if 0 < c < len(lines)]
    if not interior:
        return 0
    target = frac * len(lines)
    return min(interior, key=lambda c: abs(c - target))


def _campaign(cls: str | None, workflow: str = "regular"):
    quiet = P.FaultPlan(min_latency=0.001, max_latency=0.003)
    phases = (
        (P.CampaignPhase("steady", 1.0, faults=quiet),)
        if cls is None
        else (
            P.CampaignPhase("warm", 0.02, faults=quiet),
            P.CampaignPhase("violate", 1.0, faults=quiet, violation=cls),
        )
    )
    return P.Campaign(name=f"t-{cls or 'legal'}-{workflow}", workflow=workflow, clients=3, ops=16, phases=phases)


def test_plan_refuses_snapshot_across_open_ops(package):
    hist = _prep(GEOMETRY["serial-dangling"])
    assert P.has_open_ops(hist)
    store = P.ps.PrefixStore(capacity=8)
    plan = P.ps.plan_for_submit(store, hist, min_ops=2)
    assert plan is not None
    assert plan.refused == "open_ops"
    assert len(hist.ops) not in plan.snap_keys


def test_store_refuses_malformed_entries(package):
    store = P.ps.PrefixStore(capacity=8)
    with pytest.raises(ValueError):
        store.put("pv2:0:1", {"n": 1, "s": []})  # empty carried state set
    with pytest.raises(ValueError):
        P.PrefixCarry.from_payload({"n": 1, "s": []})


def test_affinity_key_stable_under_extension(package):
    """The ring key of a history and of its extension agree — the whole
    lineage homes on the node holding the snapshots — while distinct
    streams separate."""
    short = _prep(_join(serial_lines(12)))
    long = _prep(_join(serial_lines(40)))
    other = _prep(_join(serial_lines(12, seed=7)))
    k_short = P.ps.affinity_key(short, P.history_fingerprint(short))
    k_long = P.ps.affinity_key(long, P.history_fingerprint(long))
    k_other = P.ps.affinity_key(other, P.history_fingerprint(other))
    assert k_short == k_long
    assert k_short != k_other
    # The router places by this very key.
    assert P.VerifydRouter._affinity_key(long, P.history_fingerprint(long)) == k_long


_PARITY_CASES = [
    ("legal-serial-appends", None, None),
    ("legal-serial-mixed", None, None),
    ("legal-regular", None, "regular"),
    ("legal-match-seq-num", None, "match-seq-num"),
    ("legal-fencing", None, "fencing"),
    ("violation-drop_acked", "drop_acked", "regular"),
    ("violation-reorder", "reorder", "regular"),
    ("violation-stale_read", "stale_read", "regular"),
    ("violation-fence_resurrect", "fence_resurrect", "fencing"),
]


def _parity_text(name: str, cls: str | None, workflow: str | None):
    """(history text, expected verdict) for one parity case."""
    if workflow is None:
        if name.endswith("appends"):
            h = H()
            for k in range(12):
                h.append_ok(1, [100 + k], tail=k + 1)
            return _text(h), 0
        return _join(serial_lines(16)), 0
    events, label = P.collect_labeled(_campaign(cls, workflow), seed=11)
    if cls is not None:
        assert label["fired"] and label["confirmed"], name
        assert label["expect"] == "illegal", name
    buf = io.StringIO()
    P.ev.write_history(events, buf)
    return buf.getvalue(), 0 if cls is None else 1


def test_warm_vs_cold_verdict_parity(package, tmp_path):
    """For five legal shapes and all four ground-truth violation classes,
    a daemon whose store was warmed with a committed prefix answers the
    full history with the verdict a prefix-less daemon computes cold."""
    warm_dir = tmp_path / "warm"
    cold_dir = tmp_path / "cold"
    warm_dir.mkdir()
    cold_dir.mkdir()
    warm_cfg = _daemon_cfg(warm_dir)
    cold_cfg = _daemon_cfg(cold_dir, prefix_enabled=False)
    resumed = 0
    with P.Verifyd(warm_cfg), P.Verifyd(cold_cfg):
        warm = P.VerifydClient(warm_cfg.socket_path, timeout=120)
        cold = P.VerifydClient(cold_cfg.socket_path, timeout=120)
        for name, cls, workflow in _PARITY_CASES:
            text, expected = _parity_text(name, cls, workflow)
            lines = [ln for ln in text.splitlines() if ln.strip()]
            cut = _closed_cut(lines)
            if cut:
                warm.submit(_join(lines[:cut]), no_viz=True)
            warm_reply = warm.submit(text, no_viz=True)
            cold_reply = cold.submit(text, no_viz=True)
            assert warm_reply["verdict"] == cold_reply["verdict"] == expected, name
            assert warm_reply["outcome"] == cold_reply["outcome"], name
            assert warm_reply["ops"] == cold_reply["ops"], name
            assert not cold_reply["backend"].startswith("frontier-resume")
            if warm_reply["backend"].startswith("frontier-resume"):
                resumed += 1
    assert resumed >= 2


def test_illegal_suffix_after_cached_ok_prefix(package, tmp_path):
    """An OK prefix is cached; an extension with a violating suffix must
    still answer ILLEGAL from the resumed frontier."""
    h = H()
    hashes = []
    for k in range(24):
        if k % 2 == 0:
            hashes.append(1000 + k)
            h.append_ok(1, [hashes[-1]], tail=len(hashes))
        else:
            h.read_ok(1, tail=len(hashes), stream_hash=fold(hashes))
    prefix_text = _text(h)
    h.read_ok(2, tail=999, stream_hash=424242)  # unjustifiable read
    cfg = _daemon_cfg(tmp_path)
    with P.Verifyd(cfg):
        client = P.VerifydClient(cfg.socket_path, timeout=120)
        assert client.submit(prefix_text, no_viz=True)["verdict"] == 0
        reply = client.submit(_text(h), no_viz=True)
        assert reply["verdict"] == 1
        assert reply["backend"].startswith("frontier-resume")
    hits = [e for e in _stats_events(tmp_path) if e.get("ev") == "prefix_hit"]
    assert hits and hits[-1]["resume_ops"] > 0


def test_prefix_store_survives_torn_tail(package, tmp_path):
    """A torn record at the tail: recovery drops exactly the tail and keeps
    every intact snapshot."""
    d = str(tmp_path / P.ps.PREFIX_SUBDIR)
    hist = _prep(_join(serial_lines(8)))
    keys = P.ps.prefix_accumulators(hist)
    store = P.ps.PrefixStore(capacity=16, persist_dir=d)
    for k in sorted(keys):
        carry = P.PrefixCarry(ops=k, states=(P.StreamState(tail=k, stream_hash=0, fencing_token=None),))
        store.put(keys[k], P.ps.make_entry(carry, events=2 * k))
    n = len(store)
    assert n >= 2
    store.close()
    seg = sorted(glob.glob(os.path.join(d, "seg-*.log")))[-1]
    with open(seg, "ab") as f:
        f.write(b"\x00\x01torn")  # mid-append death
    reopened = P.ps.PrefixStore(capacity=16, persist_dir=d)
    assert len(reopened) == n
    assert reopened.recovery is not None
    assert reopened.recovery.torn_tail_bytes > 0
    reopened.close()
    cold = P.ps.read_cold(str(tmp_path))
    assert cold is not None
    assert cold["entries"] == n
    assert cold["recovery"]["torn_tail_bytes"] > 0
    assert cold["deepest_ops"] == max(keys)


def test_follow_end_to_end_restart_and_cross_lineage(package, tmp_path):
    """Windows advance a frontier, the lineage survives a restart on the
    same state dir, a full-history submit resumes from snapshots a follow
    lineage wrote, and an unknown token is a definite error."""
    lines = serial_lines(60)  # 120 JSONL lines, 20 ops per 40-line window
    state = str(tmp_path / "state")
    cfg = _daemon_cfg(tmp_path, state_dir=state)
    with P.Verifyd(cfg):
        client = P.VerifydClient(cfg.socket_path, timeout=120)
        r1 = client.follow(_join(lines[:40]), stream="orders")
        assert r1["verdict"] == 0 and r1["scope"] == "window"
        assert r1["advanced"] and r1["window"] == 0
        assert r1["ops_total"] == 20
        token = r1["frontier"]
        assert token.startswith("pv")
        r2 = client.follow(_join(lines[40:80]), stream="orders", frontier=token)
        assert r2["verdict"] == 0 and r2["window"] == 1
        assert r2["ops_total"] == 40
        assert r2["backend"].startswith("frontier-resume")
        token = r2["frontier"]
        full = client.submit(_join(lines[:80]), no_viz=True)
        assert full["verdict"] == 0
        assert full["backend"].startswith("frontier-resume")
    cfg2 = _daemon_cfg(tmp_path, state_dir=state)
    with P.Verifyd(cfg2):
        client = P.VerifydClient(cfg2.socket_path, timeout=120)
        r3 = client.follow(_join(lines[80:120]), stream="orders", frontier=token)
        assert r3["verdict"] == 0 and r3["ops_total"] == 60
        assert r3["backend"].startswith("frontier-resume")
        with pytest.raises(P.VerifydError) as exc:
            client.follow(_join(lines[:2]), stream="orders", frontier="pv2:00000000deadbeef:4")
        assert exc.value.cls == P.protocol.ERR_FRONTIER
    names = [e.get("ev") for e in _stats_events(tmp_path)]
    assert "prefix_loaded" in names  # the second boot replayed the log
    assert "window_done" in names
    assert "prefix_snapshot" in names


def test_follow_catches_violation_in_window(package, tmp_path):
    lines = serial_lines(20)
    bad = H()
    bad.read_ok(1, tail=1, stream_hash=99999)
    bad_lines = [ln for ln in _text(bad).splitlines() if ln.strip()]
    cfg = _daemon_cfg(tmp_path)
    with P.Verifyd(cfg):
        client = P.VerifydClient(cfg.socket_path, timeout=120)
        r1 = client.follow(_join(lines), stream="s")
        assert r1["verdict"] == 0
        r2 = client.follow(_join(bad_lines), stream="s", frontier=r1["frontier"])
        assert r2["verdict"] == 1
        assert not r2["advanced"]  # an illegal window never commits
        assert r2["frontier"] == r1["frontier"]


def test_follow_open_window_and_missing_store(package, tmp_path):
    """A window with a dangling call gets a verdict but no advance; a
    daemon without the prefix store refuses the op."""
    h = H()
    h.append_ok(1, [1], tail=1)
    h.read_ok(1, tail=1, stream_hash=fold([1]))
    h.append_ok(1, [2], tail=2)
    h.read_ok(1, tail=2, stream_hash=fold([1, 2]))
    h.call_append(2, [3])  # dangling call spans the window edge
    cfg = _daemon_cfg(tmp_path)
    with P.Verifyd(cfg):
        client = P.VerifydClient(cfg.socket_path, timeout=120)
        r = client.follow(_text(h), stream="s")
        assert r["verdict"] == 0
        assert not r["advanced"]
        assert r["frontier"] is None  # lineage never started
    nostore = tmp_path / "nostore"
    nostore.mkdir()
    cfg2 = _daemon_cfg(nostore, prefix_enabled=False)
    with P.Verifyd(cfg2):
        client = P.VerifydClient(cfg2.socket_path, timeout=120)
        with pytest.raises(P.VerifydError) as exc:
            client.follow(_join(serial_lines(8)), stream="s")
        assert exc.value.cls == P.protocol.ERR_DECODE


def test_window_verdict_never_enters_verdict_cache(package, tmp_path):
    """A window OK'd under a carried frontier describes stream-so-far: the
    same text submitted cold gets a fresh search, not a cache answer."""
    lines = serial_lines(40)
    cfg = _daemon_cfg(tmp_path)
    with P.Verifyd(cfg):
        client = P.VerifydClient(cfg.socket_path, timeout=120)
        r1 = client.follow(_join(lines[:40]), stream="s")
        window2 = _join(lines[40:])
        r2 = client.follow(window2, stream="s", frontier=r1["frontier"])
        assert r2["verdict"] == 0
        standalone = client.submit(window2, no_viz=True)
        assert not standalone.get("cached")
        assert standalone["verdict"] == 1


def test_router_edge_cache_refuses_window_scope(package, tmp_path):
    """The router-side guard for the same rule: replies stamped
    ``scope=window`` never populate the fingerprint-keyed edge cache."""
    router = P.VerifydRouter(
        P.RouterConfig(
            listen=str(tmp_path / "r.sock"),
            backends=(P.BackendSpec("a", str(tmp_path / "a.sock")),),
        )
    )
    window_reply = {"verdict": 0, "scope": "window", "outcome": "OK"}
    router._cache_store(b"k1", "fp1", "aff1", window_reply)
    assert "fp1" not in router._verdicts
    full_reply = {"verdict": 0, "outcome": "OK"}
    router._cache_store(b"k2", "fp2", "aff2", full_reply)
    assert "fp2" in router._verdicts


def _follow_args(path, **overrides):
    kw = dict(file=str(path), socket="/tmp/nonexistent.sock", secret_file=None, stream="s", frontier=None,
              window=10, client="cli", priority=10, timeout=None, deadline=None, window_retries=2, stats=False)
    kw.update(overrides)
    return argparse.Namespace(**kw)


def test_follow_cli_uncarried_window_retries_then_stops(package, tmp_path, monkeypatch):
    """An uncarried window is retried as a resync and, still uncarried,
    stops the follow with exit 2."""
    lines = serial_lines(10)  # 20 JSONL lines -> two 10-event windows
    f = tmp_path / "s.jsonl"
    f.write_text(_join(lines))
    calls = []

    def fake_follow(self, history_text=None, *, records=None, stream, frontier=None, **kw):
        calls.append((history_text, frontier))
        return {"verdict": 2, "outcome": "UNKNOWN", "ops": 5, "ops_total": 5, "advanced": False,
                "frontier": frontier, "backend": "b"}

    monkeypatch.setattr(P.VerifydClient, "follow", fake_follow)
    assert P.cli._cmd_follow(_follow_args(f)) == 2
    assert len(calls) == 3  # first try + 2 resync retries, then stop
    assert calls[1][1] is None and calls[2][1] is None
    assert all(text == _join(lines[:10]) for text, _ in calls)


def test_follow_cli_resync_recovers_uncarried_window(package, tmp_path, monkeypatch):
    """A window carried by its resync commits, and the next window rides
    the resync's frontier with only its own events."""
    lines = serial_lines(10)
    f = tmp_path / "s.jsonl"
    f.write_text(_join(lines))
    calls = []

    def fake_follow(self, history_text=None, *, records=None, stream, frontier=None, **kw):
        calls.append((history_text, frontier))
        n = len(calls)
        if n == 1:
            return {"verdict": 2, "outcome": "UNKNOWN", "ops": 5, "ops_total": 5, "advanced": False,
                    "frontier": None, "backend": "b"}
        ops = history_text.count("\n") // 2
        return {"verdict": 0, "outcome": "OK", "ops": ops, "ops_total": ops, "advanced": True,
                "frontier": f"tok{n}", "backend": "b"}

    monkeypatch.setattr(P.VerifydClient, "follow", fake_follow)
    assert P.cli._cmd_follow(_follow_args(f)) == 0
    assert [fr for _, fr in calls] == [None, None, "tok2"]
    assert calls[2][0] == _join(lines[10:])


# -- across packages ---------------------------------------------------------------


def _pkg(root):
    return SimpleNamespace(**{
        name: importlib.import_module(f"{root}.{mod}")
        for name, mod in (("daemon", "service.daemon"), ("client", "service.client"), ("ps", "service.prefixstore"))
    })


def _segments(state: Path) -> list[bytes]:
    return [p.read_bytes() for p in sorted((state / "prefix").glob("seg-*.log"))]


def test_prefix_segments_are_byte_equal_and_read_cold_across_packages(tmp_path):
    """The same submits and follow windows through each package's daemon
    leave byte-equal ``<state_dir>/prefix`` segments, and each package's
    ``read_cold`` reads the other's directory as its own."""
    lines = serial_lines(40)
    texts = [_join(lines[:30]), _join(lines[:60]), GEOMETRY["match-seq-num-0"], GEOMETRY["branchy"]]
    states = {}
    with time_limit(120):
        for root in PACKAGES:
            m = _pkg(root)
            state = tmp_path / root / "state"
            cfg = m.daemon.VerifydConfig(socket_path=str(tmp_path / f"{root}.sock"), workers=1, device="off",
                                         no_viz=True, prefix_enabled=True, state_dir=str(state))
            with m.daemon.Verifyd(cfg):
                c = m.client.VerifydClient(cfg.socket_path, timeout=120)
                for t in texts:
                    assert c.submit(t, no_viz=True)["verdict"] == 0
                r = c.follow(_join(lines[:20]), stream="x")
                c.follow(_join(lines[20:]), stream="x", frontier=r["frontier"])
            states[root] = state
    assert _segments(states[PORT]) == _segments(states[JAX]) != []
    for reader in (jps, pps):
        assert reader.read_cold(str(states[PORT])) == reader.read_cold(str(states[JAX]))
    assert pps.read_cold(str(states[JAX]))["streams"]["x"]["ops"] == 40


@pytest.mark.parametrize("first,second", [(JAX, PORT), (PORT, JAX)], ids=["jax-then-port", "port-then-jax"])
def test_follow_lineage_continues_across_packages(tmp_path, first, second):
    """A lineage one package's daemon began on a state dir is continued by
    the other package's daemon on that dir: the same tokens, verdicts and
    totals as one package's daemon following the whole stream."""
    lines = serial_lines(60)
    windows = [lines[:40], lines[40:80], lines[80:]]

    def follow(root, state, chunk, token):
        m = _pkg(root)
        cfg = m.daemon.VerifydConfig(socket_path=str(tmp_path / f"{root}.sock"), workers=1, device="off",
                                     no_viz=True, prefix_enabled=True, state_dir=str(state))
        with m.daemon.Verifyd(cfg):
            r = m.client.VerifydClient(cfg.socket_path, timeout=120).follow(_join(chunk), stream="o",
                                                                           frontier=token)
        return (r["verdict"], r["advanced"], r["ops_total"], r["frontier"], r["backend"])

    with time_limit(120):
        alone, token = [], None
        for chunk in windows:
            alone.append(follow(first, tmp_path / "alone", chunk, token))
            token = alone[-1][3]
        crossed, token = [], None
        for i, chunk in enumerate(windows):
            crossed.append(follow(first if i == 0 else second, tmp_path / "crossed", chunk, token))
            token = crossed[-1][3]
    assert crossed == alone
    assert [r[2] for r in crossed] == [20, 40, 60] and all(r[0] == 0 and r[1] for r in crossed)
    assert [r[4] for r in crossed] == ["frontier-cold", "frontier-resume", "frontier-resume"]
    # The other package's follow CLI continues the lineage too.
    f = tmp_path / "more.jsonl"
    more = serial_lines(80)[120:]
    f.write_text(_join(more))
    m = _pkg(first)
    cfg = m.daemon.VerifydConfig(socket_path=str(tmp_path / "cli.sock"), workers=1, device="off", no_viz=True,
                                 prefix_enabled=True, state_dir=str(tmp_path / "crossed"))
    with time_limit(120), m.daemon.Verifyd(cfg):
        other = importlib.import_module(f"{second}.cli")
        assert other.main(["follow", "-file", str(f), "-socket", cfg.socket_path, "--stream", "o", "--frontier",
                           token, "--window", "20"]) == 0
    assert pps.read_cold(str(tmp_path / "crossed"))["streams"]["o"]["ops"] == 80
