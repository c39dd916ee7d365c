"""Port parity: the frontier search sharded over a mesh.

Held integer-exact (tolerance 0) on meshes of CPU shards (a device may
repeat, so eight shards share the CPU):

- after every ``run_search`` call over 1, 2, 4 and 8 shards, the shards
  concatenated equal the unsharded port's frontier (all five arrays) and
  every other ``RunOut`` field is equal: collected and adversarial
  histories, probe dedup on the packed and on the Zobrist key, sort dedup,
  beam pruning on and off, the witness log and the speculative dive;
- ``check_device(mesh=)`` over 8 shards against the JAX engine's
  ``check_device`` over its 8-device CPU mesh (the ports of
  ``tests/test_device.py``'s ``test_device_sharded_over_mesh`` and
  ``test_spill_sharded_over_mesh``): outcome, statistics, per-shard
  occupancy (peak, sum, segments, skew) and the profile's per-segment
  shard lists, with a witness that replays, and the HTML's mesh-shard
  panel equal to the JAX package's;
- a checkpoint resumed onto a wider mesh (2 → 8 shards, the bucket regrown
  to one row per shard) gives the uninterrupted run's counts;
- ``check_device_auto(mesh=)`` through both phases equals the unsharded
  port's;
- random adversarial histories over random shard counts decide as unsharded;
- the mesh's own contracts: an uneven placement, a CUDA mesh without a
  card, ``multiprocess_supported``'s classification.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh

from s2_verification_tpu import viz as jviz
from s2_verification_tpu.checker.entries import prepare as jax_prepare
from s2_verification_tpu.collector.collect import CollectConfig, collect_history
from s2_verification_tpu.collector.fake_s2 import FaultPlan
from s2_verification_tpu_torch import viz as pviz
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.oracle import CheckOutcome
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.models.encode import encode_history
from s2_verification_tpu_torch.parallel import distributed as pdist
from s2_verification_tpu_torch.parallel import frontier_mesh, multiprocess_supported

from test_torch_checkpoint import preempting
from test_torch_device import TABLE_CASES, assert_replays, both, jax_adversarial, jdev
from test_torch_encode import to_port
from test_torch_keywords import STAT_FIELDS

SHARDS = (1, 2, 4, 8)
SHARD_FIELDS = ("peak_occupancy", "occupancy_sum", "segments", "skew")


def cpu_mesh(n):
    return frontier_mesh(devices=["cpu"] * n)


def jax_mesh(n=8):
    devices = jax.devices()
    assert len(devices) >= n, "conftest must provide the virtual 8-device mesh"
    return Mesh(np.asarray(devices[:n]), ("fr",))


def assert_runout_equal(sharded, plain):
    whole = pdev.gather_frontier(sharded.frontier)
    for field, a, b in zip(pdev.Frontier._fields, whole, plain.frontier):
        assert torch.equal(a, b), field
    for field in pdev.RunOut._fields:
        a, b = getattr(sharded, field), getattr(plain, field)
        if field == "frontier":
            continue
        if field == "deep_counts":
            assert torch.equal(a.cpu(), b.cpu()), field
        elif field == "wlog":
            assert (a is None) == (b is None), field
            for x, y in zip(a or [], b or []):
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        else:
            assert a == b, field


#: (case, bucket, exact_pack, sort_dedup, allow_prune, log, spec_depth, layer budgets of the calls)
RUN_CASES = [
    ("adv-k5", 64, True, False, False, False, 0, (1, 2, 3, 6)),
    ("adv-k5", 16, True, True, True, False, 0, (1, 1, 2, 4, 8)),
    ("adv-k6-unsat", 64, False, False, True, False, 0, (1, 2, 4, 7, 9)),
    ("adv-k6-unsat", 64, True, True, False, False, 0, (2, 3, 9)),
    ("collected-match-seq-num", 16, True, False, False, True, 0, (1, 2, 3, 5, 8, 40)),
    ("collected-fencing", 16, False, False, True, False, 0, (1, 2, 3, 5, 8, 40)),
    ("adv-k5", 32, True, False, True, False, 2, (3, 3, 3)),
    ("adv-k4", 16, False, False, True, True, 0, (1, 1, 1, 1, 4)),
]

CASES = dict(TABLE_CASES, **{"adv-k4": jax_adversarial(4, batch=3, seed=5)})


@pytest.mark.parametrize(
    "name,f,xp,sd,prune,log,spec,budgets",
    RUN_CASES,
    ids=[f"{c[0]}-f{c[1]}-xp{int(c[2])}-sort{int(c[3])}-beam{int(c[4])}-log{int(c[5])}-spec{c[6]}"
         for c in RUN_CASES],
)
def test_sharded_run_search_equals_unsharded(name, f, xp, sd, prune, log, spec, budgets):
    enc = encode_history(prepare(to_port(CASES[name])))
    tables = pdev.build_tables(enc, "cpu", prune=bool(spec))
    kw = dict(allow_prune=prune, exact_pack=xp, sort_dedup=sd, log=log, spec_depth=spec, spec_width=8 if spec else 0)
    plain = [pdev.init_frontier(enc, f, "cpu")]
    outs = []
    for budget in budgets:
        out = pdev.run_search(tables, plain[-1], budget, **kw)
        outs.append(out)
        if out.stop_code != pdev.STOP_RUNNING:
            break
        plain.append(out.frontier)
    assert any(o.expanded for o in outs)
    for n in SHARDS:
        mesh = cpu_mesh(n)
        fr = pdev.place_frontier(plain[0], mesh)
        for budget, want in zip(budgets, outs):
            got = pdev.run_search(tables, fr, budget, **kw)
            assert_runout_equal(got, want)
            assert [b.capacity for b in got.frontier.blocks] == [f // n] * n
            fr = got.frontier


def _jax_collected():
    return collect_history(
        CollectConfig(
            num_concurrent_clients=4,
            num_ops_per_client=20,
            workflow="match-seq-num",
            seed=11,
            indefinite_failure_backoff_s=0.0,
            faults=FaultPlan.chaos(intensity=0.3, max_latency=0.001),
        )
    )


def assert_mesh_results_equal(rj, rp, hp):
    assert rp.outcome.value == rj.outcome.value
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(rj.stats, f), f
    assert [tuple(s) for s in rp.final_states] == [tuple(s) for s in rj.final_states]
    assert len(rp.stats.shards) == len(rj.stats.shards) == 8
    for ep, ej in zip(rp.stats.shards, rj.stats.shards):
        assert ep["device"] == "cpu"
        for f in SHARD_FIELDS:
            assert ep[f] == ej[f], f
    seg = [(e["layer"], e.get("shards")) for e in rp.stats.timeline]
    assert seg == [(e["layer"], e.get("shards")) for e in rj.stats.timeline]
    if rp.outcome == CheckOutcome.OK:
        assert_replays(hp, rp.linearization)


def test_device_sharded_over_mesh_matches_jax():
    events = _jax_collected()
    hj, hp = jax_prepare(events), prepare(to_port(events))
    kw = dict(start_frontier=64, beam=False, collect_stats=True, profile=True)
    rj = jdev.check_device(hj, mesh=jax_mesh(), **kw)
    rp = pdev.check_device(hp, mesh=cpu_mesh(8), **kw)
    assert rp.outcome == CheckOutcome.OK
    assert_mesh_results_equal(rj, rp, hp)
    assert all("sync_s" in e for e in rp.stats.timeline)
    plain = pdev.check_device(hp, device="cpu", **kw)
    assert rp.linearization == plain.linearization and not plain.stats.shards
    # The HTML's mesh-shard panel is the JAX package's, and only a sharded
    # run has one.
    assert pviz._shard_panel(rp) == jviz._shard_panel(rp) and "mesh shards" in pviz.render_html(hp, rp)
    assert pviz._shard_panel(plain) == ""


def test_spill_sharded_over_mesh_matches_jax():
    hj, hp = both(jax_adversarial(6, batch=4, seed=1))
    kw = dict(max_frontier=32, start_frontier=32, beam=False, spill=True, collect_stats=True, profile=True)
    rj = jdev.check_device(hj, mesh=jax_mesh(), **kw)
    rp = pdev.check_device(hp, mesh=cpu_mesh(8), **kw)
    assert rp.outcome == CheckOutcome.OK
    assert rp.stats.max_frontier > 32
    assert any(e.get("spill") for e in rp.stats.timeline)
    assert_mesh_results_equal(rj, rp, hp)


def test_checkpoint_resumes_onto_a_wider_mesh(tmp_path):
    hp = prepare(to_port(CASES["collected-match-seq-num"]))
    kw = dict(beam=False, max_frontier=256, start_frontier=4, checkpoint_every=1, collect_stats=True)
    ck = str(tmp_path / "search.ck")
    with preempting(pdev, 3), pytest.raises(KeyboardInterrupt):
        pdev.check_device(hp, checkpoint_path=ck, mesh=cpu_mesh(2), **kw)
    snap = pdev.load_checkpoint(ck)
    assert snap.f < 8 and len(snap.stats["shards"]) == 2
    res = pdev.check_device(hp, checkpoint_path=ck, mesh=cpu_mesh(8), **kw)
    want = pdev.check_device(hp, device="cpu", **kw)
    assert res.outcome == want.outcome == CheckOutcome.OK
    for f in ("layers", "max_frontier", "expanded", "auto_closed", "pruned"):
        assert getattr(res.stats, f) == getattr(want.stats, f), f
    assert [e["device"] for e in res.stats.shards] == ["cpu"] * 8
    assert res.stats.shards[0]["peak_occupancy"] >= 1
    assert_replays(hp, res.linearization)


def test_check_device_auto_mesh_both_phases_equals_unsharded():
    # The beam phase prunes and concedes; the exhaustive phase decides.
    # (test_torch_device holds the unsharded port's check_device_auto
    # against the JAX engine's.)
    hp = prepare(adversarial_events(5, batch=3, seed=2, unsatisfiable=True))
    kw = dict(beam_width=16, exhaustive_cap=4096, collect_stats=True, spill=False)
    phases = []
    real = pdev.check_device

    def spy(hist, **k):
        res = real(hist, **k)
        phases.append((k["beam"], res.outcome))
        return res

    pdev.check_device = spy
    try:
        rp = pdev.check_device_auto(hp, mesh=cpu_mesh(4), **kw)
    finally:
        pdev.check_device = real
    plain = pdev.check_device_auto(hp, device="cpu", **kw)
    assert phases == [(True, CheckOutcome.UNKNOWN), (False, CheckOutcome.ILLEGAL)]
    assert rp.outcome == plain.outcome == CheckOutcome.ILLEGAL
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(plain.stats, f), f
    assert rp.refusals == plain.refusals and rp.deepest == plain.deepest
    assert len(rp.stats.shards) == 4 and sum(e["peak_occupancy"] for e in rp.stats.shards) > 0


@settings(max_examples=12, deadline=None)
@given(
    k=st.integers(3, 5),
    batch=st.integers(2, 4),
    seed=st.integers(0, 1000),
    unsat=st.booleans(),
    shards=st.sampled_from(SHARDS),
    beam=st.booleans(),
)
def test_random_histories_shard_like_unsharded(k, batch, seed, unsat, shards, beam):
    hp = prepare(adversarial_events(k, batch=batch, seed=seed, unsatisfiable=unsat))
    kw = dict(beam=beam, max_frontier=32, start_frontier=8, collect_stats=True)
    want = pdev.check_device(hp, device="cpu", **kw)
    got = pdev.check_device(hp, mesh=cpu_mesh(shards), **kw)
    assert got.outcome == want.outcome
    assert got.linearization == want.linearization and got.final_states == want.final_states
    assert (got.deepest, got.refusals) == (want.deepest, want.refusals)
    for f in STAT_FIELDS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f


def test_mesh_contracts(monkeypatch):
    enc = encode_history(prepare(adversarial_events(3, batch=2, seed=0)))
    with pytest.raises(ValueError, match="evenly"):
        pdev.place_frontier(pdev.init_frontier(enc, 16, "cpu"), cpu_mesh(3))
    with pytest.raises(ValueError, match="at least one"):
        frontier_mesh(devices=[])
    mesh = cpu_mesh(4)
    assert (mesh.size, mesh.local, mesh.first, mesh.axis) == (4, 4, 0, "fr")
    # The default mesh is the visible cards, never the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pdev.DeviceUnavailable):
        frontier_mesh()
    with pytest.raises(pdev.DeviceUnavailable):
        pdev.check_device(prepare(adversarial_events(3, batch=2, seed=0)), mesh=frontier_mesh(devices=["cuda"] * 2))


def test_multiprocess_supported_classifies_failures(monkeypatch):
    assert multiprocess_supported() == (True, "")
    dist = pdist.dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)

    def refuse(*a, **kw):
        raise RuntimeError("backend cpu:\nbroadcast is not implemented for this backend")

    monkeypatch.setattr(dist, "broadcast", refuse)
    assert multiprocess_supported() == (False, "broadcast is not implemented for this backend")

    def broken(*a, **kw):
        raise RuntimeError("connection reset by peer")

    monkeypatch.setattr(dist, "broadcast", broken)
    with pytest.raises(RuntimeError, match="reset"):
        multiprocess_supported()
    monkeypatch.setattr(dist, "broadcast", lambda *a, **kw: None)
    assert multiprocess_supported() == (True, "")
