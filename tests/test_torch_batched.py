"""Port parity: batched lanes (``checker/batched.py``, ``encode_batch`` /
``pad_encoded`` and the lane-batched layer loop ``run_search_lanes``).

The same histories (collected by the JAX package's fake S2 with chaos
faults, 3 clients × 6 ops over the three workflows, and a few wider ones)
go through both packages.  Held integer-exact (tolerance 0):

- the ports of the JAX package's ``tests/test_batched.py`` lane tests:
  batch-native and batch-vmap against the oracle, single-lane launches
  and the JAX engines; mixed verdicts in one launch; the trivial-lane
  short circuit; the init-overflow skip; ``pad_encoded``; and each
  batch-native lane's rich result equal to ``check_native`` alone;
- ``encode_batch`` arrays equal to the JAX package's, dtype for dtype;
- ``run_search_lanes`` against the JAX engine's ``_mega_launch``
  (``jit(vmap(run_search))``) on the same stacked lanes: every per-lane
  field and the final frontier arrays, with lanes that prune, latch early,
  die and take the forced-step fast path; and against the port's own
  ``run_search`` on each lane alone, also over random groupings
  (hypothesis);
- host syncs: 8 copies of one lane cost the syncs of that lane alone.

The JAX side runs on the CPU; the port with ``device="cpu"``.
"""

import importlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

from s2_verification_tpu.checker.entries import prepare as jax_prepare
from s2_verification_tpu.collector.adversarial import adversarial_events as jax_adversarial
from s2_verification_tpu.collector.collect import CollectConfig, collect_history
from s2_verification_tpu.collector.fake_s2 import FaultPlan
from s2_verification_tpu.models.encode import encode_batch as jax_encode_batch
from s2_verification_tpu.utils.events import CheckTailSuccess
from s2_verification_tpu_torch.checker import batched as pb
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker import oracle
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.frontier import check_frontier
from s2_verification_tpu_torch.checker.native import check_native
from s2_verification_tpu_torch.checker.oracle import CheckOutcome
from s2_verification_tpu_torch.models.encode import encode_batch, encode_history, pad_encoded

from helpers import H, fold
from test_torch_device import assert_frontier_equal, jax_tables_dict
from test_torch_encode import to_port

jb = importlib.import_module("s2_verification_tpu.checker.batched")
jdev = importlib.import_module("s2_verification_tpu.checker.device")


# -- fixtures ----------------------------------------------------------------


def _collect(workflow: str, seed: int, clients=3, ops=6, faults=None):
    return collect_history(
        CollectConfig(
            num_concurrent_clients=clients,
            num_ops_per_client=ops,
            seed=seed,
            workflow=workflow,
            indefinite_failure_backoff_s=0.0,
            faults=faults or FaultPlan.chaos(intensity=0.25, max_latency=0.001),
        )
    )


def _pair(events):
    """(JAX History, port History) of one JAX event list."""
    return jax_prepare(events, elide_trivial=True), prepare(to_port(events), elide_trivial=True)


@pytest.fixture(scope="module")
def collected():
    """Collected histories across every workflow (chaos faults for
    indefinite appends), as (JAX, port) History pairs."""
    return [_pair(_collect(w, s)) for w in ("regular", "match-seq-num", "fencing") for s in (0, 1)]


@pytest.fixture(scope="module")
def wide():
    """The collected lanes plus lanes the 3×6 ones do not reach: an
    unsatisfiable adversarial history (its lane dies) and a fencing 8×30
    history with the benchmark's sparse faults (forced-step stretches)."""
    sparse = FaultPlan(p_append_definite=0.05, p_append_indefinite=12.0 / 240, p_read_fail=0.02,
                       p_check_tail_fail=0.02)
    extra = [jax_adversarial(5, batch=4, seed=1, unsatisfiable=True), _collect("fencing", 3, 8, 30, sparse)]
    return [_pair(_collect(w, s)) for w in ("regular", "match-seq-num", "fencing") for s in (0, 1)] + [
        _pair(e) for e in extra
    ]


def _ok_history(i: int) -> H:
    h = H()
    h.append_ok(1, [100 + i], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([100 + i]))
    h.append_ok(2, [200 + i, 300 + i], tail=3)
    h.read_ok(1, tail=3, stream_hash=fold([100 + i, 200 + i, 300 + i]))
    return h


def _bad_history(i: int) -> H:
    h = H()
    h.append_ok(1, [100 + i], tail=1)
    h.read_ok(2, tail=1, stream_hash=12345)
    h.append_ok(2, [200 + i, 300 + i], tail=3)
    h.read_ok(1, tail=3, stream_hash=fold([100 + i, 200 + i, 300 + i]))
    return h


def _lanes(hists):
    return [pb.BatchLane(h, enc) for h, enc in zip(hists, encode_batch(list(hists)))]


def _jax_lanes(hists):
    return [jb.BatchLane(h, enc) for h, enc in zip(hists, jax_encode_batch(list(hists)))]


def _vmap(lanes, **kw):
    return pb.check_batch_vmap(lanes, device="cpu", **kw)


def _outcome(v):
    return None if v.result is None else v.result.outcome.value


# -- verdict parity: the batched engines against the oracle and JAX ----------


def test_batch_native_matches_oracle_on_collected(collected):
    hists = [p for _, p in collected]
    verdicts = pb.check_batch_native(_lanes(hists))
    jax_verdicts = jb.check_batch_native(_jax_lanes([j for j, _ in collected]))
    for (_, hist), v, jv in zip(collected, verdicts, jax_verdicts):
        assert v.skipped is None and v.result is not None
        assert v.engine == "batch-native"
        assert v.result.outcome == oracle.check(hist).outcome
        assert v.result.outcome.value == jv.result.outcome.value
        assert v.result.linearization == jv.result.linearization
        assert v.result.deepest == jv.result.deepest
        assert (v.result.steps, v.result.cache_hits) == (jv.result.steps, jv.result.cache_hits)


def test_batch_vmap_matches_oracle_and_single_lane(collected):
    hists = [p for _, p in collected]
    batched = _vmap(_lanes(hists))
    jax_batched = jb.check_batch_vmap(_jax_lanes([j for j, _ in collected]))
    for (_, hist), v, jv in zip(collected, batched, jax_batched):
        single = _vmap([pb.BatchLane(hist, encode_history(hist))])[0]
        orc = oracle.check(hist).outcome
        assert check_frontier(hist, witness=False).outcome == orc
        # A decided lane agrees with the oracle and with its own single-lane
        # launch; an undecided lane may only be undecided, never wrong.
        if v.result is not None:
            assert v.result.outcome == orc
        if single.result is not None:
            assert single.result.outcome == orc
        assert (v.result is None) == (single.result is None)
        assert v.engine == "batch-vmap"
        assert (_outcome(v), v.layers) == (_outcome(jv), jv.layers)


def test_batch_vmap_mixed_verdicts_same_launch():
    events = [(_bad_history(i) if i % 3 == 2 else _ok_history(i)).events for i in range(6)]
    hists = [prepare(to_port(e), elide_trivial=True) for e in events]
    verdicts = _vmap(_lanes(hists))
    jax_verdicts = jb.check_batch_vmap(_jax_lanes([jax_prepare(e, elide_trivial=True) for e in events]))
    for i, (v, jv) in enumerate(zip(verdicts, jax_verdicts)):
        assert v.result is not None, f"lane {i} undecided"
        want = CheckOutcome.ILLEGAL if i % 3 == 2 else CheckOutcome.OK
        assert v.result.outcome == want
        assert (_outcome(v), v.layers) == (_outcome(jv), jv.layers)
    assert all(v.layers >= 0 for v in verdicts)


def test_batch_vmap_trivial_lane_short_circuits():
    # Every op elided (definite failure): total_remaining == 0, the lane
    # never launches and is trivially OK at layer 0.
    h = H()
    h.append_definite_fail(1, [111])
    hist = prepare(to_port(h.events), elide_trivial=True)
    launched = []
    real = pb._mega_launch
    pb._mega_launch = lambda *a: launched.append(a) or real(*a)
    try:
        [v] = _vmap([pb.BatchLane(hist, encode_history(hist))])
    finally:
        pb._mega_launch = real
    assert v.result is not None and v.result.outcome == CheckOutcome.OK
    assert v.layers == 0 and not launched


@pytest.mark.parametrize("lane", range(8))
def test_batch_native_lane_equals_check_native_alone(wide, lane):
    # Padding a lane to the launch group's shape changes nothing of its
    # rich result: witness, deepest set, final states and the DFS counts.
    lanes = _lanes([p for _, p in wide])
    v = pb.check_batch_native(lanes)[lane]
    alone = check_native(wide[lane][1])
    assert v.skipped is None and v.engine == "batch-native"
    for f in ("outcome", "linearization", "deepest", "final_states", "steps", "cache_hits"):
        assert getattr(v.result, f) == getattr(alone, f), f


def test_batch_vmap_skip_and_init_overflow(collected):
    # A lane with more initial states than its capacity is skipped to the
    # sequential path, while the lanes of its launch group run: a forced
    # indefinite append leaves two.
    h = H()
    h.append_indefinite_fail(1, [5])
    a, b = h.call_check_tail(2), h.call_check_tail(3)
    h.finish(2, a, CheckTailSuccess(tail=1))
    h.finish(3, b, CheckTailSuccess(tail=1))
    hist = prepare(to_port(h.events), elide_trivial=True)
    enc = encode_history(hist)
    assert len(enc.init_states) == 2 and enc.total_remaining > 0
    hists = [p for _, p in collected[:3]] + [hist]
    verdicts = _vmap(_lanes(hists), capacity=1)
    jax_hists = [j for j, _ in collected[:3]] + [jax_prepare(h.events, elide_trivial=True)]
    jax_verdicts = jb.check_batch_vmap(_jax_lanes(jax_hists), capacity=1)
    assert [v.skipped for v in verdicts] == [None, None, None, "init-overflow"]
    assert verdicts[3].result is None
    assert [(_outcome(v), v.layers, v.skipped) for v in verdicts] == [
        (_outcome(v), v.layers, v.skipped) for v in jax_verdicts
    ]
    assert _vmap([pb.BatchLane(hist, enc)], capacity=2)[0].result.outcome == CheckOutcome.OK


# -- encode_batch / pad_encoded --------------------------------------------


def test_pad_encoded_verdicts_match_unpadded(collected):
    for _, hist in collected:
        enc = encode_history(hist)
        padded = pad_encoded(
            enc,
            enc.op_type.shape[0] * 2,
            enc.rh_hi.shape[0] + 3,
            enc.rh_hi.shape[1],
            enc.chain_ops.shape[0] + 1,
            enc.chain_ops.shape[1] + 2,
        )
        assert check_native(hist, enc=padded).outcome == check_native(hist, enc=enc).outcome
        assert pad_encoded(padded, padded.op_type.shape[0], *padded.rh_hi.shape,
                           *padded.chain_ops.shape) is padded


def test_encode_batch_arrays_equal_jax(wide):
    encs = encode_batch([p for _, p in wide])
    jencs = jax_encode_batch([j for j, _ in wide])
    dims = {(e.op_type.shape[0], e.rh_hi.shape, e.chain_ops.shape) for e in encs}
    assert len(dims) == 1  # every lane stackable
    for e, je in zip(encs, jencs):
        for name, v in vars(je).items():
            got = getattr(e, name)
            if isinstance(v, np.ndarray):
                assert got.dtype == v.dtype, name
                np.testing.assert_array_equal(got, v, err_msg=name)
            elif name == "init_states":
                assert [tuple(s) for s in got] == [tuple(s) for s in v]
            else:
                assert got == v, name


def test_check_native_enc_skips_the_encode(collected):
    _, hist = collected[0]
    enc = encode_history(hist)
    res = check_native(hist, enc=enc, profile=True)
    assert res.profile["encode_s"] == 0.0
    base = check_native(hist)
    assert (res.outcome, res.linearization, res.steps) == (base.outcome, base.linearization, base.steps)


# -- the lane-batched layer loop ---------------------------------------------

RUN_FIELDS = (
    "stop_code", "accept_idx", "layers", "pruned_ever", "max_live", "expanded", "auto_closed",
    "eager_closed", "pin_killed", "spec_layers", "spec_accepts", "spec_rollbacks", "want",
)


def _port_lanes(encs, capacity, prune):
    tables = [pdev.build_tables(e, "cpu", prune=prune) for e in encs]
    return tables, [pdev.init_frontier(e, capacity, "cpu") for e in encs]


def assert_runs_equal(a, b):
    for f in RUN_FIELDS + ("deep_ops", "live"):
        assert getattr(a, f) == getattr(b, f), f
    assert torch.equal(a.deep_counts, b.deep_counts)
    for x, y in zip(a.frontier, b.frontier):
        assert torch.equal(x, y)


@pytest.mark.parametrize("capacity,prune", [(64, False), (4, True)], ids=["cap64", "cap4-prune"])
def test_lanes_match_jax_mega_launch(wide, capacity, prune):
    jencs = jax_encode_batch([j for j, _ in wide])
    jt = [jdev.build_tables(e, prune=prune) for e in jencs]
    jf = [jdev.init_frontier(e, capacity) for e in jencs]
    max_layers = max(e.total_remaining for e in jencs) + 2
    jout = jb._mega_launch(jb._stack(jt), jb._stack(jf), max_layers)
    # The port's lanes from the JAX engine's own arrays, Zobrist draw included.
    tables = [pdev.tables_from_arrays(jax_tables_dict(t), "cpu") for t in jt]
    fronts = [pdev.frontier_from_arrays({k: np.asarray(getattr(f, k)) for k in f._fields}, "cpu") for f in jf]
    outs = pdev.run_search_lanes(tables, fronts, max_layers)
    assert len(outs) == len(wide)
    for i, out in enumerate(outs):
        for f in RUN_FIELDS:
            assert getattr(out, f) == int(np.asarray(getattr(jout, f))[i]), (i, f)
        np.testing.assert_array_equal(out.deep_counts.numpy(), np.asarray(jout.deep_counts)[i])
        assert_frontier_equal(jax_frontier_lane(jout.frontier, i), out.frontier)
    stops = [o.stop_code for o in outs]
    layers = [o.layers for o in outs]
    # The launch covers an extinction, lanes that latch while others run on,
    # and lanes that prune beside lanes that do not.
    assert pdev.STOP_EMPTY in stops and pdev.STOP_ACCEPT in stops
    assert len(set(layers)) > 1
    assert len({o.pruned_ever for o in outs}) == 2


def jax_frontier_lane(fr, i):
    return type(fr)(*(np.asarray(x)[i] for x in fr))


@pytest.mark.parametrize("capacity,prune", [(64, False), (64, True), (8, False)], ids=["cap64", "cap64-prune", "cap8"])
def test_lanes_match_run_search_alone(wide, capacity, prune):
    encs = encode_batch([p for _, p in wide])
    tables, fronts = _port_lanes(encs, capacity, prune)
    max_layers = max(e.total_remaining for e in encs) + 2
    fast = []
    real = pdev._fast_multi

    def spy(t, fr, rows, run, budget, cbase=None, extra=()):
        fast.append(bool(extra))  # an expansion's vectors ride this fetch
        return real(t, fr, rows, run, budget, cbase, extra)

    pdev._fast_multi = spy
    try:
        outs = pdev.run_search_lanes(tables, fronts, max_layers)
    finally:
        pdev._fast_multi = real
    for t, f, out in zip(tables, fronts, outs):
        assert_runs_equal(pdev.run_search(t, f, max_layers, allow_prune=True), out)
    # Some iteration stepped forced rows beside lanes that expanded (under
    # prune these lanes take no forced stretch).
    assert prune or any(fast)


def test_lanes_layer_budget_latches_like_run_search(wide):
    encs = encode_batch([p for _, p in wide])
    tables, fronts = _port_lanes(encs, 64, False)
    for max_layers in (0, 1, 5):
        outs = pdev.run_search_lanes(tables, fronts, max_layers)
        for t, f, out in zip(tables, fronts, outs):
            assert_runs_equal(pdev.run_search(t, f, max_layers, allow_prune=True), out)


def test_host_syncs_do_not_grow_with_lanes(wide):
    for _, hist in (wide[2], wide[-1], wide[-2]):
        enc = encode_history(hist)
        tables, fronts = _port_lanes([enc], 64, False)
        max_layers = enc.total_remaining + 2
        s0 = pdev.SYNCS[0]
        alone = pdev.run_search(tables[0], fronts[0], max_layers, allow_prune=True)
        s1 = pdev.SYNCS[0]
        outs = pdev.run_search_lanes(tables * 8, fronts * 8, max_layers)
        s2 = pdev.SYNCS[0]
        assert s2 - s1 == s1 - s0 > 0
        for out in outs:
            assert_runs_equal(alone, out)


def test_lanes_refuse_mixed_shapes(collected):
    encs = [encode_history(p) for _, p in collected]
    shapes = {(e.op_type.shape[0], e.chain_ops.shape) for e in encs}
    assert len(shapes) > 1
    tables, fronts = _port_lanes(encs, 64, False)
    with pytest.raises(ValueError, match="shape-identical"):
        pdev.run_search_lanes(tables, fronts, 10)


def test_check_batch_vmap_needs_cuda_unless_told(collected, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pdev.DeviceUnavailable):
        pb.check_batch_vmap(_lanes([collected[0][1]]))


@pytest.mark.cuda
def test_lanes_on_card_match_cpu(wide):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lanes' fold runs the CUDA kernel there")
    encs = encode_batch([p for _, p in wide])
    max_layers = max(e.total_remaining for e in encs) + 2
    cpu = pdev.run_search_lanes(*_port_lanes(encs, 64, True), max_layers)
    tables = [pdev.build_tables(e, "cuda", prune=True) for e in encs]
    card = pdev.run_search_lanes(tables, [pdev.init_frontier(e, 64, "cuda") for e in encs], max_layers)
    for a, b in zip(cpu, card):
        for f in RUN_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        for x, y in zip(a.frontier, b.frontier):
            assert torch.equal(x, y.cpu())


@settings(max_examples=8, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(
    picks=hs.lists(hs.integers(0, 7), min_size=1, max_size=6),
    capacity=hs.sampled_from([4, 16, 64]),
    prune=hs.booleans(),
)
def test_random_groupings_equal_single_lanes(wide, picks, capacity, prune):
    encs = encode_batch([wide[i][1] for i in picks])
    tables, fronts = _port_lanes(encs, capacity, prune)
    max_layers = max(e.total_remaining for e in encs) + 2
    outs = pdev.run_search_lanes(tables, fronts, max_layers)
    for t, f, out in zip(tables, fronts, outs):
        assert_runs_equal(pdev.run_search(t, f, max_layers, allow_prune=True), out)
