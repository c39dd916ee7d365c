"""Port parity: the frontier search against the JAX device engine.

Both engines get the same histories (JAX events carried to the port through
the JSONL codec).  Held integer-exact (tolerance 0):

- the search tables (JAX ``build_tables`` → ``tables_from_arrays`` equals
  the port's own ``build_tables``, Zobrist draw included);
- the frontier arrays after 1..n layers of ``run_search``, with the exact
  packed key on and off and with beam pruning on and off;
- ``check_device`` / ``check_device_auto``: verdict, layers, expanded,
  peak frontier, auto-closed ops, final states, witness, refusal reports.

The JAX side runs on the CPU with its default scan fold; the port runs
with ``device="cpu"`` (the plain PyTorch fold).
"""

import importlib
import random

import numpy as np
import pytest
import torch

from s2_verification_tpu.checker.entries import prepare as jax_prepare
from s2_verification_tpu.collector.adversarial import adversarial_events as jax_adversarial
from s2_verification_tpu.models.encode import encode_history as jax_encode
from s2_verification_tpu.utils.events import LabeledEvent, ReadSuccess
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, check
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.models.encode import encode_history
from s2_verification_tpu_torch.models.stream import INIT_STATE, step_set
from s2_verification_tpu_torch.ops.step_kernel import join_u64
from s2_verification_tpu_torch.utils import hashing

from test_oracle_bruteforce import random_history
from test_torch_encode import collected, to_port

jdev = importlib.import_module("s2_verification_tpu.checker.device")


def both(events):
    """(JAX History, port History) of one event list."""
    return jax_prepare(events), prepare(to_port(events))


def jax_tables_dict(t) -> dict:
    d = {}
    for name in t._fields:
        v = getattr(t, name)
        if name == "ops":
            d.update({f"ops.{f}": np.asarray(getattr(v, f)) for f in v._fields})
        else:
            d[name] = np.asarray(v)
    return d


def assert_frontier_equal(jf, pf):
    np.testing.assert_array_equal(np.asarray(jf.counts).astype(np.int64), pf.counts.numpy())
    np.testing.assert_array_equal(np.asarray(jf.tail).astype(np.int64), pf.tail.numpy())
    np.testing.assert_array_equal(join_u64(np.asarray(jf.hi), np.asarray(jf.lo)), pf.hash.numpy())
    np.testing.assert_array_equal(np.asarray(jf.tok).astype(np.int64), pf.tok.numpy())
    np.testing.assert_array_equal(np.asarray(jf.valid), pf.valid.numpy())


def assert_replays(hist, order):
    """The witness covers every op once, extends real-time order, and
    drives a non-empty state set through the port's step_set."""
    ops = hist.ops
    assert sorted(order) == list(range(len(ops)))
    pos = {j: i for i, j in enumerate(order)}
    for a in ops:
        for b in ops:
            if a.ret < b.call:
                assert pos[a.index] < pos[b.index]
    states = [INIT_STATE]
    for j in order:
        states = step_set(states, ops[j].inp, ops[j].out)
        assert states


def assert_results_equal(rj, rp, hp):
    assert rp.outcome.value == rj.outcome.value
    assert rp.linearization == rj.linearization
    assert [tuple(s) for s in rp.final_states] == [tuple(s) for s in rj.final_states]
    assert rp.deepest == rj.deepest
    assert rp.refusals == rj.refusals
    sj, sp = rj.stats, rp.stats
    for f in ("layers", "expanded", "max_frontier", "auto_closed", "pruned"):
        assert getattr(sp, f) == getattr(sj, f), f
    if rp.linearization is not None:
        assert_replays(hp, rp.linearization)


def _table_cases():
    return {
        "adv-k5": jax_adversarial(5, batch=3, seed=2),
        "adv-k6-unsat": jax_adversarial(6, batch=3, seed=2, unsatisfiable=True),
        "collected-match-seq-num": collected("match-seq-num"),
        "collected-fencing": collected("fencing"),
    }


TABLE_CASES = _table_cases()


@pytest.mark.parametrize("name", sorted(TABLE_CASES))
def test_tables_from_jax_equal_port_tables(name):
    hj, hp = both(TABLE_CASES[name])
    tj = jdev.build_tables(jax_encode(hj))
    mine = pdev.build_tables(encode_history(hp), "cpu")
    carried = pdev.tables_from_arrays(jax_tables_dict(tj), "cpu")
    for field, a, b in zip(mine._fields, mine, carried):
        if field == "ops":
            for f, x, y in zip(a._fields, a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), f
        elif field in ("can_close", "tok_close"):
            assert a == b
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), field


# (case, start frontier, exact_pack, allow_prune, layer counts to compare)
RUN_CASES = [
    ("adv-k5", 64, True, False, (1, 2, 3, 6)),
    ("adv-k6-unsat", 64, False, True, (1, 2, 4, 7, 9)),
    ("collected-match-seq-num", 16, True, False, (1, 2, 3, 5, 8, 40)),
    ("collected-fencing", 16, False, True, (1, 2, 3, 5, 8, 40)),
]


@pytest.mark.parametrize(
    "name,f,xp,prune,ns", RUN_CASES, ids=[f"{c[0]}-xp{int(c[2])}-beam{int(c[3])}" for c in RUN_CASES]
)
def test_run_search_frontiers_match_per_layer(name, f, xp, prune, ns):
    hj, hp = both(TABLE_CASES[name])
    ej, ep = jax_encode(hj), encode_history(hp)
    if xp:
        assert pdev.can_exact_pack(ep)
    tj = jdev.build_tables(ej)
    tp = pdev.tables_from_arrays(jax_tables_dict(tj), "cpu")
    fj, fp = jdev.init_frontier(ej, f), pdev.init_frontier(ep, f, "cpu")
    assert_frontier_equal(fj, fp)
    for n in ns:
        oj = jdev.run_search(tj, fj, np.int32(n), allow_prune=prune, exact_pack=xp)
        op = pdev.run_search(tp, fp, n, allow_prune=prune, exact_pack=xp)
        assert_frontier_equal(oj.frontier, op.frontier)
        got = (op.stop_code, op.layers, op.max_live, op.expanded, op.auto_closed,
               op.want, op.accept_idx, op.pruned_ever)
        want = tuple(
            int(x) for x in (oj.stop_code, oj.layers, oj.max_live, oj.expanded,
                             oj.auto_closed, oj.want, oj.accept_idx, oj.pruned_ever)
        )
        assert got == want, n
        np.testing.assert_array_equal(np.asarray(oj.deep_counts), op.deep_counts.numpy())


@pytest.mark.parametrize("k", [4, 6])
@pytest.mark.parametrize("unsat", [False, True])
def test_check_device_adversarial_matches_jax(k, unsat):
    hj, hp = both(jax_adversarial(k, batch=3, seed=1, unsatisfiable=unsat))
    kw = dict(max_frontier=4096, beam=False, collect_stats=True)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == (CheckOutcome.ILLEGAL if unsat else CheckOutcome.OK)
    assert_results_equal(rj, rp, hp)
    assert rp.outcome == check(hp).outcome


@pytest.mark.parametrize("unsat", [False, True])
def test_check_device_auto_matches_jax(unsat):
    # A beam narrower than the peak frontier: the beam phase prunes and,
    # when it cannot accept, the exhaustive phase decides.
    hj, hp = both(jax_adversarial(6, batch=2, seed=3, unsatisfiable=unsat))
    kw = dict(beam_width=64, exhaustive_cap=4096, collect_stats=True)
    rj = jdev.check_device_auto(hj, spill=False, device_rows_cap=0, **kw)
    rp = pdev.check_device_auto(hp, device="cpu", **kw)
    assert_results_equal(rj, rp, hp)
    assert rp.outcome == check(hp).outcome


def test_small_beam_prunes_like_jax():
    hj, hp = both(jax_adversarial(6, batch=2, seed=3))
    kw = dict(max_frontier=32, beam=True, collect_stats=True)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.stats.pruned
    assert_results_equal(rj, rp, hp)


def test_random_histories_match_jax():
    rng = random.Random(0xDEC0)
    outcomes = set()
    for trial in range(20):
        events = random_history(rng).events
        hj, hp = both(events)
        kw = dict(max_frontier=256, beam=False, collect_stats=True)
        rj = jdev.check_device(hj, **kw)
        rp = pdev.check_device(hp, device="cpu", **kw)
        assert rp.outcome == check(hp).outcome, trial
        assert_results_equal(rj, rp, hp)
        outcomes.add(rp.outcome)
    assert outcomes == {CheckOutcome.OK, CheckOutcome.ILLEGAL}


def test_corrupted_history_refusals_match_jax():
    # The history of the JAX package's test_device.py:76, one read's hash
    # flipped.
    events = collected("regular", seed=3, ops=15)
    tampered, done = [], False
    for e in events:
        if not done and isinstance(e.event, ReadSuccess) and e.event.tail > 0:
            e = LabeledEvent(
                ReadSuccess(tail=e.event.tail, stream_hash=e.event.stream_hash ^ 1),
                e.client_id,
                e.op_id,
            )
            done = True
        tampered.append(e)
    assert done
    hj, hp = both(tampered)
    rj = jdev.check_device(hj, beam=False, collect_stats=True)
    rp = pdev.check_device(hp, beam=False, collect_stats=True, device="cpu")
    assert rp.outcome == CheckOutcome.ILLEGAL
    assert rp.refusals
    assert_results_equal(rj, rp, hp)


@pytest.mark.parametrize("name", ["collected-match-seq-num", "collected-fencing"])
def test_collected_histories_match_jax(name):
    hj, hp = both(TABLE_CASES[name])
    rj = jdev.check_device_auto(hj, beam_width=512, collect_stats=True)
    rp = pdev.check_device_auto(hp, beam_width=512, collect_stats=True, device="cpu")
    assert rp.outcome == CheckOutcome.OK
    assert_results_equal(rj, rp, hp)


def test_exhaustive_overflow_unknown_or_spill_matches_jax():
    # An in-core search (no device_rows_cap) past its bucket.  Without the
    # spill both engines concede the same UNKNOWN; with spill=True both hand
    # the frontier to the host-RAM spill and decide OK with the same
    # statistics.  test_torch_chunked holds the same past a device_rows_cap
    # above the bucket.
    hj, hp = both(jax_adversarial(6, batch=2, seed=3))
    for spill, want in ((False, "unknown"), (True, "ok")):
        kw = dict(max_frontier=64, beam=False, collect_stats=True, spill=spill)
        rj = jdev.check_device(hj, **kw)
        assert rj.outcome.value == want
        assert_results_equal(rj, pdev.check_device(hp, device="cpu", **kw), hp)


@pytest.mark.parametrize("k", [6, 8, 10])
def test_witness_recovery_is_the_same_with_the_native_and_the_python_fold(k, monkeypatch):
    # The host re-search below the beam's accept counts (what every OK of the
    # search recovers its witness with) folds each append's record hashes;
    # natively or in Python, it walks the same DFS to the same order.
    seen = []
    real = pdev._recover_witness_bounded

    def spy(enc, history, counts, **kw):
        seen.append((enc, history, counts))
        return real(enc, history, counts, **kw)

    monkeypatch.setattr(pdev, "_recover_witness_bounded", spy)
    res = pdev.check_device_auto(prepare(adversarial_events(k, batch=100, seed=k)), device="cpu")
    assert res.outcome == CheckOutcome.OK and len(seen) == 1
    lins, folds = {}, {}
    for mode in ("native", "python"):
        monkeypatch.setattr(hashing, "_native_fold", None if mode == "native" else False)
        before = (hashing.NATIVE_FOLDS[0], hashing.PYTHON_FOLDS[0])
        lins[mode] = real(*seen[0])
        folds[mode] = (hashing.NATIVE_FOLDS[0] - before[0], hashing.PYTHON_FOLDS[0] - before[1])
    assert res.linearization is not None and lins["native"] == lins["python"] == res.linearization
    n = folds["native"][0]
    assert n > 0 and folds == {"native": (n, 0), "python": (0, n)}
