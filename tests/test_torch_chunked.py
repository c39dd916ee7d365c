"""Port parity: sort dedup and the chunked device-resident tier against the
JAX device engine.

Held integer-exact (tolerance 0), the JAX side on the CPU with its default
scan fold, the port with ``device="cpu"`` (the plain PyTorch fold):

- ``_dedup_sort`` on random identities with the top bit set in the packed
  key and the hash and negative tokens: head mask, sorted identity, sorted
  row index;
- ``run_search(sort_dedup=True)``: the frontier arrays after 1..n layers;
- ``run_search(chunk_rows=...)`` from JAX-built tables and frontiers: the
  frontier arrays and every ``RunOut`` scalar after a chunked segment in
  which the cross-chunk compaction fires, one that overflows, and one that
  ends ILLEGAL;
- ``check_device`` through the tier (``max_frontier`` below the peak,
  ``device_rows_cap`` above it), plain and pruned with a dive: outcome,
  search statistics, final states, witness and the profile timeline
  (buckets, 8-layer segments, the post-peak downsize);
- the gates of the tier and of the options that need the packed key, the
  stop past the device-resident cap (UNKNOWN, or the spill's OK), and
  ``check_device_auto``'s ``device_rows_cap`` default.
"""

import numpy as np
import pytest
import torch

from s2_verification_tpu.checker.oracle import CheckOutcome as JaxOutcome
from s2_verification_tpu.models.encode import encode_history as jax_encode
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.oracle import CheckOutcome
from s2_verification_tpu_torch.ops.step_kernel import join_u64

from test_torch_device import (
    assert_frontier_equal,
    assert_replays,
    assert_results_equal,
    both,
    jax_adversarial,
    jax_tables_dict,
    jdev,
)
from test_torch_encode import collected

STAT_FIELDS = (
    "layers", "max_frontier", "expanded", "auto_closed", "pruned", "prune_commits",
    "prune_dead", "spec_launches", "spec_layers", "spec_accepts", "spec_rollbacks",
)


def _words(rng, n):
    """``n`` distinct-ish u32 words, every other one with the top bit set."""
    w = rng.integers(0, 1 << 31, size=n, dtype=np.uint64).astype(np.uint32)
    w[::2] |= np.uint32(1 << 31)
    return w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_sort_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    # Few distinct values per word, so equal identities and equal prefixes
    # are common; every word draws from values with the top bit set.
    def pick(vals):
        return vals[rng.integers(0, len(vals), size=n)]

    pkh, pkl, hh, hl = (pick(_words(rng, 3)) for _ in range(4))
    t = pick(_words(rng, 3))
    k = pick(np.array([-7, -1, 0, 5], np.int32))
    invalid = rng.random(n) < 0.2
    vals = rng.integers(-(1 << 40), 1 << 40, size=n)

    jhead, jsid, jsidx, _ = jdev._dedup_sort(invalid, (pkh, pkl, t, hh, hl, k))
    ident = (join_u64(pkh, pkl), t.astype(np.int64), join_u64(hh, hl), k.astype(np.int64))
    phead, psid, psidx, psv = pdev._dedup_sort(
        torch.as_tensor(invalid), tuple(torch.as_tensor(x) for x in ident), (torch.as_tensor(vals),)
    )
    jsid = [np.asarray(x) for x in jsid]
    for w in (ident[0], ident[2]):  # both halves of the unsigned order
        assert (w < 0).any() and (w >= 0).any()
    np.testing.assert_array_equal(np.asarray(jhead), phead.numpy())
    np.testing.assert_array_equal(np.asarray(jsidx).astype(np.int64), psidx.numpy())
    np.testing.assert_array_equal(join_u64(jsid[0], jsid[1]), psid[0].numpy())
    np.testing.assert_array_equal(jsid[2].astype(np.int64), psid[1].numpy())
    np.testing.assert_array_equal(join_u64(jsid[3], jsid[4]), psid[2].numpy())
    np.testing.assert_array_equal(jsid[5].astype(np.int64), psid[3].numpy())
    np.testing.assert_array_equal(vals[psidx.numpy()], psv[0].numpy())
    assert 0 < int(phead.sum()) < n - int(invalid.sum())


def _cases():
    return {
        "adv-k5": jax_adversarial(5, batch=3, seed=2),
        "adv-k6": jax_adversarial(6, batch=3, seed=2),
        "adv-k6-unsat": jax_adversarial(6, batch=3, seed=2, unsatisfiable=True),
        "collected-match-seq-num": collected("match-seq-num"),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def prepared():
    """(JAX tables, port tables carried from them, JAX encoded) per case."""
    out = {}
    for name, events in CASES.items():
        hj, _ = both(events)
        ej = jax_encode(hj)
        tj = jdev.build_tables(ej)
        out[name] = (tj, pdev.tables_from_arrays(jax_tables_dict(tj), "cpu"), ej)
    return out


def _frontiers(ej, f):
    fj = jdev.init_frontier(ej, f)
    return fj, pdev.frontier_from_arrays({k: np.asarray(v) for k, v in fj._asdict().items()}, "cpu")


RUN_FIELDS = (
    "stop_code", "layers", "max_live", "expanded", "auto_closed", "want", "accept_idx",
    "pruned_ever", "eager_closed", "pin_killed", "spec_layers", "spec_accepts", "spec_rollbacks",
)


def assert_runout_equal(oj, op):
    assert_frontier_equal(oj.frontier, op.frontier)
    got = {f: int(getattr(op, f)) for f in RUN_FIELDS}
    assert got == {f: int(getattr(oj, f)) for f in RUN_FIELDS}
    np.testing.assert_array_equal(np.asarray(oj.deep_counts), op.deep_counts.numpy())
    assert op.deep_ops == int(op.deep_counts.sum())
    assert op.live == int(op.frontier.valid.sum())


# (case, frontier rows, allow_prune, layer counts to compare)
SORT_CASES = [
    ("adv-k5", 64, False, (1, 2, 3, 6)),
    ("adv-k6-unsat", 64, True, (1, 2, 4, 7, 9)),
    ("collected-match-seq-num", 16, False, (1, 2, 3, 5, 8, 40)),
]


@pytest.mark.parametrize(
    "name,f,prune,ns", SORT_CASES, ids=[f"{c[0]}-beam{int(c[2])}" for c in SORT_CASES]
)
def test_run_search_sort_dedup_frontiers_match_per_layer(prepared, name, f, prune, ns):
    tj, tp, ej = prepared[name]
    fj, fp = _frontiers(ej, f)
    for n in ns:
        kw = dict(allow_prune=prune, exact_pack=True, sort_dedup=True)
        assert_runout_equal(jdev.run_search(tj, fj, np.int32(n), **kw), pdev.run_search(tp, fp, n, **kw))


class _Counter:
    """Counts the calls of a port function, which it still calls."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        real = getattr(pdev, name)

        def counted(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(pdev, name, counted)


# (case, frontier rows, chunk rows, layer counts, stop, cross-chunk compactions)
CHUNK_CASES = [
    # The sum of the chunks' uniques outgrows the buffer, the union fits.
    ("adv-k6-unsat", 3072, 512, (2, 5, 7), pdev.STOP_EMPTY, 1),
    # Still too many after the compaction: capacity, ``want`` = rows appended.
    ("adv-k6-unsat", 2048, 512, (20,), pdev.STOP_CAPACITY, 1),
    ("adv-k6", 2048, 256, (20,), pdev.STOP_ACCEPT, 0),
]


@pytest.mark.parametrize(
    "name,f,rows,ns,stop,compactions", CHUNK_CASES,
    ids=[f"{c[0]}-f{c[1]}-chunk{c[2]}" for c in CHUNK_CASES],
)
def test_run_search_chunked_matches_jax(prepared, monkeypatch, name, f, rows, ns, stop, compactions):
    tj, tp, ej = prepared[name]
    fj, fp = _frontiers(ej, f)
    compactions_in_all = _Counter(monkeypatch, "_compact_children")
    layers = _Counter(monkeypatch, "_expand_layer_chunked")  # each ends with one
    for n in ns:
        oj = jdev.run_search(tj, fj, np.int32(n), allow_prune=False, exact_pack=True, chunk_rows=rows)
        op = pdev.run_search(tp, fp, n, allow_prune=False, exact_pack=True, chunk_rows=rows)
        assert_runout_equal(oj, op)
    assert op.stop_code == stop
    assert compactions_in_all.calls - layers.calls == compactions
    if stop == pdev.STOP_CAPACITY:
        # The aborted layer's pre-expansion frontier, intact.
        assert op.want > f and 0 < op.live <= f // 2


def _profile_rows(timeline):
    return [{k: v for k, v in e.items() if k != "elapsed_s"} for e in timeline]


def assert_checks_equal(rj, rp, hp):
    assert_results_equal(rj, rp, hp)
    for f in STAT_FIELDS:
        assert getattr(rp.stats, f) == getattr(rj.stats, f), f
    assert _profile_rows(rp.stats.timeline) == _profile_rows(rj.stats.timeline)


TIER_CASES = [(k, unsat, d) for k in (5, 6) for unsat in (False, True) for d in (0, 3)]


@pytest.mark.parametrize(
    "k,unsat,depth", TIER_CASES, ids=[f"k{k}-{'unsat' if u else 'sat'}-spec{d}" for k, u, d in TIER_CASES]
)
def test_check_device_through_tier_matches_jax(monkeypatch, k, unsat, depth):
    # The JAX package's test_device.py:766-838 shape: a 64-row expansion
    # bucket under a frontier that peaks far above it.
    hj, hp = both(jax_adversarial(k, batch=4, seed=1, unsatisfiable=unsat))
    kw = dict(
        max_frontier=64, start_frontier=16, beam=False, device_rows_cap=4096, collect_stats=True,
        profile=True, prune=bool(depth), speculate_depth=depth,
    )
    rj = jdev.check_device(hj, **kw)
    chunked = _Counter(monkeypatch, "_expand_layer_chunked")
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == (CheckOutcome.ILLEGAL if unsat else CheckOutcome.OK)
    assert_checks_equal(rj, rp, hp)
    if unsat or not depth:  # (a dive may accept before the tier)
        assert rp.stats.max_frontier > 64 and chunked.calls > 0
        assert max(e["bucket"] for e in rp.stats.timeline) > 64


@pytest.mark.parametrize("depth", [0, 3])
def test_check_device_tier_segments_and_downsize_match_jax(depth):
    # A narrow collected history through a 4-row bucket: 8-layer segments
    # while the frontier is above it, and the drop to a smaller bucket
    # once the live rows fit a quarter of it.
    hj, hp = both(CASES["collected-match-seq-num"])
    kw = dict(
        max_frontier=4, start_frontier=16, beam=False, device_rows_cap=256, collect_stats=True,
        profile=True, prune=bool(depth), speculate_depth=depth,
    )
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == CheckOutcome.OK
    assert_checks_equal(rj, rp, hp)
    tl = rp.stats.timeline
    big = [(a, b) for a, b in zip(tl, tl[1:]) if a["stop"] == "RUNNING" and a["bucket"] > 4]
    assert big and all(b["layer"] - a["layer"] <= 8 for a, b in big)
    if depth:
        assert rp.stats.spec_launches == len(tl)
    else:
        assert any(b["bucket"] < a["bucket"] for a, b in big)  # post-peak downsize


def test_sort_dedup_check_device_matches_jax():
    hj, hp = both(jax_adversarial(6, batch=4, seed=3))
    kw = dict(max_frontier=4096, start_frontier=16, beam=False, collect_stats=True, sort_dedup=True)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == CheckOutcome.OK
    assert_checks_equal(rj, rp, hp)


def test_beam_and_unpackable_never_enter_the_tier(monkeypatch):
    chunked = _Counter(monkeypatch, "_expand_layer_chunked")
    hj, hp = both(jax_adversarial(5, batch=4, seed=1))
    kw = dict(max_frontier=64, start_frontier=16, beam=True, device_rows_cap=4096, collect_stats=True)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert_checks_equal(rj, rp, hp)

    hj, hp = both(jax_adversarial(65, batch=1, seed=0))
    assert not pdev.can_exact_pack(pdev.encode_history(hp))
    kw = dict(max_frontier=128, start_frontier=16, beam=False, device_rows_cap=512, collect_stats=True)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rj.outcome == JaxOutcome.UNKNOWN
    assert_checks_equal(rj, rp, hp)
    assert rp.stats.pruned
    assert chunked.calls == 0
    for opt in ("sort_dedup", "exact_pack"):
        with pytest.raises(ValueError, match=opt):
            jdev.check_device(hj, max_frontier=64, **{opt: True})
        with pytest.raises(ValueError, match=opt):
            pdev.check_device(hp, max_frontier=64, device="cpu", **{opt: True})


def test_past_device_rows_cap_unknown_or_spill_refusal():
    hj, hp = both(jax_adversarial(6, batch=4, seed=1))
    kw = dict(max_frontier=32, start_frontier=16, beam=False, device_rows_cap=128, collect_stats=True)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert rp.outcome == CheckOutcome.UNKNOWN and rp.stats.pruned
    assert_checks_equal(rj, rp, hp)
    # With the spill both engines hand this frontier to host RAM and decide
    # OK (the JAX package's test_device.py:796-806).
    rj = jdev.check_device(hj, spill=True, **kw)
    rp = pdev.check_device(hp, device="cpu", spill=True, **kw)
    assert rp.outcome == CheckOutcome.OK
    assert_checks_equal(rj, rp, hp)


def _jax_auto_rows_cap(monkeypatch, backend, spill):
    """The ``device_rows_cap`` the JAX ``check_device_auto`` hands its
    exhaustive phase on ``backend``."""
    seen = {}

    def fake(history, **kw):
        if kw.get("beam"):
            return jdev.CheckResult(JaxOutcome.UNKNOWN)
        seen.update(kw)
        return jdev.CheckResult(JaxOutcome.OK)

    with monkeypatch.context() as m:
        m.setattr(jdev.jax, "default_backend", lambda: backend)
        m.setattr(jdev, "check_device", fake)
        jdev.check_device_auto(None, spill=spill)
    return seen["device_rows_cap"]


@pytest.mark.parametrize("spill", [True, False])
def test_auto_device_rows_cap_default_matches_jax(monkeypatch, spill):
    for backend, device in (("cpu", "cpu"), ("gpu", "cuda")):
        want = _jax_auto_rows_cap(monkeypatch, backend, spill)
        assert pdev.default_device_rows_cap(torch.device(device), spill) == want
    # On the CPU the default reaches the exhaustive phase (spied).
    seen = {}
    real = pdev.check_device

    def spy(history, **kw):
        if not kw["beam"]:
            seen.update(kw)
        return real(history, **kw)

    monkeypatch.setattr(pdev, "check_device", spy)
    _, hp = both(jax_adversarial(6, batch=2, seed=3))
    res = pdev.check_device_auto(hp, beam_width=16, exhaustive_cap=4096, device="cpu", spill=spill)
    assert seen["device_rows_cap"] == (0 if spill else 1 << 23)
    assert seen["spill"] is spill
    assert res.outcome == CheckOutcome.OK
    assert_replays(hp, res.linearization)
