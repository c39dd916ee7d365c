"""Port parity: commutativity pruning and the speculative dive.

Held integer-exact (tolerance 0) against the JAX package on the same
inputs:

- ``checker/prune.py``: ``classify_pair``, ``commutes``, ``order_mask`` and
  ``analyze_history`` on random histories (``random_history``, seeded) and
  hand-built ones; ``analyze_encoded`` tables, ``op_class_masks`` and the
  pruned search tables on adversarial k=3..8, the three collector
  workflows and every builtin campaign;
- ``check_device(prune=True, speculate_depth=K)`` and ``check_device_auto``
  with the same options: outcome, layers, peak frontier, expanded,
  auto-closed, pruned, the prune and ``spec_*`` counters, final states,
  witness (which must replay), and the ``profile=True`` timeline but for
  ``elapsed_s``;
- ``run_search(spec_depth=2)`` from JAX-built pruned tables: the frontier
  arrays and the ``RunOut`` scalars after a segment whose dive accepts and
  after segments whose dive rolls back;
- ``check --prune --speculate-depth 3 -profile P -stats`` through both
  CLIs: exit codes and the profile's counters.

The JAX side runs on the CPU with its default scan fold; the port runs
with ``device="cpu"`` (the plain PyTorch fold).  Each history runs one
``speculate_depth``, so the JAX engine compiles few programs.
"""

import importlib
import json
import random

import numpy as np
import pytest
import torch

from s2_verification_tpu import cli as jcli
from s2_verification_tpu.checker import prune as jprune
from s2_verification_tpu.checker.entries import prepare as jax_prepare
from s2_verification_tpu.collector import campaign as jcampaign
from s2_verification_tpu.collector.adversarial import adversarial_events as jax_adversarial
from s2_verification_tpu.models.encode import encode_history as jax_encode
from s2_verification_tpu.models.encode import op_class_masks as jax_op_class_masks
from s2_verification_tpu_torch import cli as pcli
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker import prune as pprune
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, check
from s2_verification_tpu_torch.models.encode import encode_history, op_class_masks

from helpers import H, fold
from test_oracle_bruteforce import random_history
from test_torch_device import (
    TABLE_CASES,
    assert_frontier_equal,
    assert_replays,
    both,
    jax_tables_dict,
)
from test_torch_encode import collected, jax_text, to_port

jdev = importlib.import_module("s2_verification_tpu.checker.device")

COUNTERS = (
    "layers", "max_frontier", "expanded", "auto_closed", "pruned",
    "prune_commits", "prune_dead", "prune_ranked",
    "spec_launches", "spec_layers", "spec_accepts", "spec_rollbacks",
)


def _ops_both(events):
    """Both packages' ops of one event list, trivial ops kept."""
    return (
        jax_prepare(events, elide_trivial=False),
        prepare(to_port(events), elide_trivial=False),
    )


def _mixed_history():
    h = H()
    h.append_ok(1, [5], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([5]))
    h.append_ok(1, [6], tail=2)
    h.check_tail_ok(3, tail=2)
    h.append_ok(2, [7], tail=3)
    h.append_definite_fail(3, [9])
    h.read_ok(1, tail=3, stream_hash=fold([5, 6, 7]))
    h.append_ok(2, [8], tail=3)  # a duplicate out_tail: unranked group
    h.read_ok(3, tail=3, stream_hash=fold([5, 6, 9]))  # conflicting contents
    h.append_indefinite_fail(1, [4])
    h.append_ok(3, [], tail=4, set_token="t7")
    h.read_fail(2)
    return h.events


def _assert_static_analysis_equal(hj, hp):
    for a, b in zip(hj.ops, hp.ops):
        for c, d in zip(hj.ops, hp.ops):
            assert pprune.classify_pair(b, d) == jprune.classify_pair(a, c)
            assert pprune.commutes(b, d) == jprune.commutes(a, c)
    mask = pprune.order_mask(hp)
    np.testing.assert_array_equal(mask, jprune.order_mask(hj))
    # A strict partial order: irreflexive, antisymmetric, closed.
    assert not mask.diagonal().any() and not (mask & mask.T).any()
    closure = mask.copy()
    for _ in range(len(hp.ops)):
        closure = closure | (closure @ closure)
    assert (closure == mask).all()
    pj, pp = jprune.analyze_history(hj), pprune.analyze_history(hp)
    assert pp.rank == pj.rank and pp.n_ranked == pj.n_ranked
    assert pp.minrank == pj.minrank and pp.pin == pj.pin
    assert pp.inert == pj.inert and pp.filter_guard == pj.filter_guard
    for k in range(len(hp.ops) + 1):
        counts = tuple(min(k, len(c)) for c in hp.chains)
        assert pp.min_remaining_rank(counts) == pj.min_remaining_rank(counts)
        assert pp.min_pin(counts) == pj.min_pin(counts)


@pytest.mark.parametrize("seed", range(8))
def test_static_analysis_matches_jax_on_random_histories(seed):
    rng = random.Random(0x5EED + seed)
    for _ in range(6):
        _assert_static_analysis_equal(*_ops_both(random_history(rng).events))


def test_static_analysis_matches_jax_on_every_pair_class():
    hj, hp = _ops_both(_mixed_history())
    classes = {pprune.classify_pair(a, b) for a in hp.ops for b in hp.ops}
    assert classes == {pprune.FREE, pprune.ORDERED, pprune.CONFLICT}
    _assert_static_analysis_equal(hj, hp)


def _campaign(name):
    return jcampaign.collect_labeled(jcampaign.builtin_campaigns()[name], seed=11)[0]


TABLE_HISTORIES = {
    **{f"adv-k{k}": (jax_adversarial, (k,), dict(batch=3, seed=k)) for k in range(3, 9)},
    "adv-k7-unsat": (jax_adversarial, (7,), dict(batch=2, seed=1, unsatisfiable=True)),
    **{f"collected-{w}": (collected, (w,), {}) for w in ("regular", "match-seq-num", "fencing")},
    **{f"campaign-{n}": (_campaign, (n,), {}) for n in sorted(jcampaign.builtin_campaigns())},
}


@pytest.mark.parametrize("name", sorted(TABLE_HISTORIES))
def test_analyze_encoded_and_pruned_tables_match_jax(name):
    fn, args, kw = TABLE_HISTORIES[name]
    hj, hp = both(fn(*args, **kw))
    ej, ep = jax_encode(hj), encode_history(hp)
    mj, mp = jax_op_class_masks(ej), op_class_masks(ep)
    assert sorted(mj) == sorted(mp)
    for k in mj:
        np.testing.assert_array_equal(mp[k], mj[k])
    tj, tp = jprune.analyze_encoded(ej), pprune.analyze_encoded(ep)
    assert tp.n_ranked == tj.n_ranked
    for f in ("app_rank", "minrank_tab", "pintail_tab", "inert", "filter_succ"):
        a, b = getattr(tp, f), getattr(tj, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # The pruned search tables, built by each package, are the same tables.
    mine = pdev.build_tables(ep, "cpu", prune=True)
    carried = pdev.tables_from_arrays(jax_tables_dict(jdev.build_tables(ej, prune=True)), "cpu")
    for field, a, b in zip(mine._fields, mine, carried):
        if field == "ops":
            for f, x, y in zip(a._fields, a, b):
                assert torch.equal(x, y), f
        elif field in ("can_close", "tok_close"):
            assert a == b
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), field


def _profile_rows(timeline):
    return [{k: v for k, v in e.items() if k != "elapsed_s"} for e in timeline]


def assert_pruned_equal(rj, rp, hp):
    assert rp.outcome.value == rj.outcome.value
    assert [tuple(s) for s in rp.final_states] == [tuple(s) for s in rj.final_states]
    assert rp.linearization == rj.linearization
    assert rp.deepest == rj.deepest
    assert rp.refusals == rj.refusals
    for f in COUNTERS:
        assert getattr(rp.stats, f) == getattr(rj.stats, f), f
    assert _profile_rows(rp.stats.timeline) == _profile_rows(rj.stats.timeline)
    assert rp.stats.timeline and all(e["elapsed_s"] >= 0 for e in rp.stats.timeline)
    if rp.linearization is not None:
        assert_replays(hp, rp.linearization)


# (history, speculate_depth): one depth per history keeps the JAX compiles few
CHECK_CASES = [
    ("adv-k5", 2),
    ("adv-k6-unsat", 3),
    ("collected-match-seq-num", 3),
    ("collected-fencing", 2),
    ("collected-regular", 0),
    ("campaign-fencing-race", 3),
]


def _case_events(name):
    if name in TABLE_CASES:
        return TABLE_CASES[name]
    fn, args, kw = TABLE_HISTORIES[name]
    return fn(*args, **kw)


@pytest.mark.parametrize("name,depth", CHECK_CASES, ids=[f"{n}-spec{d}" for n, d in CHECK_CASES])
def test_pruned_check_device_matches_jax(name, depth):
    hj, hp = both(_case_events(name))
    kw = dict(max_frontier=4096, beam=False, profile=True, prune=True, speculate_depth=depth)
    rj = jdev.check_device(hj, **kw)
    rp = pdev.check_device(hp, device="cpu", **kw)
    assert_pruned_equal(rj, rp, hp)
    assert rp.outcome == check(hp).outcome
    assert rp.stats.spec_launches == (len(rp.stats.timeline) if depth else 0)


@pytest.mark.parametrize("unsat", [False, True])
def test_pruned_check_device_auto_matches_jax(unsat):
    # A beam narrower than the peak frontier: the beam phase concedes and
    # the exhaustive phase decides; both phases get the options.
    hj, hp = both(jax_adversarial(6, batch=2, seed=3, unsatisfiable=unsat))
    kw = dict(beam_width=16, exhaustive_cap=4096, profile=True, prune=True, speculate_depth=2)
    rj = jdev.check_device_auto(hj, spill=False, device_rows_cap=0, **kw)
    rp = pdev.check_device_auto(hp, device="cpu", **kw)
    assert_pruned_equal(rj, rp, hp)
    assert rp.outcome == check(hp).outcome
    assert rp.stats.spec_launches > 0


# (case, start frontier, layers, what the dive does)
DIVE_CASES = [
    ("adv-k5", 64, 3, "accepts"),
    ("collected-match-seq-num", 16, 3, "rolls back"),
    ("adv-k6-unsat", 64, 3, "rolls back, then a capacity stop"),
]


@pytest.mark.parametrize("name,f,n,what", DIVE_CASES, ids=[c[0] for c in DIVE_CASES])
def test_run_search_dive_matches_jax(name, f, n, what):
    hj, hp = both(TABLE_CASES[name])
    ej, ep = jax_encode(hj), encode_history(hp)
    xp = pdev.can_exact_pack(ep)
    tj = jdev.build_tables(ej, prune=True)
    tp = pdev.tables_from_arrays(jax_tables_dict(tj), "cpu")
    kw = dict(allow_prune=False, exact_pack=xp, spec_depth=2, spec_width=64)
    oj = jdev.run_search(tj, jdev.init_frontier(ej, f), np.int32(n), **kw)
    op = pdev.run_search(tp, pdev.init_frontier(ep, f, "cpu"), n, **kw)
    assert_frontier_equal(oj.frontier, op.frontier)
    fields = ("stop_code", "accept_idx", "layers", "pruned_ever", "max_live", "auto_closed",
              "expanded", "eager_closed", "pin_killed", "spec_layers", "spec_accepts",
              "spec_rollbacks", "want")
    assert {k: int(getattr(op, k)) for k in fields} == {k: int(getattr(oj, k)) for k in fields}
    np.testing.assert_array_equal(np.asarray(oj.deep_counts), op.deep_counts.numpy())
    assert op.live == int(np.asarray(oj.frontier.valid).sum())
    accepted = op.spec_accepts == 1
    assert accepted == (what == "accepts")
    if accepted:
        assert op.stop_code == pdev.STOP_ACCEPT and op.live == 1 and op.layers == op.spec_layers
    else:
        assert op.spec_rollbacks == 1 and op.spec_layers > 0
        assert (op.stop_code == pdev.STOP_CAPACITY) == what.endswith("capacity stop")


def _write(tmp_path, events, name):
    path = tmp_path / name
    path.write_text(jax_text(events))
    return str(path)


@pytest.mark.parametrize("unsat", [False, True])
def test_cli_prune_speculate_profile_match_jax(tmp_path, capsys, unsat):
    path = _write(tmp_path, jax_adversarial(6, batch=3, seed=5, unsatisfiable=unsat), "h.jsonl")
    flags = ["--prune", "--speculate-depth", "3", "-stats"]
    jp, pp = tmp_path / "jax.json", tmp_path / "port.json"
    rc_j = jcli.main(["check", f"-file={path}", "-backend=device", "-no-viz", f"-profile={jp}", *flags])
    capsys.readouterr()
    rc_p = pcli.main(["check", f"-file={path}", "-backend=device", "-no-viz", "-device", "cpu", f"-profile={pp}",
                      *flags])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc_p == rc_j == (1 if unsat else 0)
    prof_j, prof_p = json.loads(jp.read_text()), json.loads(pp.read_text())
    for prof in (prof_j, prof_p):
        prof.pop("wall_s")
        prof.pop("file")
        prof["timeline"] = _profile_rows(prof["timeline"])
    assert prof_p == prof_j
    assert prof_p["spec_launches"] > 0
    # -stats carries the counters that fired, as the profile does.
    for f in pprune_counters(prof_p):
        assert line[f] == prof_p[f]


def pprune_counters(prof):
    return [f for f in COUNTERS if f.startswith(("prune_", "spec_")) and f in prof]


def test_cli_oracle_takes_prune_and_ignores_it(tmp_path, capsys):
    path = _write(tmp_path, jax_adversarial(4, batch=2, seed=1), "h.jsonl")
    prof = tmp_path / "p.json"
    rc = pcli.main(["check", f"-file={path}", "-backend=oracle", "-no-viz", "--prune", f"-profile={prof}", "-stats"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["outcome"] == "ok" and "prune_commits" not in line
    assert json.loads(prof.read_text())["outcome"] == "ok"


def test_pruned_verdicts_equal_unpruned_on_random_histories():
    rng = random.Random(0xDEC0)
    outcomes = set()
    for trial in range(20):
        hp = prepare(to_port(random_history(rng).events))
        plain = pdev.check_device(hp, max_frontier=256, beam=False, device="cpu")
        pruned = pdev.check_device(hp, max_frontier=256, beam=False, device="cpu",
                                   prune=True, speculate_depth=2)
        assert pruned.outcome == plain.outcome == check(hp).outcome, trial
        if pruned.outcome == CheckOutcome.OK:
            assert_replays(hp, pruned.linearization)
        outcomes.add(pruned.outcome)
    assert outcomes == {CheckOutcome.OK, CheckOutcome.ILLEGAL}
