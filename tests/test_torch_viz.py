"""Port parity: the HTML visualization (``viz.py``).

``render_html`` (and the file ``write_visualization`` writes) is byte for
byte the JAX package's for the same history and the same result: an OK with
its linearization and final states, an ILLEGAL with refusal reports
re-derived by the diagnostics (one configuration, and several taken as
sorted op sets, the device engine's form, which the viz re-derives), an
UNKNOWN of a budgeted oracle, and a frontier-engine result with its
per-layer timeline.
"""

import importlib

import pytest

from s2_verification_tpu.checker.entries import prepare as jax_prepare
from s2_verification_tpu.checker.oracle import CheckOutcome as JOutcome
from s2_verification_tpu.checker.oracle import CheckResult as JResult
from s2_verification_tpu.checker.oracle import check as jax_check
from s2_verification_tpu.collector.campaign import builtin_campaigns, collect_labeled
from s2_verification_tpu_torch import viz as pviz
from s2_verification_tpu_torch.checker import frontier as pfr
from s2_verification_tpu_torch.checker.diagnostics import deepest_refusals
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, CheckResult, check

from test_torch_device import jax_adversarial
from test_torch_encode import collected, to_port

jviz = importlib.import_module("s2_verification_tpu.viz")
jfr = importlib.import_module("s2_verification_tpu.checker.frontier")
jdiag = importlib.import_module("s2_verification_tpu.checker.diagnostics")


def _histories(events):
    return (
        (jax_prepare(events, elide_trivial=False), jax_prepare(events)),
        (prepare(to_port(events), elide_trivial=False), prepare(to_port(events))),
    )


def _render(events, res_j, res_p, title="t"):
    (fj, cj), (fp, cp) = _histories(events)
    hj = jviz.render_html(fj, res_j, title=title, checked=cj)
    hp = pviz.render_html(fp, res_p, title=title, checked=cp)
    return hj, hp


def _illegal_events():
    camp = builtin_campaigns()["reorder"]
    return collect_labeled(camp, seed=11)[0]


def test_ok_with_linearization_is_byte_equal(tmp_path):
    events = collected("fencing")
    (_, cj), (_, cp) = _histories(events)
    rj, rp = jax_check(cj), check(cp)
    assert rp.ok and rp.final_states
    hj, hp = _render(events, rj, rp, title="s2 linearizability check — h.jsonl")
    assert hp == hj and "final states" in hp
    (fj, _), (fp, _) = _histories(events)
    jviz.write_visualization(str(tmp_path / "j.html"), fj, rj, checked=cj)
    pviz.write_visualization(str(tmp_path / "p.html"), fp, rp, checked=cp)
    assert (tmp_path / "p.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_illegal_with_rederived_refusals_is_byte_equal():
    events = _illegal_events()
    (_, cj), (_, cp) = _histories(events)
    rj, rp = jax_check(cj), check(cp)
    assert rp.outcome == CheckOutcome.ILLEGAL
    rj.refusals = [jdiag.deepest_refusals(cj, rj.deepest)]
    rp.refusals = [deepest_refusals(cp, rp.deepest)]
    assert rp.refusals[0][1]
    hj, hp = _render(events, rj, rp)
    assert hp == hj and "refusing to linearize" in hp


def test_device_style_refusal_sets_are_byte_equal():
    # Refusals as sorted op sets (not orders), several configurations: the
    # viz re-derives an order for each and offers a selector.
    events = jax_adversarial(5, batch=3, seed=5, unsatisfiable=True)
    (_, cj), (_, cp) = _histories(events)
    rep = deepest_refusals(cp, check(cp).deepest)
    prefix, refused = sorted(rep[0]), rep[1]
    cfgs = [(prefix, refused), (sorted(prefix[:-1]), refused[:1])]
    rj = JResult(JOutcome.ILLEGAL, deepest=prefix, refusals=cfgs)
    rp = CheckResult(CheckOutcome.ILLEGAL, deepest=prefix, refusals=cfgs)
    hj, hp = _render(events, rj, rp)
    assert hp == hj and "cfg-select" in hp


def test_unknown_of_a_budgeted_oracle_is_byte_equal():
    events = jax_adversarial(9, batch=4, seed=3)
    (_, cj), (_, cp) = _histories(events)
    rj = JResult(JOutcome.UNKNOWN, deepest=jax_check(cj, time_budget_s=0.05).deepest)
    rp = CheckResult(CheckOutcome.UNKNOWN, deepest=list(rj.deepest))
    assert rp.deepest
    hj, hp = _render(events, rj, rp)
    assert hp == hj and "deepest linearized prefix" in hp


@pytest.mark.parametrize("unsat", [False, True], ids=["ok", "illegal"])
def test_frontier_timeline_panel_is_byte_equal(unsat):
    events = jax_adversarial(5, batch=3, seed=2, unsatisfiable=unsat)
    (_, cj), (_, cp) = _histories(events)
    rj = jfr.check_frontier(cj, profile=True)
    rp = pfr.check_frontier(cp, profile=True)
    for r in (rj, rp):
        for e in r.stats.timeline:
            e["elapsed_s"] = 0.0  # the one wall-clock field
    hj, hp = _render(events, rj, rp)
    assert hp == hj and "frontier timeline" in hp
