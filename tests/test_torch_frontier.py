"""Port parity: the host frontier engine (``checker/frontier.py``).

``check_frontier`` and ``check_frontier_auto`` against the JAX package's,
integer-exact: outcome, linearization, ``deepest``, final states and every
search statistic, on random histories, the campaign matrix (with and without
``prune``), small adversarial histories (k <= 7, satisfiable and not, beam
and exhaustive), a time budget that expires, the per-layer timeline of
``profile=True``.  The statistics are the port's one ``FrontierStats``
class.
"""

import importlib
import random

import pytest

from s2_verification_tpu.collector.campaign import builtin_campaigns, collect_labeled
from s2_verification_tpu_torch.checker import frontier as pfr
from s2_verification_tpu_torch.checker.oracle import check
from s2_verification_tpu_torch.checker.stats import FrontierStats

from test_oracle_bruteforce import random_history
from test_torch_device import both, jax_adversarial

jfr = importlib.import_module("s2_verification_tpu.checker.frontier")

#: every FrontierStats field both engines fill (host_syncs is the port's)
FIELDS = ("layers", "max_frontier", "max_state_set", "auto_closed", "expanded", "pruned",
          "prune_commits", "prune_dead", "prune_ranked")


def assert_same(rj, rp):
    assert rp.outcome.value == rj.outcome.value
    assert rp.linearization == rj.linearization
    assert rp.deepest == rj.deepest
    assert [tuple(s) for s in rp.final_states] == [tuple(s) for s in rj.final_states]
    sj, sp = getattr(rj, "stats", None), getattr(rp, "stats", None)
    assert (sj is None) == (sp is None)
    if sp is not None:
        assert isinstance(sp, FrontierStats)
        for f in FIELDS:
            assert getattr(sp, f) == getattr(sj, f), f
        strip = lambda t: [{k: v for k, v in e.items() if k != "elapsed_s"} for e in t]  # noqa: E731
        assert strip(sp.timeline) == strip(sj.timeline)


def test_one_stats_class():
    assert pfr.FrontierStats is FrontierStats


def test_random_histories_equal_jax():
    rng = random.Random(0xF00D)
    for _ in range(60):
        hj, hp = both(random_history(rng).events)
        for kw in (dict(), dict(auto_close=False), dict(max_frontier=2, beam=True)):
            assert_same(jfr.check_frontier(hj, collect_stats=True, **kw),
                        pfr.check_frontier(hp, collect_stats=True, **kw))


CAMPAIGNS = sorted(builtin_campaigns())


@pytest.fixture(scope="module")
def campaign_histories():
    return {name: both(collect_labeled(c, seed=11)[0]) for name, c in builtin_campaigns().items()}


@pytest.mark.parametrize("prune", [False, True], ids=["plain", "prune"])
def test_campaign_matrix_equals_jax(campaign_histories, prune):
    # fencing-race (5 s a run un-pruned) runs pruned only
    for name in CAMPAIGNS:
        if name == "fencing-race" and not prune:
            continue
        hj, hp = campaign_histories[name]
        rj = jfr.check_frontier_auto(hj, collect_stats=True, prune=prune)
        rp = pfr.check_frontier_auto(hp, collect_stats=True, prune=prune)
        assert_same(rj, rp)
        assert rp.outcome == check(hp).outcome, name


#: k <= 7; the unsatisfiable k=7 (~40 s a run in either engine) is left out
ADVERSARIAL = [(3, False), (3, True), (5, False), (5, True), (6, True), (7, False)]


@pytest.mark.parametrize("k,unsat", ADVERSARIAL, ids=[f"k{k}-{'unsat' if u else 'sat'}" for k, u in ADVERSARIAL])
def test_adversarial_equals_jax(k, unsat):
    hj, hp = both(jax_adversarial(k, batch=3, seed=k, unsatisfiable=unsat))
    for kw in (dict(beam_width=8), dict(beam_width=8, prune=True), dict(beam_width=4096, profile=True)):
        rp = pfr.check_frontier_auto(hp, collect_stats=True, **kw)
        assert_same(jfr.check_frontier_auto(hj, collect_stats=True, **kw), rp)
        assert rp.outcome.value == ("illegal" if unsat else "ok")


def test_expired_budget_equals_jax():
    hj, hp = both(jax_adversarial(7, batch=3, seed=1))
    rj = jfr.check_frontier(hj, time_budget_s=0.0, collect_stats=True)
    rp = pfr.check_frontier(hp, time_budget_s=0.0, collect_stats=True)
    assert rp.outcome.value == "unknown"
    assert_same(rj, rp)
