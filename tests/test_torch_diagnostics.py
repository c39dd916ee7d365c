"""Port parity: the failure diagnostics (``checker/diagnostics.py``).

``deepest_refusals`` and ``derive_path`` against the JAX package's, exact:
for the deepest prefix of every ILLEGAL or UNKNOWN oracle run over random
histories, the campaign matrix's violations and unsatisfiable adversarial
histories, the re-derived order, its end state and the refused ops are the
same; a set that is not a per-chain prefix, and a node budget that runs
out, give no report in both.
"""

import importlib
import random

from s2_verification_tpu.checker.oracle import check as jax_check
from s2_verification_tpu.collector.campaign import builtin_campaigns, collect_labeled
from s2_verification_tpu_torch.checker import diagnostics as pdiag
from s2_verification_tpu_torch.checker.oracle import check

from test_oracle_bruteforce import random_history
from test_torch_device import both, jax_adversarial

jdiag = importlib.import_module("s2_verification_tpu.checker.diagnostics")


def _failing_pairs():
    out = []
    rng = random.Random(0xD1A6)
    while len(out) < 25:
        hj, hp = both(random_history(rng).events)
        if not check(hp).ok:
            out.append((hj, hp))
    for camp in builtin_campaigns().values():
        if camp.violation_class() is not None:
            out.append(both(collect_labeled(camp, seed=11)[0]))
    for k in (3, 5, 6):
        out.append(both(jax_adversarial(k, batch=3, seed=k, unsatisfiable=True)))
    return out


def assert_same_path(pj, pp):
    order_j, state_j = pj
    order_p, state_p = pp
    assert order_p == order_j
    assert (tuple(state_p) if state_p is not None else None) == (tuple(state_j) if state_j is not None else None)


def test_refusals_and_paths_equal_jax():
    reports = 0
    for hj, hp in _failing_pairs():
        rp, rj = check(hp), jax_check(hj)
        assert rp.deepest == rj.deepest
        got = pdiag.deepest_refusals(hp, rp.deepest)
        assert got == jdiag.deepest_refusals(hj, rj.deepest)
        assert_same_path(jdiag.derive_path(hj, rj.deepest), pdiag.derive_path(hp, rp.deepest))
        reports += got is not None
    assert reports >= 25


def test_no_report_where_jax_gives_none():
    hj, hp = both(collect_labeled(builtin_campaigns()["reorder"], seed=11)[0])
    deepest = check(hp).deepest
    assert len(deepest) > 2
    ds = set(deepest)
    chain = next(c for c in hp.chains if len(c) > 1 and c[0] in ds and c[1] in ds)
    not_prefix = [j for j in deepest if j != chain[0]]  # a chain's later op without its first
    assert pdiag.deepest_refusals(hp, not_prefix) is None is jdiag.deepest_refusals(hj, not_prefix)
    assert pdiag.derive_path(hp, not_prefix) == (None, None) == jdiag.derive_path(hj, not_prefix)
    assert pdiag.deepest_refusals(hp, deepest, node_budget=2) is None
    assert jdiag.deepest_refusals(hj, deepest, node_budget=2) is None
