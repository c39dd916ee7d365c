"""``chip_smoke.py``'s witness checks accept a real witness and refuse a bad one.

The smoke run holds the device's witness of each collected history to
``replay_ok`` (pairwise real-time order) and ``replay_fast`` (the same in
one pass over the order). Here, on the CPU: for collected histories of the
smoke run's workflows, both accept the port's CPU witness, both refuse it
with one real-time-ordered pair swapped (``swap_real_time_pair``), and both
refuse an order that drops an op.
"""

import importlib.util
import pathlib

import pytest

from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.collector.collect import CollectConfig, collect_history
from s2_verification_tpu_torch.collector.fake_s2 import FaultPlan

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "workflow, clients, ops", [("regular", 2, 50), ("match-seq-num", 3, 60), ("fencing", 4, 40)]
)
def test_replay_checks_refuse_a_swapped_witness(workflow, clients, ops):
    smoke = _chip_smoke()
    faults = FaultPlan(p_append_definite=0.05, p_append_indefinite=12.0 / (clients * ops),
                       p_read_fail=0.02, p_check_tail_fail=0.02)
    hist = prepare(collect_history(CollectConfig(clients, ops, workflow, seed=4242, faults=faults)))
    res = pdev.check_device_auto(hist, device="cpu")
    order = list(res.linearization)
    assert res.outcome.value == "ok"
    assert smoke.replay_ok(hist, order) and smoke.replay_fast(hist, order)
    bad = smoke.swap_real_time_pair(hist, order)
    assert bad is not None and sorted(bad) == sorted(order)
    assert not smoke.replay_ok(hist, bad) and not smoke.replay_fast(hist, bad)
    assert not smoke.replay_ok(hist, order[:-1]) and not smoke.replay_fast(hist, order[:-1])
