"""The harness on the CPU: it finds what a cell names by file, runs a cell
end to end at a small size, and its check comes out false when the timed
path's answers are broken underneath."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest

from gpubench.harness import spec
from gpubench.harness.result import execute
from s2_verification_tpu_torch.checker import device as dev_mod
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, CheckResult

#: each cell at a size the CPU decides in about a second
SMALL = {
    "adv.k9-illegal": {"params": {"k": 5}},
    "adv.k10-ok": {"params": {"k": 5, "applied": 2}},
    "msn.5x200": {"params": {"num_ops_per_client": 40}, "warmup": {"num_ops_per_client": 12}},
}


def small_cell(name: str, root: Path = spec.ROOT) -> spec.Cell:
    cell = spec.load_cell(name, root)
    over = SMALL[name]
    cell.traffic["params"] = {**cell.traffic["params"], **over["params"]}
    cell.traffic["warmup"] = over.get("warmup", {})
    cell.traffic["pool"] = 3
    cell.traffic["judge"] = {"illegal_sample": "all"}
    return cell


def run_small(name: str, root: Path = spec.ROOT) -> dict:
    return execute(small_cell(name, root), 2**40 + 9, 0.5, False, time.perf_counter(), device="cpu")


def test_finds_a_configuration_a_mix_and_a_metric_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "gpubench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    (root / "gpubench" / "configs" / "adversarial-b20.json").write_text(json.dumps(
        {"name": "adversarial-b20", "params": {"batch": 20, "max_client_ids": 20}, "reduced": []}))
    (root / "gpubench" / "traffic" / "k4-ok.json").write_text(json.dumps(
        {"generator": "adversarial", "params": {"k": 4, "applied": 2}, "pool": 2, "warmup": {},
         "judge": {"illegal_sample": "all"}, "trace": {"requests": 1}}))
    (root / "gpubench" / "e2e" / "verdicts_total.py").write_text("def read(run):\n    return float(len(run.requests))\n")
    bench["configs"].append({"name": "adversarial-b20", "source": "fixture", "file": "gpubench/configs/adversarial-b20.json",
                             "reduced": [], "why": "fixture"})
    bench["workloads"].append({"name": "adv.k4-ok", "config": "adversarial-b20", "traffic": "k4-ok", "chips": 1, "why": "fixture"})
    bench["end_to_end"].append({"name": "verdicts_total", "unit": "verdicts", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["adv.k4-ok"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("adv.k4-ok", root)
    assert cell.config["params"]["batch"] == 20 and cell.params()["k"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "verdicts_total"]
    out = execute(cell, 5, 0.3, False, time.perf_counter(), device="cpu")
    assert out["correct"] and out["metrics"]["verdicts_total"]["value"] == out["attempted"] >= 1


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_small_run_is_correct(name):
    out = run_small(name)
    assert out["correct"], out
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks" and out["checks"]["wrong"] == {"value": 0, "limit": 0}
    cell = spec.load_cell(name)
    # a device trace exists only on the card
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end if m["source"] != "device_trace"}


def _altered(alter):
    real = dev_mod.check_device_auto

    def broken(hist, **kw):
        return alter(hist, real(hist, **kw))

    return broken


def _flip(hist, res):
    """The verdict altered where it is produced."""
    if res.ok:
        return CheckResult(CheckOutcome.ILLEGAL)
    return CheckResult(CheckOutcome.OK, linearization=list(range(len(hist.ops))))


def _swap(hist, res):
    """The witness altered: its first real-time pair swapped, or where no
    pair is ordered in real time (every op of an adversarial history
    overlaps every other), its first two ops."""
    order = list(res.linearization)
    i = next((i for i in range(len(order) - 1) if hist.ops[order[i]].ret < hist.ops[order[i + 1]].call), 0)
    order[i], order[i + 1] = order[i + 1], order[i]
    return CheckResult(CheckOutcome.OK, linearization=order)


def _drop(hist, res):
    """The witness altered: an op left out."""
    return CheckResult(CheckOutcome.OK, linearization=list(res.linearization)[:-1])


def _unknown(hist, res):
    return CheckResult(CheckOutcome.UNKNOWN)


@pytest.mark.parametrize("name,alter", [
    ("adv.k9-illegal", _flip), ("adv.k9-illegal", _unknown),
    ("adv.k10-ok", _flip), ("adv.k10-ok", _swap), ("adv.k10-ok", _drop),
    ("msn.5x200", _flip), ("msn.5x200", _swap), ("msn.5x200", _drop),
])
def test_a_broken_answer_is_not_correct(monkeypatch, name, alter):
    monkeypatch.setattr(dev_mod, "check_device_auto", _altered(alter))
    out = run_small(name)
    assert not out["correct"]
    assert out["checks"]["wrong"]["value"] + out["checks"]["failed"]["value"] >= 1


@pytest.mark.parametrize("name", ["adv.k10-ok", "msn.5x200"])
def test_a_fold_that_leaves_its_state_unchanged_is_not_correct(monkeypatch, name):
    """The fold's step returning its state unchanged: no OK history can then
    be linearized."""
    monkeypatch.setattr(dev_mod, "fold_lanes", lambda seed, row, length, rh: seed.clone())
    out = run_small(name)
    assert not out["correct"] and out["checks"]["wrong"]["value"] >= 1


def test_every_ok_is_judged_where_illegals_are_sampled():
    """An OK with a bad witness among many ILLEGALs is caught, however few
    ILLEGALs the traffic mix samples."""
    from gpubench.gen import adversarial
    from gpubench.harness.judge import judge
    from gpubench.harness.record import Request
    from gpubench.reference import history

    pool = [adversarial.make({"k": 4, "batch": 10, "unsatisfiable": True}, seed) for seed in range(12)]
    requests = [Request(pool_index=i, start=0.0, prepared=0.0, end=0.0, outcome="illegal", checked_ops=1)
                for i in range(len(pool))]
    bad = requests[7]
    bad.outcome, bad.witness = "ok", [op.op_id for op in history.parse(pool[7])]
    numbers, judged, refused = judge(requests, pool, 2, 2**40 + 1)
    assert numbers == {"wrong": 1, "failed": 0} and judged == 3
    assert refused[0].startswith("request 7: OK, but the witness does not replay")
