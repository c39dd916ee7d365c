"""The fencing cell on the CPU: its configuration and traffic, its
generator's histories, the two readers of the auto-close's counters
(``harness/closes.py``), and a small run end to end, whose check comes out
false for a broken answer and for the reference at 32 bits."""

from __future__ import annotations

import json
import time

import pytest

from gpubench import control
from gpubench.harness import closes, spans
from gpubench.harness.judge import judge, judge_one
from gpubench.harness.record import Request, Run
from gpubench.harness.result import execute
from gpubench.harness.spec import load_cell
from gpubench.harness.window import make_pool
from gpubench.tests.test_gpubench_harness import _altered, _drop, _flip, _swap
from s2_verification_tpu_torch.checker import device as dev_mod
from s2_verification_tpu_torch.checker.device import check_device_auto
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.obs.trace import Tracer
from s2_verification_tpu_torch.utils import events as ev

CELL = "fencing.8x500"


def small_cell():
    """The cell at 8 clients of 120 ops, each fencing at ops 0 and 100, with
    a pool of 2 and a warm-up of 8x20."""
    cell = load_cell(CELL)
    cell.traffic["params"] = {**cell.traffic["params"], "num_ops_per_client": 120}
    cell.traffic["warmup"] = {"num_ops_per_client": 20}
    cell.traffic["pool"] = 2
    return cell


def run_small() -> dict:
    return execute(small_cell(), 2**40 + 9, 0.5, False, time.perf_counter(), device="cpu")


def test_the_cell_merges_its_configuration_with_the_collected_mix():
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["generator"] == "collect" and cell.traffic["pool"] == 16
    p = cell.params()
    assert (p["workflow"], p["num_concurrent_clients"], p["num_ops_per_client"], p["max_client_ids"]) == (
        "fencing", 8, 500, 20)
    assert p["faults"]["p_append_indefinite"] == pytest.approx(12 / (8 * 500))
    assert p["structure_seed"] == 20261018
    assert cell.config["reduced"] == [] and "fencing_token" in cell.config["shapes"]
    assert {m["name"] for m in cell.end_to_end} == {"ops_verified_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"close_sweeps_per_layer.fence", "token_closes_per_layer.fence"}


def _shape(text: str) -> list:
    """A history with its hashes left out."""
    out = []
    for line in text.splitlines():
        rec = json.loads(line)
        body = rec["event"].get("Start") or rec["event"].get("Finish")
        if isinstance(body, dict):
            (name, fields), = body.items()
            body = {name: {k: v for k, v in fields.items() if k not in ("record_hashes", "stream_hash")}}
        out.append((body, rec["client_id"], rec["op_id"]))
    return out


def test_a_fencing_history_keeps_its_structure_and_draws_new_hashes():
    cell = load_cell(CELL)
    params = cell.params(num_ops_per_client=120)
    a, b = cell.make(params, 5, 0), cell.make(params, 2**33 + 1, 0)
    assert a != b and _shape(a) == _shape(b)
    assert any('"set_fencing_token":"' in line for line in a.splitlines())
    for text in (a, b):
        hist = prepare(list(ev.iter_history(text)), elide_trivial=True)
        res = check_device_auto(hist, device="cpu")
        assert res.ok
        # The fences' command records carry the drawn hashes too: the
        # reference judges the port's witness sound.
        assert judge_one(text, "ok", [hist.ops[i].op_id for i in res.linearization]) == ""


def _run(tracer: Tracer, segments: list[dict], traced: bool = False) -> Run:
    """One request decided from 1.0 s to 1.2 s after the tracer's base,
    holding one ``check.segment`` span a dict of ``segments``."""
    base = tracer.mono_of_wall(tracer.wall_base)
    for k, args in enumerate(segments):
        tracer.add_span("check.segment", base + 1.0 + 0.01 * k, base + 1.005 + 0.01 * k, cat="search", args=args)
    ns = tuple(tracer.wall_base_ns + round(t * 1e9) for t in (0.999, 1.0, 1.2))
    request = Request(pool_index=0, start=0.0, prepared=0.0, end=1.0, outcome="ok", checked_ops=1,
                      traced=traced, spans_ns=ns)
    return Run(setup_s=0.0, window_s=1.0, requests=[request], peak_bytes=0)


SEGMENTS = [
    {"layers": 10, "syncs": 30, "fetch_ms": 1.0, "sweeps": 12, "token_closes": 3},
    {"layers": 30, "syncs": 70, "fetch_ms": 2.0, "sweeps": 33, "token_closes": 1},
]


def test_the_readers_divide_the_segments_counts_by_their_layers(monkeypatch):
    tracer = Tracer(64)
    run = _run(tracer, SEGMENTS)
    monkeypatch.setattr(spans, "_search_tracer", lambda: tracer)
    assert closes.close_sweeps_per_layer(run) == pytest.approx(45 / 40)
    assert closes.token_closes_per_layer(run) == pytest.approx(4 / 40)


@pytest.mark.parametrize("case", ["program without the args", "dropped spans", "no ring"])
def test_the_readers_read_nothing_without_their_args(monkeypatch, case):
    tracer = Tracer(1 if case == "dropped spans" else 64)
    segments = [{k: v for k, v in s.items() if k not in ("sweeps", "token_closes")} for s in SEGMENTS]
    run = _run(tracer, SEGMENTS if case == "dropped spans" else segments)
    monkeypatch.setattr(spans, "_search_tracer", lambda: None if case == "no ring" else tracer)
    assert closes.close_sweeps_per_layer(run) is None
    assert closes.token_closes_per_layer(run) is None


def test_a_small_run_is_correct():
    out = run_small()
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0, out
    assert set(out["metrics"]) == {"ops_verified_per_s", "setup_s"}


@pytest.mark.parametrize("alter", [_flip, _swap, _drop], ids=["flip", "swap", "drop"])
def test_a_broken_answer_is_not_correct(monkeypatch, alter):
    monkeypatch.setattr(dev_mod, "check_device_auto", _altered(alter))
    out = run_small()
    assert not out["correct"] and out["checks"]["wrong"]["value"] >= 1


@pytest.mark.parametrize("precision,wrong", [("carry32", 2), (None, 0)])
def test_the_control_is_not_correct_at_32_bits(precision, wrong):
    cell = small_cell()
    pool = make_pool(cell, 21)
    requests = control.control_requests(pool, 2, **control.PRECISIONS.get(precision, {}))
    assert judge(requests, pool, "all", 21)[0] == {"wrong": wrong, "failed": 0}
