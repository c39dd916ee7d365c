"""The fold's work count: the recorder's steps per call equal
``foldbench``'s for the same calls, and the bound's arithmetic."""

from __future__ import annotations

import pytest

from gpubench.harness.trace import FoldRecorder
from gpubench.reference import history
from gpubench.gen import adversarial
from gpubench.roofline import fold
from s2_verification_tpu_torch import foldbench
from s2_verification_tpu_torch.checker import device as dev_mod
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.utils import events as ev

H100 = fold.PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("k,unsat", [(5, False), (6, True)])
def test_recorded_steps_equal_foldbenchs(k, unsat):
    text = adversarial.make({"k": k, "batch": 30, "unsatisfiable": unsat}, 3)
    hist = prepare(list(ev.iter_history(text)))
    with foldbench.recording_folds(dev_mod) as calls:
        recorder = FoldRecorder(dev_mod)
        recorder.active = True
        try:
            dev_mod.check_device_auto(hist, device="cpu")
        finally:
            recorder.close()
    assert len(calls) == len(recorder.calls) > 0
    want = [foldbench.call_stats(c[2], int(c[3].shape[1]))["steps"] for c in calls]
    assert recorder.steps() == want
    assert [(int(c[2].numel()), int(c[3].shape[0]), int(c[3].shape[1])) for c in calls] == recorder.calls


def test_a_step_is_a_quarter_of_an_sm_clock():
    assert sum(fold.STEP_OPS.values()) == 25
    assert fold.clocks_per_step(H100) == 0.25


def test_the_larger_bound_holds():
    hz = H100["max_sm_mhz"] * 1e6
    ops_s, by = fold.call_bound_s(10**9, 10**6, 16, 112, H100)
    assert by == "operations" and ops_s == pytest.approx(10**9 * 0.25 / (132 * hz))
    bytes_s, by = fold.call_bound_s(1, 10**6, 4096, 128, H100)
    assert by == "bytes" and bytes_s == pytest.approx((32 * 10**6 + 8 * 4096 * 128) / 3.35e12)
