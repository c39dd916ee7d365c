"""Short runs of each cell on the card, through the benchmark's command
(``BENCHMARK.json``).  They skip where there is no CUDA device; on the chip:
``python3 -m pytest gpubench/tests/test_gpubench_chip.py``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")


def _run(cell: str, trace: int) -> dict:
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed", str(2**33 + 17),
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, cell, trace):
    res = _run(cell, trace)
    assert res["correct"] and res["failed"] == 0 and list(res)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in SPEC[kind] if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name, m in res["metrics"].items():
            assert not name.startswith("fold_roofline.") or 0 < m["value"] <= 100
