"""The control: the reference in the program's place at 32-bit hash
precision comes out not correct, where the 64-bit reference in the same
place comes out correct."""

from __future__ import annotations

import pytest

from gpubench import control
from gpubench.harness.judge import judge
from gpubench.harness.window import make_pool
from gpubench.tests.test_gpubench_harness import small_cell


def _numbers(name: str, precision: str | None, n: int = 2) -> dict:
    cell = small_cell(name)
    pool = make_pool(cell, 21)
    requests = control.control_requests(pool, n, **control.PRECISIONS.get(precision, {}))
    return judge(requests, pool, "all", 21)[0]


@pytest.mark.parametrize("name,precision", [("adv.k9-illegal", "compare32"), ("adv.k10-ok", "carry32"), ("msn.5x200", "carry32")])
def test_the_control_is_not_correct(name, precision):
    numbers = _numbers(name, precision)
    assert numbers["wrong"] == 2 and numbers["failed"] == 0


@pytest.mark.parametrize("name", ["adv.k9-illegal", "adv.k10-ok", "msn.5x200"])
def test_the_reference_in_the_programs_place_is_correct(name):
    assert _numbers(name, None) == {"wrong": 0, "failed": 0}
