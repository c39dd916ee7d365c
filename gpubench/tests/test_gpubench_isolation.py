"""What the benchmark loads: nothing of JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
a reference that loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "s2_verification_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*dirs: str):
    for d in dirs:
        yield from sorted((BENCH / d).rglob("*.py") if d else BENCH.glob("*.py"))


@pytest.mark.parametrize("path", list(_sources("", "harness", "gen", "reference", "roofline", "e2e", "metrics")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", list(_sources("reference", "gen")), ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_and_generators_import_nothing_of_the_program(path):
    assert "s2_verification_tpu_torch" not in _imports(path)


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run on the CPU (the harness, the port, the reference and
    every reader), in a process of its own."""
    code = (
        "import json, sys, time; sys.path.insert(0, '.')\n"
        "import gpubench.run\n"
        "from gpubench.tests.test_gpubench_harness import small_cell\n"
        "from gpubench.harness.result import execute\n"
        "assert execute(small_cell('adv.k10-ok'), 3, 0.3, False, time.perf_counter(), device='cpu')['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    loaded = _loaded(code)
    assert "s2_verification_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys; sys.path.insert(0, '.')\n"
        "from gpubench.reference import history, model, search, witness, xxh3\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    loaded = _loaded(code)
    assert not loaded & (FORBIDDEN | {"s2_verification_tpu_torch", "torch"})
