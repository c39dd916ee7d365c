"""What a cell is made of, found by name.

``BENCHMARK.json`` names the cell's configuration, traffic mix and
metrics; each lives in a file of its own under the benchmark's folder:

- a configuration: the file ``BENCHMARK.json`` gives it (its generator
  parameters under ``params``);
- a traffic mix: ``traffic/<traffic>.json`` (its generator, parameters,
  pool, warm-up, how many ILLEGAL verdicts are judged, and traced requests);
- a generator: ``gen/<generator>.py``, with ``make(params, seed, index)``;
- an end-to-end metric: ``e2e/<metric>.py``, a per-layer metric:
  ``metrics/<metric>.py``, each with ``read(run)``.

So a later cell, mix or metric is added as files and entries, with no
edit to the harness.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell"]

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: the end-to-end and per-layer entries of BENCHMARK.json this cell
    #: reports
    end_to_end: list
    per_layer: list
    bench_dir: Path
    _modules: dict = field(default_factory=dict, repr=False)

    def params(self, **override) -> dict:
        """The generator's parameters: the configuration's, then the
        traffic mix's, then ``override``."""
        return {**self.config["params"], **self.traffic.get("params", {}), **override}

    def make(self, params: dict, seed: int, index) -> str:
        """History ``index`` of a pool, as JSONL, from the traffic mix's
        generator."""
        gen = self.traffic["generator"]
        if gen not in self._modules:
            self._modules[gen] = _module(self.bench_dir / "gen" / f"{gen}.py", f"gpubench.gen.{gen}")
        return self._modules[gen].make(params, seed, index)

    def reader(self, kind: str, metric: str):
        """``read`` of ``<kind>/<metric>.py``, ``kind`` being ``e2e`` or
        ``metrics`` (a metric's name may hold dots, so files load by path)."""
        path = self.bench_dir / kind / f"{metric}.py"
        return _module(path, f"gpubench.{kind}.{metric.replace('.', '_')}").read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, whose benchmark folder
    is the first of its ``paths``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    bench_dir = root / spec["paths"][0]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        name=name,
        chips=w["chips"],
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir,
    )
