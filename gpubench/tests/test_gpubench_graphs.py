"""The reader of the layer expansions replayed from CUDA graphs
(``harness/graphs.py``), on the CPU: it divides the segments'
``graph_layers`` by their layers, and reads nothing where the spans lack
the arg, as a program without the graphs has them."""

from __future__ import annotations

import pytest

from gpubench.harness import graphs, spans
from gpubench.harness.spec import load_cell
from gpubench.tests.test_gpubench_fencing import _run
from s2_verification_tpu_torch.obs.trace import Tracer

SEGMENTS = [
    {"layers": 10, "syncs": 30, "fetch_ms": 1.0, "sweeps": 12, "token_closes": 3, "captures": 0, "graph_layers": 0},
    {"layers": 30, "syncs": 70, "fetch_ms": 2.0, "sweeps": 33, "token_closes": 1, "captures": 1, "graph_layers": 21},
]


def test_the_cells_that_replay_read_the_metric():
    name = "graph_replays_per_layer.msn"
    (metric,) = [m for m in load_cell("msn.5x200").per_layer if m["name"] == name]
    assert (metric["unit"], metric["source"], metric["moves"]) == ("replays/layer", "program_span",
                                                                   "ops_verified_per_s")
    assert load_cell("msn.5x200").reader("metrics", name) is graphs.graph_replays_per_layer
    # fencing.8x500 replays too, but its per-layer metrics are pinned by its
    # own test, so it reads none of these yet.
    for cell in ("adv.k9-illegal", "adv.k10-ok", "fencing.8x500"):
        assert not [m for m in load_cell(cell).per_layer if m["name"].startswith("graph_replays_per_layer")]


def test_the_reader_divides_the_replayed_layers_by_the_segments_layers(monkeypatch):
    tracer = Tracer(64)
    run = _run(tracer, SEGMENTS)
    monkeypatch.setattr(spans, "_search_tracer", lambda: tracer)
    assert graphs.graph_replays_per_layer(run) == pytest.approx(21 / 40)


@pytest.mark.parametrize("case", ["program without the arg", "one segment without it", "dropped spans", "no ring"])
def test_the_reader_reads_nothing_without_its_arg(monkeypatch, case):
    tracer = Tracer(1 if case == "dropped spans" else 64)
    segments = [dict(s) for s in SEGMENTS]
    if case == "program without the arg":
        for s in segments:
            del s["captures"], s["graph_layers"]
    elif case == "one segment without it":
        del segments[0]["graph_layers"]
    run = _run(tracer, segments)
    monkeypatch.setattr(spans, "_search_tracer", lambda: None if case == "no ring" else tracer)
    assert graphs.graph_replays_per_layer(run) is None
