"""Where the GPU search spends its time, on one history.

    python -m s2_verification_tpu_torch.breakdown [--k 10] [--batch 100]
        [--seed 0] [--file H.jsonl] [--exhaustive] [--max-frontier N]
        [--device-rows N] [--prune] [--speculate-depth K] [--json OUT.json]

Decides ``adversarial_events(k, batch, seed)``, or the JSONL history at
``--file`` (e.g. one written by ``collect``), once to warm up and once
under ``torch.profiler``, on the first CUDA device, and prints:

- the card (name and power limit from nvidia-smi);
- wall seconds by phase, read from the check's own spans
  (``checker/device.py``, recorded into ``obs.trace.SEARCH_TRACER``):
  encode + tables, search layers (``run_search``), escalations, the spill,
  witness recovery, final-state fetch, ILLEGAL diagnostics, and the rest;
- device time by kernel (the top entries) and the device's busy share of
  the profiled wall time;
- the ten longest idle gaps of the profiled window, each named by the
  innermost span of the check that holds its midpoint (``Tracer.wall_ns``
  puts the spans on the profiler's clock);
- host synchronisations, fold-kernel launches, peak device memory, and
  kernels and syncs per layer.

``--exhaustive`` runs ``check_device(beam=False, max_frontier=N)``
(``--max-frontier``, 2^20 by default) instead of the default
``check_device_auto`` (beam first), which measures the exhaustive phase at
full width.  ``--device-rows N`` passes ``device_rows_cap=N`` to the
exhaustive search: above its ``--max-frontier`` bucket the frontier grows
on the device, each layer expanded in bucket-sized chunks (the chunked
layers are counted as ``chunked_layers``); e.g. ``--exhaustive
--max-frontier 131072 --device-rows 1048576`` at k=10.  ``--prune`` and ``--speculate-depth
K`` pass the same options to either entry (the dive's expansions do not
count as layers of the window below).  A search that expands more
than :data:`WHOLE_MAX_LAYERS` layers (a collected history's thousands)
is profiled over only :data:`WINDOW_LAYERS` whole layers from its middle,
the rest of the call unprofiled: the profiler's own processing of over a
million launches takes longer than the search.  Needs a CUDA device.

The profiled wall includes the profiler's own cost, so it is for phase
shares only; ``chip_smoke.py`` times a plain warm call.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from collections import Counter

import torch

from .checker import device as dev_mod
from .checker.entries import prepare
from .checker.profile import accel_counters
from .collector.adversarial import adversarial_events
from .obs.trace import SEARCH_TRACER
from .ops import fold_cuda
from .utils import events as ev

#: each ``phases_s`` key, and the span of ``check_device`` it sums
PHASE_SPANS = {
    "encode_and_tables": "check.encode",
    "search_layers": "check.segment",
    "escalate": "check.escalate",
    "spill": "check.spill",
    "witness_recovery": "check.witness",
    "final_states": "check.final_states",
    "diagnose": "check.diagnose",
}


def search_spans(lo_ns: int, hi_ns: int, tracer=SEARCH_TRACER) -> list[tuple[int, int, str]]:
    """The check's spans that lie inside ``[lo_ns, hi_ns]`` (epoch
    nanoseconds), as ``(start, end, name)``."""
    out = []
    for e in tracer.export()["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "search":
            a, b = tracer.wall_ns(e)
            if lo_ns <= a and b <= hi_ns:
                out.append((a, b, e["name"]))
    return out


def _on_device(e) -> bool:
    """A profiler event that is a device operation (a kernel, copy or set),
    not a range annotated on the device's timeline."""
    return e.device_type() == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", lambda: False)()


def idle_gaps(events, lo_ns: int, hi_ns: int, spans, n: int = 10) -> list[list]:
    """The ``n`` longest stretches of ``[lo_ns, hi_ns]`` in which no device
    operation of the profiler's ``events`` ran, longest first, each as
    ``[the innermost of spans holding its midpoint, seconds]``."""
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events if _on_device(e))
    gaps, cursor = [], lo_ns
    for a, b in ops:
        a, b = max(a, lo_ns), min(b, hi_ns)
        if b <= cursor:
            continue
        if a > cursor:
            gaps.append((a - cursor, cursor))
        cursor = b
    if hi_ns > cursor:
        gaps.append((hi_ns - cursor, cursor))
    out = []
    for length, at in sorted(gaps, reverse=True)[:n]:
        mid = at + length // 2
        holding = [(b - a, name) for a, b, name in spans if a <= mid < b]
        out.append([min(holding)[1] if holding else "outside the check", length / 1e9])
    return out


def _device_times(prof) -> tuple[dict[str, float], int]:
    """Self device time (ms) by CUDA kernel name, and the number of kernels."""
    out: dict[str, float] = {}
    n = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us:
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3
            n += evt.count
    return out, n


@contextlib.contextmanager
def expanded_layers(on_layer):
    """Call ``on_layer(name)`` before each layer the search expands: eagerly
    or replayed from its CUDA graph (``name`` is ``expand``, for
    ``_LayerGraph.expand``), or in chunks (``_expand_layer_chunked``); a
    forced step or a speculative dive's layer calls neither."""
    owners = ((dev_mod._LayerGraph, "expand"), (dev_mod, "_expand_layer_chunked"))
    real = [getattr(o, name) for o, name in owners]

    def counted(fn, name):
        def wrapper(*a, **kw):
            on_layer(name)
            return fn(*a, **kw)

        return wrapper

    for (o, name), fn in zip(owners, real):
        setattr(o, name, counted(fn, name))
    try:
        yield
    finally:
        for (o, name), fn in zip(owners, real):
            setattr(o, name, fn)


def profiled_window(start: int, n: int, box: dict):
    """An ``on_layer`` for :func:`expanded_layers`: profile from the
    search's layer ``start`` to its layer ``start + n``, i.e. ``n`` whole
    layers of the search loop, and keep the profiler, the window's wall
    and its host syncs in ``box``."""
    calls = [0]

    def on_layer(_name):
        i = calls[0]
        calls[0] += 1
        if i in (start, start + n):
            torch.cuda.synchronize()
            if i == start:
                box["prof"] = torch.profiler.profile(activities=_ACTIVITIES)
                box["prof"].__enter__()
                box["syncs0"], box["t0"], box["t0_ns"] = dev_mod.SYNCS[0], time.perf_counter(), time.time_ns()
            else:
                box["wall"] = time.perf_counter() - box["t0"]
                box["t1_ns"] = time.time_ns()
                box["syncs"] = dev_mod.SYNCS[0] - box["syncs0"]
                box["prof"].__exit__(None, None, None)

    return on_layer


_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
WHOLE_MAX_LAYERS = 1000
WINDOW_LAYERS = 200


def busy(prof, wall: float) -> dict:
    dev_ms, kernels = _device_times(prof)
    busy_ms = sum(dev_ms.values())
    return {
        "kernels": kernels,
        "device_busy_ms": round(busy_ms, 3),
        "device_busy_share": round(busy_ms / 1e3 / wall, 4) if wall else None,
        "top_kernels_ms": dict(
            sorted(((k_, round(v, 3)) for k_, v in dev_ms.items()), key=lambda kv: -kv[1])[:15]
        ),
    }


def run(
    k: int,
    batch: int,
    seed: int,
    exhaustive: bool,
    file: str | None = None,
    prune: bool = False,
    speculate_depth: int = 0,
    max_frontier: int = 1 << 20,
    device_rows: int | None = None,
) -> dict:
    if file:
        hist, name = prepare(ev.read_history(file)), file
    else:
        hist = prepare(adversarial_events(k, batch=batch, seed=seed))
        name = f"adversarial k={k} batch={batch} seed={seed}"

    opts = dict(collect_stats=True, prune=prune, speculate_depth=speculate_depth)
    if device_rows is not None:
        opts["device_rows_cap"] = device_rows

    def decide():
        if exhaustive:
            return dev_mod.check_device(hist, max_frontier=max_frontier, beam=False, **opts)
        return dev_mod.check_device_auto(hist, **opts)

    fold_cuda.build()
    # warm-up (allocator, kernel load), counting the expanded layers and
    # the chunked ones among them
    layer_calls: Counter = Counter()
    with expanded_layers(lambda name: layer_calls.update((name,))):
        decide()

    box: dict = {}
    n_layers = sum(layer_calls.values())
    window = WINDOW_LAYERS if n_layers > WHOLE_MAX_LAYERS else None
    if window:
        start = (n_layers - window) // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fold_cuda.reset_launches()
    syncs0 = dev_mod.SYNCS[0]
    with expanded_layers(profiled_window(start, window, box)) if window else torch.profiler.profile(
        activities=_ACTIVITIES
    ) as prof:
        t0, t0_ns = time.perf_counter(), time.time_ns()
        res = decide()
        torch.cuda.synchronize()
        wall, t1_ns = time.perf_counter() - t0, time.time_ns()
    st = res.stats
    spans = search_spans(t0_ns, t1_ns)
    phases = {
        key: round(sum(b - a for a, b, name in spans if name == span) / 1e9, 6) for key, span in PHASE_SPANS.items()
    }
    phases["other"] = round(wall - sum(phases.values()), 6)
    out = {
        "history": name,
        "entry": (
            f"check_device(beam=False, max_frontier={max_frontier}, device_rows_cap={device_rows or 0})"
            if exhaustive
            else "check_device_auto" + ("" if device_rows is None else f"(device_rows_cap={device_rows})")
        ),
        "prune": prune,
        "speculate_depth": speculate_depth,
        "outcome": res.outcome.value,
        "wall_s": round(wall, 6),
        "phases_s": phases,
        "layers": st.layers,
        "max_frontier": st.max_frontier,
        "expanded": st.expanded,
        "pruned": st.pruned,
        **accel_counters(st),
        "host_syncs": dev_mod.SYNCS[0] - syncs0,
        "fold_launches": fold_cuda.LAUNCHES["fold_lanes"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "chunked_layers": layer_calls["_expand_layer_chunked"],
        "host_syncs_per_layer": round((dev_mod.SYNCS[0] - syncs0) / max(st.layers, 1), 3),
    }
    if not window:
        b = busy(prof, wall)
        gaps = idle_gaps(prof.profiler.kineto_results.events(), t0_ns, t1_ns, spans)
        return {**out, **b, "kernels_per_layer": round(b["kernels"] / max(st.layers, 1), 1), "idle_gaps": gaps}
    out["window"] = {
        "layers": [start, start + window],
        "wall_s": round(box["wall"], 6),
        "host_syncs": box["syncs"],
        **busy(box["prof"], box["wall"]),
        "idle_gaps": idle_gaps(box["prof"].profiler.kineto_results.events(), box["t0_ns"], box["t1_ns"], spans),
    }
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m s2_verification_tpu_torch.breakdown")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--file", default=None, help="decide this JSONL history instead")
    p.add_argument("--exhaustive", action="store_true")
    p.add_argument("--max-frontier", type=int, default=1 << 20, metavar="N",
                   help="the exhaustive search's expansion bucket (with --exhaustive; default 2^20)")
    p.add_argument("--device-rows", type=int, default=None, metavar="N",
                   help="device-resident frontier cap of the exhaustive search (device_rows_cap)")
    p.add_argument("--prune", action="store_true", help="the verdict-exact prunes (checker/prune.py)")
    p.add_argument("--speculate-depth", type=int, default=0, metavar="K",
                   help="one K-layer speculative dive per search segment (0 = off)")
    p.add_argument("--json", default=None, help="also write the result here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    out = {
        "card": card,
        **run(args.k, args.batch, args.seed, args.exhaustive, args.file,
              prune=args.prune, speculate_depth=args.speculate_depth,
              max_frontier=args.max_frontier, device_rows=args.device_rows),
    }
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
