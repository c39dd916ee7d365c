"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives s2_verification_tpu_torch (never the JAX package) and exits nonzero
on the first failed phase:

1. the card's name and power limit (nvidia-smi);
2. the build of every CUDA kernel of the main path from ``csrc/``, with
   each kernel's registers and the fold blocks resident per SM, and the
   fold's per-step instruction counts by pipe, read from its SASS
   (``cuobjdump``) and printed beside the fixed per-step costs the bound
   takes (``foldbench.STEP_INSTRUCTIONS``);
3. each kernel against its plain PyTorch version, bit-exact: the fold on
   2^20 random lanes (a table that fits shared memory and one that does
   not) with its times, on the edge cases of ``foldbench.edge_cases``
   (sparse lanes at the front, none active, one lane, 33 lanes, clamped
   lengths, a large table), and one lane of length 100 timed;
4. the main path through the CLI in process — ``check -backend=device
   -stats`` of the adversarial history k=10, batch=100, seed 0 — which must
   exit 0 (OK) with a witness that replays through the port's step_set;
   launch counts are reset just before and read just after it, and every
   fold call it makes is recorded; then three warm ``check_device_auto``
   calls on the same history; then each recorded fold call again, bit-exact
   against the plain fold and timed beside its bound (with its lanes,
   active lanes, steps and one-thread-per-lane warp efficiency), their
   sums, and the largest call by steps and the first call with the most
   lanes against the plain fold's time; and the same history through the
   exhaustive phase alone (beam off, 2^20-row bucket);
5. the unsatisfiable k=8 history must exit 1 (ILLEGAL);
6. the device verdicts of k=6 (OK and unsatisfiable) must equal the port's
   CPU oracle;
7. the collector path, with the port's collector only: the five
   ``scripts/table_bench.py`` configurations at seed 4242 with the fault
   plan of ``bench.py:395-400`` (copied here: ``bench.py`` imports JAX),
   each collected, timed and decided on the card, the four small ones
   equal to the port's CPU oracle, with both replay checks refusing their
   witness once a real-time pair is swapped
   (:func:`swap_real_time_pair`); then the 5×2000 ``match-seq-num``
   headline at seed 20260729, whose JSONL must hash to
   :data:`HEADLINE_SHA256`, through the CLI in process (``check
   -backend=device -stats``, launch counts reset just before and read just
   after, every fold call recorded), which must exit 0 with a witness that
   replays (:func:`replay_fast`) and the search statistics of
   :data:`HEADLINE_STATS`; one warm ``check_device_auto`` call; every
   recorded fold call again, bit-exact against the plain fold, with their
   total device and per-call time beside the summed bound, and the largest
   by steps measured alone;
8. prune and speculation (``checker/prune.py``, ``device._spec_dive``):
   adversarial k=10, batch=100, seed 0 through ``check_device(beam=False,
   prune=True, speculate_depth=3)`` at the configuration of the JAX
   package's ``scripts/prune_check.py`` (2^21-row cap, 2^14-row first
   bucket), which must be OK with a replaying witness and the search
   statistics of :data:`PRUNED_ADV_STATS`, timed three times warm with its
   peak memory; the 5×2000 headline through the CLI with ``--prune
   --speculate-depth 3`` (launch counts reset just before and read just
   after), with the statistics of :data:`PRUNED_HEADLINE_STATS`, its host
   syncs, first and warm walls, and the kernels per layer of a
   profiled 100-layer window; every fold call of both, bit-exact against
   the plain fold and timed; then the port's campaign matrix
   (``collector/campaign.py``: five legal fault shapes, four violation
   classes, seed 11), each history decided pruned with
   ``speculate_depth=3`` and un-pruned, which must agree with each other
   and, where conclusive, with the campaign's label;
9. the chunked device-resident tier (``device._expand_layer_chunked``):
   adversarial k=10, batch=100, seed 0 through ``check_device(beam=False,
   max_frontier=2**17, device_rows_cap=2**20)``, plain and with
   ``prune=True, speculate_depth=3``, each with the JAX engine's search
   statistics (:data:`TIER_K10_STATS`, :data:`TIER_K10_PRUNED_STATS`) and a
   replaying witness, launch counts reset just before each run and read
   just after it, every fold call of both bit-exact against the plain
   fold, three warm calls of the plain run with their peak memory, and the
   in-core run at a 2^20-row bucket with sort dedup and with the probe
   table beside it, each with its fold launches;
   adversarial k=12, batch=100, seed 0 at the JAX record's configuration
   (``max_frontier=2**21, device_rows_cap=2**24``), which must be OK with
   a replaying witness and peak at :data:`K12_PEAK` rows, with its wall,
   the witness recovery's share, peak memory, the chunks of each chunked
   layer, and its largest fold call by steps bit-exact against the plain
   fold and timed beside its bound; the unsatisfiable k=8 history through
   the tier (:data:`TIER_K8_UNSAT_STATS`), ILLEGAL with refusal reports and
   every fold call bit-exact; and the unsatisfiable k=9 through the tier in
   2^17-row chunks (:data:`TIER_K9_UNSAT_STATS`), whose widest layers
   expand several live chunks and compact across them, ILLEGAL with its
   chunks and compactions per layer, wall, peak memory and every fold call
   bit-exact;
10. the host-RAM spill and checkpoints (``device._spill_search``,
   ``checker/checkpoint.py``), each run timed on its first call and warm
   (but (b)),
   with its streamed layers, slabs per streamed layer, slab halvings and
   hybrid in-core segments, host syncs, seconds in ``_dedup_rows``, peak
   device memory and the host's peak RSS, and its fold calls bit-exact
   against the plain fold: (a) the unsatisfiable k=8 through the tier into
   the spill (2^10-row bucket, 2^16-row cap), ILLEGAL with refusal reports;
   (b) the unsatisfiable k=9 at a 2^17-row bucket straight into the spill
   and through a 2^20-row tier into it, first calls only; (c) adversarial k=10 at a
   2^18-row bucket into the spill, OK with a replaying witness and the
   in-core run's final states; (d) the unsatisfiable k=10 (9,864,101
   rows at its widest layer) through the device backend's defaults — ``check
   -backend=device -stats``, no cap flags — which must exit 1 with the JAX
   record's statistics (:data:`SPILL_K10_UNSAT_STATS`), its largest fold
   call bit-exact and timed beside its bound; (e) (b) preempted mid-spill
   and resumed from ``<path>.spill.npz``, and the k=10 tier run with
   ``checkpoint_every=2`` preempted after its first escalation and
   resumed, each to the uninterrupted run's verdict and statistics with
   the snapshot gone; counts pinned from the JAX engine;
11. the ``check`` command as a user types it: (a) the per-layer witness
   log on the card — the four small histories of phase 7 through
   ``check_device(witness_max_frontier=4096)`` on the card and on the CPU,
   with equal linearizations that replay, and adversarial k=10, batch=100,
   seed 0 at a 2^20-row bucket with the log kept to 2^20 rows, OK with the
   JAX engine's statistics and linearization (:data:`K10_WITNESS_STATS`,
   :data:`K10_WITNESS_SHA256`), first and warm walls, peak memory, and every
   fold call bit-exact against the plain fold; (b) the native C++ engine,
   built from ``csrc/s2check.cpp`` into ``_build/``, with the card's
   verdicts (from phase 7) on phase 7's five collector histories; (c) the default ``auto`` ladder:
   the headline through ``check -stats`` with no ``-backend`` (exit 0, no
   fold launch: decided on the native rung) and adversarial k=10 through
   ``check -time-budget 2 -stats`` (exit 0, the native rung concedes and
   the card decides), each with its wall; (d) corpus mode over a directory
   of the four small histories and the unsatisfiable k=6 (exit 1, one line
   a file); (e) the HTML visualization of an OK and an ILLEGAL history, the
   ILLEGAL one naming its refused ops; (f) the phase's seconds;
12. batched lanes (``checker/batched.py`` over ``device.run_search_lanes``):
   (a) one launch group of 16 lanes of the 5×2000 ``match-seq-num`` shape
   (phase 7's headline and :data:`BATCH_SEEDS` with :func:`bench_faults`)
   through ``check_batch_vmap`` on the card, every lane OK, the headline
   lane's layers equal to its ``run_search`` alone at the lanes' capacity,
   with the group's first and warm walls, loop iterations, host syncs and
   fold launches per iteration and peak memory beside the lane alone and
   phase 7's ``-backend=device`` walls; (b) the campaign matrix (seed 11)
   in one launch, each decided lane equal to its label and an undecided one
   only where it pruned; (c) ``check_batch_native`` over the same lanes
   equal to ``check_native`` lane by lane, and every lane the card decided
   equal to the native verdict; (d) every fold call of (a)'s first launch
   and of (b) bit-exact against the plain fold, and the largest measured;
13. the frontier sharded over a mesh (``parallel/distributed.py``,
   ``device.place_frontier``, ``check_device(mesh=)``): (a) adversarial
   k=10, batch=100, seed 0, beam off, in a 2^19-row bucket (410,971 rows at
   its peak) unsharded, over 2 and 4 shards on one card and, where there
   are several cards, one shard a card — each OK with the JAX engine's
   statistics (:data:`TIER_K10_STATS`), final frontier arrays and witness
   equal to the unsharded run's, first and warm walls, host syncs and fold
   launches a layer, bytes moved between shards, ``stats.shards`` and peak
   memory; (b) the same history in a 2^18-row bucket through the spill over
   2 shards, preempted after two segments (:func:`preempting`) and resumed
   over 4: OK with the same statistics, both snapshots spent; (c) a process
   group of one NCCL rank holding 2 shards: ``run_search`` SPMD on
   adversarial k=4, batch=3, seed 5, ACCEPT after the one-process run's
   layers with its frontier; (d) every fold call of (a)–(c) bit-exact
   against the plain fold;
14. the kernel list, one JSON line of kernel measurements, and as the last
   line ``{"ok": true, "device": {...}}``.

Fold times are per call, from CUDA events: ``call`` with back-to-back
calls from Python (host cost included; the median of five timings), and
``device`` with the calls queued behind a spin kernel (the device's own
time for both kernels of a call), and ``host``, the host's time to
enqueue a call meanwhile.  The kernels line gives ``call`` as
``ms`` and ``device`` as ``device_ms``; the plain fold, thousands of small
kernels a call, is timed per call.  The bound is
``foldbench.fold_bound_ms``.

Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import socket
import sys
import tempfile
import threading
import time

import numpy as np
import torch

#: sha256 of the JSONL (``utils/events.write_history``) of the 5×2000
#: match-seq-num history at seed 20260729 with :func:`bench_faults`: what
#: the JAX package's collector (``s2_verification_tpu.collector``, with the
#: C ``xxhash``) writes for ``bench.py:476``'s ``make_bench_history``, and
#: what the port's collector writes (``tests/test_torch_collector.py`` holds
#: the two collectors byte for byte).
HEADLINE_SHA256 = "8a3594230bdb13cefad1e8d77c4d2ebd76671196f9ff003d26e8b363d2f6a4c4"
#: The headline's search statistics from the port's ``check_device_auto(...,
#: device="cpu")``, which the JAX engine's match (layers, peak frontier,
#: expanded).
HEADLINE_STATS = {"layers": 2885, "max_frontier": 3, "expanded": 5785}
#: The search statistics of the JAX engine (``s2_verification_tpu``'s
#: ``check_device``, XLA:CPU) on adversarial k=10, batch=100, seed 0 with
#: ``max_frontier=2**21, start_frontier=2**14, beam=False, witness=False,
#: prune=True, speculate_depth=3`` — ``scripts/prune_check.py``'s
#: configuration; the port's must equal them.
PRUNED_ADV_STATS = {
    "layers": 6, "max_frontier": 82152, "expanded": 113146, "auto_closed": 1,
    "prune_commits": 1, "prune_dead": 0,
    "spec_launches": 2, "spec_layers": 5, "spec_accepts": 0, "spec_rollbacks": 2,
}
#: The JAX engine's ``check_device_auto(prune=True, speculate_depth=3)`` on
#: the headline (XLA:CPU), which the port's must equal.
PRUNED_HEADLINE_STATS = {
    "layers": 936, "max_frontier": 3, "expanded": 1870, "auto_closed": 3888,
    "prune_commits": 3887, "prune_dead": 1,
    "spec_launches": 1, "spec_layers": 3, "spec_accepts": 0, "spec_rollbacks": 1,
}
#: The JAX engine's ``check_device`` (XLA:CPU) on adversarial k=10,
#: batch=100, seed 0 through its chunked tier: ``beam=False,
#: max_frontier=2**17, device_rows_cap=2**20`` (2^17-row chunks under a
#: frontier that peaks above 2^18 rows), plain and with ``prune=True,
#: speculate_depth=3``; the port's must equal them.
TIER_K10_STATS = {"layers": 7, "max_frontier": 410971, "expanded": 606058, "auto_closed": 0}
TIER_K10_PRUNED_STATS = {
    "layers": 6, "max_frontier": 82152, "expanded": 113146, "auto_closed": 1,
    "prune_commits": 1, "prune_dead": 0,
    "spec_launches": 6, "spec_layers": 17, "spec_accepts": 0, "spec_rollbacks": 6,
}
#: The JAX engine's ``check_device`` on the unsatisfiable k=8, batch=100,
#: seed 0 through the tier: ``beam=False, max_frontier=2**10,
#: device_rows_cap=TIER_K8_ROWS``, the smallest power of two that decides it
#: (at 2^16 rows the JAX engine concedes UNKNOWN).
TIER_K8_ROWS = 1 << 17
TIER_K8_UNSAT_STATS = {"layers": 9, "max_frontier": 109601, "expanded": 595456, "auto_closed": 0}
#: The JAX engine's ``check_device`` on the unsatisfiable k=9, batch=100,
#: seed 0 through the tier: ``beam=False, max_frontier=2**17,
#: device_rows_cap=TIER_K9_ROWS``, the smallest power of two that decides it
#: (at 2^20 rows the conservative fit test overflows and the JAX engine
#: concedes UNKNOWN).
TIER_K9_ROWS = 1 << 21
TIER_K9_UNSAT_STATS = {"layers": 10, "max_frontier": 986410, "expanded": 5361920, "auto_closed": 0}
#: The JAX engine's ``check_device(beam=False, spill=True)`` (XLA:CPU) on the
#: unsatisfiable k=8, batch=100, seed 0 at ``max_frontier=2**10,
#: device_rows_cap=2**16`` (the tier hands off to the spill): the counts of
#: :data:`TIER_K8_UNSAT_STATS`, in 1,073 one-layer slabs over 2 streamed
#: layers.
SPILL_K8_ROWS = 1 << 16
SPILL_K8_SLABS = 1073
#: The same engine on the unsatisfiable k=9 at ``max_frontier=2**17``:
#: :data:`TIER_K9_UNSAT_STATS` both straight into the spill
#: (``device_rows_cap=0``, the record
#: ``onchip_r5/host_baseline/unsat_k9_spill.k9u.json``; 95 slabs, 4 streamed
#: layers) and through a 2^20-row tier into it (78 slabs, 2 streamed
#: layers), where without the spill it concedes UNKNOWN.
SPILL_K9_SLABS = {0: 95, 1 << 20: 78}
#: The same engine on adversarial k=10 at ``max_frontier=2**18,
#: device_rows_cap=0`` (``onchip_r5/host_baseline/sat_k10_spill.k10.json``):
#: OK through one streamed layer.
SPILL_K10_STATS = {"layers": 7, "max_frontier": 410971, "expanded": 606058, "auto_closed": 0}
#: The JAX record of the unsatisfiable k=10, batch=100, seed 0 through the
#: spill (``onchip_r5/host_baseline/unsat_k10_spill.k10u.json``): ILLEGAL
#: after sweeping the whole space.
SPILL_K10_UNSAT_STATS = {"layers": 11, "max_frontier": 9864101, "expanded": 53625344}
#: The JAX engine's ``check_device`` (XLA:CPU) on adversarial k=10,
#: batch=100, seed 0 with ``beam=False, max_frontier=2**20,
#: witness_max_frontier=2**20``: the per-layer witness log on for the whole
#: search; its statistics, and the sha256 of its linearization written as
#: comma-separated ``History.ops`` indices.
K10_WITNESS_STATS = {"layers": 7, "max_frontier": 410971, "expanded": 606058, "auto_closed": 0}
K10_WITNESS_SHA256 = "ad837407208873feb3760587aa3e0dae08c661b0d0efe630b60a12b915addd97"
#: Peak frontier of adversarial k=12, batch=100, seed 0 (the JAX engine's
#: record, ``BASELINE.md``: a count of the search, not of the hardware).
K12_PEAK = 10_850_401
#: phase 13: the shard counts on one card, the in-bucket run's bucket (the
#: main path's k=10 peaks at 410,971 rows) and the sharded spill's
MESH_SHARDS = (2, 4)
MESH_BUCKET = 1 << 19
MESH_SPILL_BUCKET = 1 << 18
#: the campaign seed every builtin violation provably fires under
CAMPAIGN_SEED = 11
#: warm calls of the headline in phases 7 and 8, plain and pruned: one
#: each, for the script's time limit (phase 12 runs the headline's shape
#: for about 10,000 layers, twice)
HEADLINE_WARM_CALLS = 1
#: phase 12's launch group: lanes of the headline's shape, the headline
#: first and then one lane a seed of these (16 lanes, the daemon's default
#: ``--batch-max``)
BATCH_SHAPE = ("match-seq-num", 5, 2000)
BATCH_SEEDS = list(range(20260730, 20260745))
#: ``scripts/table_bench.py:27-33`` without the CPU-intractable 16×2000.
TABLE_CONFIGS = [
    ("regular", 2, 50),
    ("regular", 5, 100),
    ("match-seq-num", 5, 200),
    ("fencing", 8, 500),
    ("match-seq-num", 5, 2000),
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bench_faults(clients: int, ops: int):
    """The fault plan of ``bench.py:395-400`` (``make_bench_history``)."""
    from s2_verification_tpu_torch.collector.fake_s2 import FaultPlan

    return FaultPlan(
        p_append_definite=0.05,
        p_append_indefinite=12.0 / max(clients * ops, 1),
        p_read_fail=0.02,
        p_check_tail_fail=0.02,
    )


def replay_ok(hist, order) -> bool:
    """Witness check: every op once, real-time order kept, and a non-empty
    state set through the port's step_set at every step."""
    from s2_verification_tpu_torch.models.stream import INIT_STATE, step_set

    ops = hist.ops
    if sorted(order) != list(range(len(ops))):
        return False
    pos = {j: i for i, j in enumerate(order)}
    if any(pos[a.index] > pos[b.index] for a in ops for b in ops if a.ret < b.call):
        return False
    states = [INIT_STATE]
    for j in order:
        states = step_set(states, ops[j].inp, ops[j].out)
        if not states:
            return False
    return True


def replay_fast(hist, order) -> bool:
    """:func:`replay_ok` in O(n) of the order: an op placed after another
    must not have returned before that one was called, so at each position
    the earliest return among the ops placed later is compared with the
    call of the op placed there."""
    from s2_verification_tpu_torch.models.stream import INIT_STATE, step_set

    ops = hist.ops
    if sorted(order) != list(range(len(ops))):
        return False
    later_ret = float("inf")
    for j in reversed(order):
        if later_ret < ops[j].call:
            return False
        later_ret = min(later_ret, ops[j].ret)
    states = [INIT_STATE]
    for j in order:
        states = step_set(states, ops[j].inp, ops[j].out)
        if not states:
            return False
    return True


def swap_real_time_pair(hist, order) -> list[int] | None:
    """``order`` with its first adjacent pair that real time orders (the
    first op returned before the second was called) swapped: a witness that
    both replay checks must refuse.  None if no such pair is adjacent."""
    ops = hist.ops
    for i in range(len(order) - 1):
        if ops[order[i]].ret < ops[order[i + 1]].call:
            return order[:i] + [order[i + 1], order[i]] + order[i + 2 :]
    return None


@contextlib.contextmanager
def counting_chunks(dev_mod):
    """Count the chunked layers the search runs through ``dev_mod`` while
    inside, the chunks each one expands and the cross-chunk compactions it
    makes before its final one: ``{"layers": [(rows, chunks, compactions),
    ...]}``."""
    box: dict = {"layers": []}
    real = dev_mod._expand_layer_chunked, dev_mod._expand_slice, dev_mod._compact_children
    seen = {"slices": 0, "compactions": 0}

    def layer(tables, fr, **kw):
        before = dict(seen)
        out = real[0](tables, fr, **kw)
        box["layers"].append((fr.capacity, seen["slices"] - before["slices"],
                              seen["compactions"] - before["compactions"] - 1))
        return out

    def slice_(*a, **kw):
        seen["slices"] += 1
        return real[1](*a, **kw)

    def compact(*a, **kw):
        seen["compactions"] += 1
        return real[2](*a, **kw)

    dev_mod._expand_layer_chunked, dev_mod._expand_slice, dev_mod._compact_children = layer, slice_, compact
    try:
        yield box
    finally:
        dev_mod._expand_layer_chunked, dev_mod._expand_slice, dev_mod._compact_children = real


def run_tier_phase(dev_mod, fold_cuda, xxh3, fb, prepare, adversarial_events, k10_events,
                   recheck_calls, clocks, sm_hz, stats_of) -> dict:
    """Phase 9, the chunked device-resident tier; returns the fold's
    launches on its paths and its largest chunked call, measured."""
    out: dict = {"launches_by_path": {}}

    def gib(b):
        return f"{b / 2**30:.3f} GiB"

    # Adversarial k=10 through the tier: 2^17-row chunks.
    hist = prepare(k10_events)
    kw = dict(max_frontier=1 << 17, device_rows_cap=1 << 20, beam=False, collect_stats=True)
    with fb.recording_folds(dev_mod) as calls, counting_chunks(dev_mod) as chunks:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fold_cuda.reset_launches()
        syncs0 = dev_mod.SYNCS[0]
        t0 = time.monotonic()
        res = dev_mod.check_device(hist, **kw)
        torch.cuda.synchronize()
        first_wall = time.monotonic() - t0
        launches = dict(fold_cuda.LAUNCHES)
        syncs = dev_mod.SYNCS[0] - syncs0
        peak = torch.cuda.max_memory_allocated()
    if res.outcome.value != "ok" or not replay_ok(hist, res.linearization or []):
        fail(f"tier k=10: outcome {res.outcome}, or the witness does not replay")
    got = stats_of(res.stats, TIER_K10_STATS)
    if got != TIER_K10_STATS:
        fail(f"tier k=10 statistics {got}, the JAX engine's {TIER_K10_STATS}")
    if not chunks["layers"] or launches["fold_lanes"] == 0 or len(calls) != launches["fold_lanes"]:
        fail(f"tier k=10: {len(chunks['layers'])} chunked layers, {launches['fold_lanes']} fold "
             f"launches, {len(calls)} recorded")
    recheck_calls(calls, "tier k=10")
    del calls  # before the warm calls, whose peak memory is read
    warm = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res_w = dev_mod.check_device(hist, **kw)
        torch.cuda.synchronize()
        warm.append((time.monotonic() - t0, torch.cuda.max_memory_allocated()))
        if res_w.outcome.value != "ok" or stats_of(res_w.stats, TIER_K10_STATS) != TIER_K10_STATS:
            fail("a warm tier k=10 call differs from the first")
    print(
        f"tier k=10 (check_device beam off, 2^17-row chunks, device rows 2^20): OK, witness "
        f"replays; statistics == the JAX engine's {json.dumps(got)}; chunked layers (bucket rows, "
        f"chunks, compactions before the last) {chunks['layers']}; host syncs {syncs}, fold "
        f"launches {launches['fold_lanes']}; first call {first_wall:.3f} s, peak memory "
        f"{gib(peak)} (its fold calls recorded); warm "
        + ", ".join(f"{w:.3f} s ({gib(m)})" for w, m in warm),
        flush=True,
    )
    out["launches_by_path"]["adversarial k=10 through the chunked tier (2^17-row chunks)"] = launches["fold_lanes"]

    pkw = dict(kw, prune=True, speculate_depth=3)
    with fb.recording_folds(dev_mod) as calls, counting_chunks(dev_mod) as chunks:
        fold_cuda.reset_launches()
        res = dev_mod.check_device(hist, **pkw)
        pruned_launches = fold_cuda.LAUNCHES["fold_lanes"]
    got = stats_of(res.stats, TIER_K10_PRUNED_STATS)
    if res.outcome.value != "ok" or not replay_ok(hist, res.linearization or []):
        fail(f"pruned tier k=10: outcome {res.outcome}, or the witness does not replay")
    if got != TIER_K10_PRUNED_STATS:
        fail(f"pruned tier k=10 statistics {got}, the JAX engine's {TIER_K10_PRUNED_STATS}")
    t0 = time.monotonic()
    dev_mod.check_device(hist, **pkw)
    torch.cuda.synchronize()
    print(f"pruned tier k=10 (prune, speculate_depth=3): OK, witness replays; statistics == the JAX "
          f"engine's {json.dumps(got)}; chunked layers {chunks['layers']}; fold launches "
          f"{pruned_launches}; warm {time.monotonic() - t0:.3f} s", flush=True)
    if pruned_launches == 0 or not chunks["layers"] or len(calls) != pruned_launches:
        fail(f"pruned tier k=10: {len(chunks['layers'])} chunked layers, {pruned_launches} fold "
             f"launches, {len(calls)} recorded")
    recheck_calls(calls, "pruned tier k=10")
    del calls
    out["launches_by_path"]["adversarial k=10 through the tier, prune, speculate_depth=3"] = pruned_launches

    # The same history in core at a 2^20-row bucket: sort dedup against
    # the probe table, in turns, after one call of each.
    incore: dict = {True: [], False: []}
    for sd in (True, False, False, True, True, False, False, True):
        torch.cuda.reset_peak_memory_stats()
        fold_cuda.reset_launches()
        t0 = time.monotonic()
        res = dev_mod.check_device(hist, max_frontier=1 << 20, beam=False, collect_stats=True, sort_dedup=sd)
        torch.cuda.synchronize()
        incore[sd].append((time.monotonic() - t0, torch.cuda.max_memory_allocated(), res.stats,
                           fold_cuda.LAUNCHES["fold_lanes"]))
        if res.outcome.value != "ok" or not replay_ok(hist, res.linearization or []):
            fail(f"in-core k=10 sort_dedup={sd}: outcome {res.outcome}, or the witness does not replay")
    for sd, runs in incore.items():
        st = runs[-1][2]
        print(
            f"in-core k=10 (2^20-row bucket) sort_dedup={sd}: OK; layers {st.layers}, peak frontier "
            f"{st.max_frontier}, expanded {st.expanded}; fold launches a run "
            f"{sorted({n for *_, n in runs})}; warm "
            + ", ".join(f"{w:.3f} s ({gib(m)})" for w, m, _, _ in runs[1:]),
            flush=True,
        )

    # Adversarial k=12 at the JAX record's configuration: only the largest
    # fold call by steps is kept (a 2^21-row chunk's call is 54.5 M lanes).
    k12 = prepare(adversarial_events(12, batch=100, seed=0))
    largest: dict = {"steps": -1}
    witness_s = [0.0]
    real_fold, real_witness = dev_mod.fold_lanes, dev_mod._recover_witness_bounded

    def keep_largest(seed, row, length, rh):
        steps = int(length.clamp(min=0, max=rh.shape[1]).sum())
        if steps > largest["steps"]:
            largest.update(steps=steps, args=[t.clone() for t in (seed, row, length, rh)])
        return real_fold(seed, row, length, rh)

    def timed_witness(*a, **kw):
        t = time.monotonic()
        try:
            return real_witness(*a, **kw)
        finally:
            witness_s[0] += time.monotonic() - t

    dev_mod.fold_lanes, dev_mod._recover_witness_bounded = keep_largest, timed_witness
    try:
        with counting_chunks(dev_mod) as chunks:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fold_cuda.reset_launches()
            syncs0 = dev_mod.SYNCS[0]
            t0 = time.monotonic()
            res = dev_mod.check_device(
                k12, max_frontier=1 << 21, device_rows_cap=1 << 24, beam=False, collect_stats=True
            )
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            k12_launches = fold_cuda.LAUNCHES["fold_lanes"]
            syncs = dev_mod.SYNCS[0] - syncs0
            peak = torch.cuda.max_memory_allocated()
    finally:
        dev_mod.fold_lanes, dev_mod._recover_witness_bounded = real_fold, real_witness
    st = res.stats
    if res.outcome.value != "ok" or not replay_ok(k12, res.linearization or []):
        fail(f"k=12: outcome {res.outcome}, or the witness does not replay")
    if st.max_frontier != K12_PEAK:
        fail(f"k=12 peak frontier {st.max_frontier}, the JAX engine's {K12_PEAK}")
    if not chunks["layers"] or k12_launches == 0:
        fail(f"k=12: {len(chunks['layers'])} chunked layers, {k12_launches} fold launches")
    print(
        f"k=12 (check_device beam off, 2^21-row chunks, device rows 2^24): OK, witness replays, "
        f"peak frontier {st.max_frontier} (== the JAX engine's); layers {st.layers}, expanded "
        f"{st.expanded}; chunked layers (bucket rows, chunks, compactions before the last) "
        f"{chunks['layers']}; first call {wall:.3f} s (the largest fold call kept on the side), "
        f"witness recovery {witness_s[0]:.3f} s ({100 * witness_s[0] / wall:.1f}%); host syncs "
        f"{syncs}, fold launches {k12_launches}; "
        f"peak memory {gib(peak)}; card {fb.card()}",
        flush=True,
    )
    out["launches_by_path"]["adversarial k=12 through the tier (2^21-row chunks)"] = k12_launches

    a = largest.pop("args")
    got = fold_cuda.fold_lanes(*a)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = xxh3.fold_record_hashes_indexed(*a)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    if not torch.equal(got, want):
        fail(f"the k=12 largest fold call differs from the plain fold: {int((got != want).sum())} lanes")
    err = float((got.double() - want.double()).abs().max())
    del got, want
    dev_ms, call_ms, host_ms = fb.times(lambda: fold_cuda.fold_lanes(*a), 5, sm_hz)
    r, w = int(a[3].shape[0]), int(a[3].shape[1])
    b_ms, b_by = fb.fold_bound_ms(a[2], r, w, clocks)
    cs = fb.call_stats(a[2], w)
    print(
        f"k=12 largest fold call by steps: lanes {cs['lanes']}, active {cs['active']}, steps "
        f"{cs['steps']}, R={r} L={w}: bit-exact; kernel {call_ms:.4f} ms per call, {dev_ms:.4f} ms "
        f"device, {host_ms:.4f} ms host; plain {plain_ms:.3f} ms (one call); bound {b_ms:.4f} ms "
        f"({b_by}), device time at {100 * b_ms / dev_ms:.0f}% of it",
        flush=True,
    )
    out["chunked_call"] = {
        "path": "adversarial k=12, the largest call by steps", "lanes": cs["lanes"],
        "steps": cs["steps"], "ms": call_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
    }
    del a

    # The unsatisfiable k=8 through the tier, then past a cap under its peak.
    k8 = prepare(adversarial_events(8, batch=100, seed=0, unsatisfiable=True))
    kw8 = dict(max_frontier=1 << 10, device_rows_cap=TIER_K8_ROWS, beam=False, collect_stats=True)
    with fb.recording_folds(dev_mod) as calls, counting_chunks(dev_mod) as chunks:
        fold_cuda.reset_launches()
        t0 = time.monotonic()
        res = dev_mod.check_device(k8, **kw8)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k8_launches = fold_cuda.LAUNCHES["fold_lanes"]
    got = stats_of(res.stats, TIER_K8_UNSAT_STATS)
    if res.outcome.value != "illegal" or not res.refusals:
        fail(f"unsatisfiable k=8 through the tier: {res.outcome}, {len(res.refusals)} refusal reports")
    if got != TIER_K8_UNSAT_STATS or not chunks["layers"]:
        fail(f"unsatisfiable k=8 through the tier: statistics {got} (the JAX engine's "
             f"{TIER_K8_UNSAT_STATS}), {len(chunks['layers'])} chunked layers")
    print(
        f"unsatisfiable k=8 through the tier (2^10-row chunks, device rows {TIER_K8_ROWS}): ILLEGAL "
        f"with {len(res.refusals)} refusal reports in {wall:.3f} s; statistics == the JAX engine's "
        f"{json.dumps(got)}; chunked layers {chunks['layers']}; fold launches {k8_launches}",
        flush=True,
    )
    if k8_launches == 0 or len(calls) != k8_launches:
        fail(f"the unsatisfiable k=8 run through the tier: {k8_launches} fold launches, "
             f"{len(calls)} recorded")
    recheck_calls(calls, "unsatisfiable k=8 through the tier")
    del calls
    out["launches_by_path"]["unsatisfiable k=8 through the tier (2^10-row chunks)"] = k8_launches

    # The unsatisfiable k=9 sweeps its whole space, so its widest layers
    # expand several live 2^17-row chunks each.  Its fold calls are recorded
    # in one more call, after the timed ones, so that no recorded copy
    # counts in their peak memory.
    k9 = prepare(adversarial_events(9, batch=100, seed=0, unsatisfiable=True))
    kw9 = dict(max_frontier=1 << 17, device_rows_cap=TIER_K9_ROWS, beam=False, collect_stats=True)
    with counting_chunks(dev_mod) as chunks:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fold_cuda.reset_launches()
        syncs0 = dev_mod.SYNCS[0]
        t0 = time.monotonic()
        res = dev_mod.check_device(k9, **kw9)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        k9_launches = fold_cuda.LAUNCHES["fold_lanes"]
        syncs = dev_mod.SYNCS[0] - syncs0
        peak = torch.cuda.max_memory_allocated()
    got = stats_of(res.stats, TIER_K9_UNSAT_STATS)
    if res.outcome.value != "illegal" or not res.refusals:
        fail(f"unsatisfiable k=9 through the tier: {res.outcome}, {len(res.refusals)} refusal reports")
    if got != TIER_K9_UNSAT_STATS:
        fail(f"unsatisfiable k=9 through the tier: statistics {got}, the JAX engine's {TIER_K9_UNSAT_STATS}")
    widest = max((n for _, n, _ in chunks["layers"]), default=0)
    if widest < 2 or k9_launches == 0:
        fail(f"unsatisfiable k=9 through the tier: at most {widest} chunks a layer, {k9_launches} "
             "fold launches")
    warm = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res_w = dev_mod.check_device(k9, **kw9)
        torch.cuda.synchronize()
        warm.append((time.monotonic() - t0, torch.cuda.max_memory_allocated()))
        if res_w.outcome.value != "illegal" or stats_of(res_w.stats, TIER_K9_UNSAT_STATS) != got:
            fail("a warm unsatisfiable k=9 call through the tier differs from the first")
    print(
        f"unsatisfiable k=9 through the tier (2^17-row chunks, device rows {TIER_K9_ROWS}): ILLEGAL "
        f"with {len(res.refusals)} refusal reports; statistics == the JAX engine's {json.dumps(got)}; "
        f"chunked layers (bucket rows, chunks, compactions before the last) {chunks['layers']}; host "
        f"syncs {syncs}, fold launches {k9_launches}; first call {wall:.3f} s, peak memory "
        f"{gib(peak)}; warm " + ", ".join(f"{w:.3f} s ({gib(m)})" for w, m in warm)
        + f"; card {fb.card()}",
        flush=True,
    )
    with fb.recording_folds(dev_mod) as calls:
        fold_cuda.reset_launches()
        dev_mod.check_device(k9, **kw9)
        if len(calls) != fold_cuda.LAUNCHES["fold_lanes"] or len(calls) != k9_launches:
            fail(f"unsatisfiable k=9 through the tier: {len(calls)} fold calls recorded, "
                 f"{fold_cuda.LAUNCHES['fold_lanes']} launched, {k9_launches} in the first call")
    recheck_calls(calls, "unsatisfiable k=9 through the tier")
    del calls
    out["launches_by_path"]["unsatisfiable k=9 through the tier (2^17-row chunks)"] = k9_launches
    return out



class PeakRss:
    """The process's peak resident set size while inside, sampled from
    ``/proc/self/status`` every 20 ms (``ru_maxrss`` only grows over the
    process's life, so it cannot give one run's peak)."""

    @staticmethod
    def now() -> int:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def __enter__(self):
        self.start = self.peak = self.now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self.now())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.now())


@contextlib.contextmanager
def counting_spill(dev_mod):
    """Count the host-RAM spill's work through ``dev_mod`` while inside:
    ``{"layers": [slabs of each streamed layer], "halvings": slabs retried
    in halves, "segments": hybrid in-core segments, "dedup_s": seconds in
    _dedup_rows, "spills": hand-offs}``."""
    box = {"layers": [], "halvings": 0, "segments": 0, "dedup_s": 0.0, "spills": 0}
    real = dev_mod.run_search, dev_mod._dedup_rows, dev_mod._spill_search
    state = {"inside": False, "slabs": 0}

    def run(tables, fr, max_layers, **kw):
        out = real[0](tables, fr, max_layers, **kw)
        if state["inside"]:
            if max_layers == 1:
                state["slabs"] += 1
                box["halvings"] += out.stop_code == dev_mod.STOP_CAPACITY
            else:
                box["segments"] += 1
        return out

    def close_layer():
        if state["slabs"]:
            box["layers"].append(state["slabs"])
            state["slabs"] = 0

    def dedup(*a, **kw):
        t = time.monotonic()
        try:
            return real[1](*a, **kw)
        finally:
            box["dedup_s"] += time.monotonic() - t
            close_layer()

    def spill(*a, **kw):
        state["inside"] = True
        box["spills"] += 1
        try:
            return real[2](*a, **kw)
        finally:
            state["inside"] = False
            close_layer()

    dev_mod.run_search, dev_mod._dedup_rows, dev_mod._spill_search = run, dedup, spill
    try:
        yield box
    finally:
        dev_mod.run_search, dev_mod._dedup_rows, dev_mod._spill_search = real


@contextlib.contextmanager
def preempting(dev_mod, should_stop):
    """Make ``dev_mod.run_search`` raise ``KeyboardInterrupt`` (a simulated
    preemption) at the first call for which ``should_stop(max_layers,
    last)`` holds, ``last`` the previous call's result; yields the count of
    calls made."""
    real = dev_mod.run_search
    state = {"calls": 0, "last": None}

    def run(tables, fr, max_layers, **kw):
        if should_stop(max_layers, state["last"]):
            raise KeyboardInterrupt
        state["calls"] += 1
        state["last"] = real(tables, fr, max_layers, **kw)
        return state["last"]

    dev_mod.run_search = run
    try:
        yield state
    finally:
        dev_mod.run_search = real


def run_spill_phase(dev_mod, fold_cuda, xxh3, fb, prepare, adversarial_events, run_cli,
                    recheck_calls, clocks, sm_hz, stats_of, chunk_counter) -> dict:
    """Phase 10, the host-RAM spill and checkpoints; returns the fold's
    launches on its paths and run (d)'s largest call, measured."""
    from s2_verification_tpu_torch.checker.checkpoint import load_checkpoint

    out: dict = {"launches_by_path": {}}

    def gib(b):
        return f"{b / 2**30:.3f} GiB"

    def measured(fn, record=True):
        """One timed call of ``fn`` with the spill's counters; ``record``
        keeps a copy of every fold call's inputs (they count in the peak
        device memory)."""
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(fb.recording_folds(dev_mod)) if record else None
            box = stack.enter_context(counting_spill(dev_mod))
            rss = stack.enter_context(PeakRss())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fold_cuda.reset_launches()
            syncs0 = dev_mod.SYNCS[0]
            t0 = time.monotonic()
            res = fn()
            torch.cuda.synchronize()
            info = dict(wall=time.monotonic() - t0, launches=fold_cuda.LAUNCHES["fold_lanes"],
                        syncs=dev_mod.SYNCS[0] - syncs0, peak=torch.cuda.max_memory_allocated())
        info.update(box, rss=rss.peak, rss0=rss.start, calls=calls)
        return res, info

    def shape(info):
        return (
            f"streamed layers {len(info['layers'])} (slabs each {info['layers']}), slab halvings "
            f"{info['halvings']}, hybrid in-core segments {info['segments']}, host syncs "
            f"{info['syncs']}, _dedup_rows {info['dedup_s']:.3f} s, fold launches {info['launches']}, "
            f"peak memory {gib(info['peak'])}, host RSS {gib(info['rss0'])} at the start, "
            f"{gib(info['rss'])} at the peak"
        )

    def check_run(tag, res, info, outcome, want, slabs=None):
        got = stats_of(res.stats, want)
        if res.outcome.value != outcome or got != want:
            fail(f"{tag}: {res.outcome.value} with statistics {got}; want {outcome}, {want}")
        if outcome == "illegal" and not res.refusals:
            fail(f"{tag}: ILLEGAL without refusal reports")
        if info["spills"] != 1 or not info["layers"] or info["launches"] == 0:
            fail(f"{tag}: {info['spills']} spill hand-offs, {len(info['layers'])} streamed layers, "
                 f"{info['launches']} fold launches")
        if slabs is not None and sum(info["layers"]) != slabs:
            fail(f"{tag}: {sum(info['layers'])} slabs, the JAX engine's {slabs}")
        return got

    def first_and_warm(tag, fn, outcome, want, slabs=None, warm_calls=1):
        res, first = measured(fn)
        got = check_run(tag, res, first, outcome, want, slabs)
        calls = first.pop("calls")
        warm = []
        for _ in range(warm_calls):
            res_w, w = measured(fn, record=False)
            check_run(f"{tag} (warm)", res_w, w, outcome, want, slabs)
            warm.append(w)
        print(
            f"{tag}: {outcome.upper()}; statistics == the JAX engine's {json.dumps(got)}; first call "
            f"{first['wall']:.3f} s ({shape(first)}; its fold inputs recorded); warm "
            + ("; ".join(f"{w['wall']:.3f} s ({shape(w)})" for w in warm) or "not timed")
            + f"; card {fb.card()}",
            flush=True,
        )
        if len(calls) != first["launches"]:
            fail(f"{tag}: {len(calls)} fold calls recorded, {first['launches']} launched")
        recheck_calls(calls, tag)
        return res, first

    # (a) The tier hands the unsatisfiable k=8 to the spill.
    k8 = prepare(adversarial_events(8, batch=100, seed=0, unsatisfiable=True))
    kw_a = dict(max_frontier=1 << 10, device_rows_cap=SPILL_K8_ROWS, beam=False, spill=True, collect_stats=True)
    tag = "spill (a): unsatisfiable k=8, 2^10-row bucket, tier to 2^16 rows, then the spill"
    _, first = first_and_warm(tag, lambda: dev_mod.check_device(k8, **kw_a), "illegal", TIER_K8_UNSAT_STATS,
                              SPILL_K8_SLABS)
    out["launches_by_path"]["unsatisfiable k=8, tier to 2^16 rows, then the spill (a)"] = first["launches"]

    # (b) The unsatisfiable k=9 at a 2^17-row bucket: straight into the
    # spill, and through a 2^20-row tier into it (no warm calls, for the
    # script's time limit).
    k9 = prepare(adversarial_events(9, batch=100, seed=0, unsatisfiable=True))
    kw_b = dict(max_frontier=1 << 17, beam=False, spill=True, collect_stats=True)
    for cap, slabs in SPILL_K9_SLABS.items():
        tag = f"spill (b): unsatisfiable k=9, 2^17-row bucket, device_rows_cap={cap}"
        _, first = first_and_warm(tag, lambda cap=cap: dev_mod.check_device(k9, device_rows_cap=cap, **kw_b),
                                  "illegal", TIER_K9_UNSAT_STATS, slabs, warm_calls=0)
        out["launches_by_path"][f"unsatisfiable k=9, 2^17-row bucket, device_rows_cap={cap}, spill (b)"] = (
            first["launches"])

    # (c) Adversarial k=10 through the spill at a 2^18-row bucket.
    k10 = prepare(adversarial_events(10, batch=100, seed=0))
    kw_c = dict(max_frontier=1 << 18, device_rows_cap=0, beam=False, spill=True, collect_stats=True)
    tag = "spill (c): adversarial k=10, 2^18-row bucket, straight into the spill"
    res, first = first_and_warm(tag, lambda: dev_mod.check_device(k10, **kw_c), "ok", SPILL_K10_STATS)
    incore = dev_mod.check_device(k10, max_frontier=1 << 20, beam=False, witness=False)
    if not replay_ok(k10, res.linearization or []) or res.final_states != incore.final_states:
        fail(f"{tag}: the witness does not replay, or final states {res.final_states} differ from "
             f"the in-core run's {incore.final_states}")
    print(f"{tag}: witness replays; final states == the in-core run's ({len(res.final_states)})", flush=True)
    out["launches_by_path"]["adversarial k=10, 2^18-row bucket, spill (c)"] = first["launches"]

    # (d) The unsatisfiable k=10 through the device backend's defaults: the beam phase
    # concedes, the exhaustive phase grows through the tier to 2^23 rows
    # and hands off to the spill.  Only the largest fold call by steps is
    # kept.
    k10u = adversarial_events(10, batch=100, seed=0, unsatisfiable=True)
    largest: dict = {"steps": -1}
    real_fold = dev_mod.fold_lanes

    def keep_largest(seed, row, length, rh):
        steps = int(length.clamp(min=0, max=rh.shape[1]).sum())
        if steps > largest["steps"]:
            largest.update(steps=steps, args=[t.clone() for t in (seed, row, length, rh)])
        return real_fold(seed, row, length, rh)

    tag = "spill (d): unsatisfiable k=10 through `check -backend=device -stats`, no cap flags"
    dev_mod.fold_lanes = keep_largest
    try:
        with chunk_counter(dev_mod) as chunks:
            (rc, captured, stats), first = measured(lambda: run_cli(k10u, "unsat-k10"), record=False)
    finally:
        dev_mod.fold_lanes = real_fold
    got = {k: stats.get(k) for k in SPILL_K10_UNSAT_STATS}
    res = captured.get("res")
    if rc != 1 or res is None or res.outcome.value != "illegal" or not res.refusals:
        fail(f"{tag}: exit {rc}, outcome {res and res.outcome}")
    if got != SPILL_K10_UNSAT_STATS:
        fail(f"{tag}: statistics {got}, the JAX record's {SPILL_K10_UNSAT_STATS}")
    if first["spills"] != 1 or not chunks["layers"] or first["launches"] == 0:
        fail(f"{tag}: {first['spills']} spill hand-offs, {len(chunks['layers'])} chunked layers, "
             f"{first['launches']} fold launches")
    print(
        f"{tag}: exit 1 ILLEGAL with {len(res.refusals)} refusal reports; statistics == the JAX "
        f"record's {json.dumps(got)}; wall {first['wall']:.3f} s (the largest fold call kept on the "
        f"side); chunked layers (bucket rows, chunks, compactions before the last) {chunks['layers']}; "
        f"{shape(first)}; card {fb.card()}",
        flush=True,
    )
    print(f"cli stats: {json.dumps(stats)}", flush=True)
    out["launches_by_path"]["unsatisfiable k=10 through the CLI: beam, tier to 2^23 rows, spill (d)"] = (
        first["launches"])
    hist10u = captured["hist"]
    res_w, warm = measured(lambda: dev_mod.check_device_auto(hist10u, collect_stats=True), record=False)
    check_run(f"{tag} (warm, check_device_auto)", res_w, warm, "illegal", SPILL_K10_UNSAT_STATS)
    print(f"{tag}, warm check_device_auto: {warm['wall']:.3f} s ({shape(warm)})", flush=True)

    a = largest.pop("args")
    got_f = fold_cuda.fold_lanes(*a)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want_f = xxh3.fold_record_hashes_indexed(*a)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    if not torch.equal(got_f, want_f):
        fail(f"the unsatisfiable k=10 largest fold call differs from the plain fold: "
             f"{int((got_f != want_f).sum())} lanes")
    err = float((got_f.double() - want_f.double()).abs().max())
    del got_f, want_f
    dev_ms, call_ms, host_ms = fb.times(lambda: fold_cuda.fold_lanes(*a), 5, sm_hz)
    r, w = int(a[3].shape[0]), int(a[3].shape[1])
    b_ms, b_by = fb.fold_bound_ms(a[2], r, w, clocks)
    cs = fb.call_stats(a[2], w)
    print(
        f"unsatisfiable k=10 largest fold call by steps: lanes {cs['lanes']}, active {cs['active']}, "
        f"steps {cs['steps']}, R={r} L={w}: bit-exact; kernel {call_ms:.4f} ms per call, {dev_ms:.4f} ms "
        f"device, {host_ms:.4f} ms host; plain {plain_ms:.3f} ms (one call); bound {b_ms:.4f} ms "
        f"({b_by}), device time at {100 * b_ms / dev_ms:.0f}% of it",
        flush=True,
    )
    out["spill_call"] = {
        "path": "unsatisfiable k=10 through the CLI, the largest call by steps", "lanes": cs["lanes"],
        "steps": cs["steps"], "ms": call_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
    }
    del a

    # (e) Checkpoint resume on the card: (b) preempted mid-spill, and the
    # k=10 tier run preempted after its first escalation.
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "k9.ck")
        kw_e = dict(kw_b, device_rows_cap=0, checkpoint_path=ck)
        slabs = {"n": 0}

        def mid_spill(max_layers, _last):
            slabs["n"] += max_layers == 1
            return slabs["n"] == SPILL_K9_SLABS[0] * 2 // 3

        try:
            with preempting(dev_mod, mid_spill):
                dev_mod.check_device(k9, **kw_e)
        except KeyboardInterrupt:
            pass
        else:
            fail("spill (e): the unsatisfiable k=9 was not preempted")
        snap = ck + ".spill.npz"
        if not os.path.exists(snap):
            fail(f"spill (e): no {os.path.basename(snap)} after the preemption")
        with np.load(snap) as z:
            snap_layers, snap_rows = int(z["layers"]), len(z["host"])
        fold_cuda.reset_launches()
        t0 = time.monotonic()
        res = dev_mod.check_device(k9, **kw_e)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        resumed_launches = fold_cuda.LAUNCHES["fold_lanes"]
        got = stats_of(res.stats, TIER_K9_UNSAT_STATS)
        if res.outcome.value != "illegal" or got != TIER_K9_UNSAT_STATS or os.path.exists(snap):
            fail(f"spill (e): the resumed k=9 is {res.outcome.value} with {got} (want "
                 f"{TIER_K9_UNSAT_STATS}), snapshot left: {os.path.exists(snap)}")
        print(
            f"spill (e): unsatisfiable k=9 (b, device_rows_cap=0) preempted at slab {slabs['n']}, resumed "
            f"from {os.path.basename(snap)} (layer {snap_layers}, {snap_rows} host rows) in {wall:.3f} s: "
            f"ILLEGAL, statistics == the uninterrupted run's {json.dumps(got)}, snapshot removed; fold "
            f"launches {resumed_launches}",
            flush=True,
        )
        out["launches_by_path"]["unsatisfiable k=9 resumed from its spill snapshot (e)"] = resumed_launches

        ck = os.path.join(tmp, "k10.ck")
        kw_t = dict(max_frontier=1 << 17, device_rows_cap=1 << 20, beam=False, collect_stats=True,
                    checkpoint_path=ck, checkpoint_every=2)
        try:
            with preempting(dev_mod, lambda _m, last: last is not None
                            and last.stop_code == dev_mod.STOP_CAPACITY) as state:
                dev_mod.check_device(k10, **kw_t)
        except KeyboardInterrupt:
            pass
        else:
            fail("checkpoint (e): the k=10 tier run was not preempted")
        saved = load_checkpoint(ck)
        fold_cuda.reset_launches()
        t0 = time.monotonic()
        res = dev_mod.check_device(k10, **kw_t)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        resumed_launches = fold_cuda.LAUNCHES["fold_lanes"]
        got = stats_of(res.stats, TIER_K10_STATS)
        if (res.outcome.value != "ok" or got != TIER_K10_STATS or os.path.exists(ck)
                or not replay_ok(k10, res.linearization or [])):
            fail(f"checkpoint (e): the resumed k=10 is {res.outcome.value} with {got} (want "
                 f"{TIER_K10_STATS}), snapshot left: {os.path.exists(ck)}, or its witness does not replay")
        print(
            f"checkpoint (e): adversarial k=10 through the tier, checkpoint_every=2, preempted after "
            f"{state['calls']} segments at its first escalation (snapshot: {saved.f}-row bucket, layer "
            f"{saved.layers_done}), resumed in {wall:.3f} s: OK, witness replays, statistics == the "
            f"uninterrupted run's {json.dumps(got)}, snapshot removed; fold launches {resumed_launches}",
            flush=True,
        )
        out["launches_by_path"]["adversarial k=10 tier run resumed from its checkpoint (e)"] = resumed_launches
    return out

def lin_sha256(order) -> str:
    """sha256 of a linearization written as comma-separated op indices."""
    return hashlib.sha256(",".join(map(str, order)).encode()).hexdigest()


def run_check_phase(dev_mod, fold_cuda, fb, prepare, adversarial_events, cli, ev, recheck_calls,
                    table_events, table_verdicts, headline_events) -> dict:
    """Phase 11, the ``check`` command; ``table_events`` are phase 7's five
    histories, ``table_verdicts`` the card's verdicts on them there.
    Returns the fold's launches on its paths."""
    from s2_verification_tpu_torch.checker import native

    small_events = {k: v for k, v in table_events.items() if not k.endswith("x2000")}
    t_phase = time.monotonic()
    out: dict = {"launches_by_path": {}}
    card = fb.card()

    def cli_run(events_by_name, args):
        """``check`` in process over the histories given (one file, or a
        corpus directory when there are several); returns ``(rc, stdout
        lines, {file: (result, history)}, wall, fold launches)``."""
        seen = {}
        with tempfile.TemporaryDirectory() as tmp:
            paths = []
            for name, events in events_by_name.items():
                paths.append(os.path.join(tmp, f"{name}.jsonl"))
                with open(paths[-1], "w", encoding="utf-8") as f:
                    ev.write_history(events, f)
            target = paths[0] if len(paths) == 1 else tmp
            buf = io.StringIO()
            torch.cuda.synchronize()
            fold_cuda.reset_launches()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["check", f"-file={target}", *args],
                              on_result=lambda p, res, hist: seen.update({os.path.basename(p): (res, hist)}))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = fold_cuda.LAUNCHES["fold_lanes"]
        return rc, buf.getvalue().strip().splitlines(), seen, wall, launches

    # (a) The witness log on the card.
    table_launches = 0
    walls = []
    for name, events in small_events.items():
        hist = prepare(events)
        fold_cuda.reset_launches()
        t0 = time.monotonic()
        on_card = dev_mod.check_device(hist, witness_max_frontier=4096, collect_stats=True)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        table_launches += fold_cuda.LAUNCHES["fold_lanes"]
        on_cpu = dev_mod.check_device(hist, witness_max_frontier=4096, device="cpu")
        t2 = time.monotonic()
        if (on_card.outcome.value != "ok" or on_card.linearization != on_cpu.linearization
                or not replay_ok(hist, on_card.linearization or [])):
            fail(f"witness log (a), {name}: {on_card.outcome.value} on the card, the linearization differs "
                 "from the CPU run's or does not replay")
        walls.append(f"{name} {on_card.stats.layers} layers, {on_card.stats.host_syncs} syncs: card "
                     f"{t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")
    print(f"witness log (a): the four small histories of phase 7 through check_device(witness_max_frontier=4096): "
          f"OK, linearizations == the CPU run's and replay; fold launches {table_launches}; "
          + "; ".join(walls), flush=True)
    out["launches_by_path"]["phase 7's four small histories, witness log (11a)"] = table_launches

    k10 = prepare(adversarial_events(10, batch=100, seed=0))
    kw = dict(beam=False, max_frontier=1 << 20, witness_max_frontier=1 << 20, collect_stats=True)
    runs = []
    for i in range(3):
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(fb.recording_folds(dev_mod)) if i == 0 else None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fold_cuda.reset_launches()
            syncs0 = dev_mod.SYNCS[0]
            t0 = time.monotonic()
            res = dev_mod.check_device(k10, **kw)
            torch.cuda.synchronize()
            runs.append(dict(wall=time.monotonic() - t0, peak=torch.cuda.max_memory_allocated(),
                             launches=fold_cuda.LAUNCHES["fold_lanes"], syncs=dev_mod.SYNCS[0] - syncs0))
        got = {k: getattr(res.stats, k) for k in K10_WITNESS_STATS}
        digest = lin_sha256(res.linearization or [])
        if res.outcome.value != "ok" or got != K10_WITNESS_STATS or digest != K10_WITNESS_SHA256:
            fail(f"witness log (a), adversarial k=10: {res.outcome.value}, statistics {got} (the JAX engine's "
                 f"{K10_WITNESS_STATS}), linearization sha256 {digest} (the JAX engine's {K10_WITNESS_SHA256})")
        if i == 0:
            if not replay_ok(k10, res.linearization):
                fail("witness log (a), adversarial k=10: the linearization does not replay")
            if len(calls) != runs[0]["launches"] or not calls:
                fail(f"witness log (a): {len(calls)} fold calls recorded, {runs[0]['launches']} launched")
            recheck_calls(calls, "witness log k=10")
            del calls
    print(
        f"witness log (a): adversarial k=10 batch=100 seed=0, check_device(beam=False, max_frontier=2^20, "
        f"witness_max_frontier=2^20): OK, statistics == the JAX engine's {json.dumps(got)}, linearization "
        f"sha256 == the JAX engine's ({K10_WITNESS_SHA256[:16]}...), replays; fold launches "
        f"{runs[0]['launches']}, host syncs {runs[0]['syncs']}; first call {runs[0]['wall']:.3f} s "
        f"(peak memory {runs[0]['peak'] / 2**30:.3f} GiB, fold inputs recorded), warm "
        + ", ".join(f"{r['wall']:.3f} s ({r['peak'] / 2**30:.3f} GiB)" for r in runs[1:])
        + f"; card {card}",
        flush=True,
    )
    out["launches_by_path"]["adversarial k=10, 2^20-row bucket, witness log to 2^20 rows (11a)"] = runs[0]["launches"]

    # (b) The native engine, built from the port's own source.
    if not native.native_available():
        fail("native (b): the native engine is not available")
    so = native.BUILD["path"]
    want_dir = os.path.join(os.path.dirname(os.path.abspath(native.__file__)), os.pardir, "_build")
    if os.path.realpath(os.path.dirname(so)) != os.path.realpath(want_dir):
        fail(f"native (b): the library {so} is not under s2_verification_tpu_torch/_build")
    line = []
    for name, events in table_events.items():
        hist = prepare(events)
        t0 = time.monotonic()
        res_n = native.check_native(hist)
        wall_n = time.monotonic() - t0
        if res_n.outcome.value != table_verdicts[name] or not replay_fast(hist, res_n.linearization or []):
            fail(f"native (b), {name}: native {res_n.outcome.value}, the card's {table_verdicts[name]} "
                 "(phase 7), or the native witness does not replay")
        line.append(f"{name} {res_n.outcome.value} in {wall_n:.4f} s ({res_n.steps} steps)")
    print(f"native (b): built {os.path.relpath(so)} from csrc/s2check.cpp in {native.BUILD['seconds']:.2f} s; "
          f"verdicts == the card's in phase 7: " + "; ".join(line), flush=True)

    # (c) The default ladder.
    with tempfile.TemporaryDirectory() as viz_dir:
        rc, lines, seen, wall, launches = cli_run({"headline": headline_events}, ["-stats", "-out-dir", viz_dir])
        stats = json.loads(lines[-1]) if lines else {}
        res, hist = seen.get("headline.jsonl", (None, None))
        if rc != 0 or launches != 0 or res is None or not replay_fast(hist, res.linearization or []):
            fail(f"ladder (c), headline: exit {rc}, {launches} fold launches, or no replaying witness")
        html = os.listdir(viz_dir)
    print(f"ladder (c): the headline through `check -stats` (no -backend, the HTML written: {html[0]}): exit 0 "
          f"OK on the native rung, no fold launch, witness replays; wall {wall:.3f} s "
          f"(the engine's {stats.get('wall_s')} s); card {card}", flush=True)
    print(f"cli stats: {json.dumps(stats)}", flush=True)
    k10_events = adversarial_events(10, batch=100, seed=0)
    rc, lines, seen, wall, launches = cli_run({"adversarial-k10": k10_events},
                                              ["-time-budget", "2", "-stats", "-no-viz"])
    stats = json.loads(lines[-1]) if lines else {}
    res, hist = seen.get("adversarial-k10.jsonl", (None, None))
    if rc != 0 or launches == 0 or res is None or not replay_ok(hist, res.linearization or []):
        fail(f"ladder (c), k=10: exit {rc}, {launches} fold launches, or no replaying witness")
    print(f"ladder (c): adversarial k=10 through `check -time-budget 2 -stats`: the native rung conceded, the "
          f"card decided: exit 0 OK, witness replays; fold launches {launches}; wall {wall:.3f} s; card {card}",
          flush=True)
    print(f"cli stats: {json.dumps(stats)}", flush=True)
    out["launches_by_path"]["adversarial k=10 through `check -time-budget 2` (11c)"] = launches

    # (d) Corpus mode.
    k6u = adversarial_events(6, batch=100, seed=0, unsatisfiable=True)
    rc, lines, _seen, wall, _ = cli_run({**small_events, "k6-unsat": k6u}, ["-no-viz"])
    verdicts = sorted(line.rsplit(": ", 1)[-1] for line in lines)
    if rc != 1 or verdicts != ["ILLEGAL", "OK", "OK", "OK", "OK"]:
        fail(f"corpus (d): exit {rc}, lines {lines}")
    print(f"corpus (d): five files in one `check -file=<dir>`: exit 1, {len(lines)} lines "
          f"({', '.join(verdicts)}); wall {wall:.3f} s", flush=True)

    # (e) The visualization.
    first = next(iter(small_events))
    for name, events, want_rc in ((first, small_events[first], 0), ("k6-unsat", k6u, 1)):
        with tempfile.TemporaryDirectory() as viz_dir:
            rc, _lines, seen, wall, _ = cli_run({name: events}, ["-out-dir", viz_dir])
            (page,) = os.listdir(viz_dir)
            with open(os.path.join(viz_dir, page), encoding="utf-8") as f:
                text = f.read()
        res, hist = seen[f"{name}.jsonl"]
        if rc != want_rc or not text:
            fail(f"viz (e), {name}: exit {rc}, HTML of {len(text)} bytes")
        note = ""
        if want_rc == 1:
            refused = sorted({hist.ops[i].op_id for _p, r in res.refusals for i in r})
            if not refused or f"<code>{', '.join(map(str, refused))}</code>" not in text:
                fail(f"viz (e), {name}: the HTML does not name the refused ops {refused}")
            note = f", names the refused ops {refused}"
        print(f"viz (e): {name} through `check -out-dir`: exit {rc}, {page} ({len(text)} bytes{note}); "
              f"wall {wall:.3f} s", flush=True)
    out["seconds"] = time.monotonic() - t_phase
    return out


def _collect_lane(job):
    """One history of ``(workflow, clients, ops)`` at ``seed`` with
    :func:`bench_faults` (a worker of :func:`collect_lanes`)."""
    (workflow, clients, ops), seed = job
    from s2_verification_tpu_torch.collector.collect import CollectConfig, collect_history

    return collect_history(CollectConfig(clients, ops, workflow, seed=seed, faults=bench_faults(clients, ops)))


def collect_lanes(shape, seeds, workers=8) -> list:
    """The histories of ``shape`` at ``seeds``, collected in parallel
    processes (the collector is pure Python, one core a history); the
    processes end with the call."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(seeds)), mp_context=ctx) as pool:
        return list(pool.map(_collect_lane, [(shape, s) for s in seeds]))


def run_batch_phase(dev_mod, fold_cuda, fb, prepare, recheck_calls, measure, headline_events,
                    headline_walls, shape=BATCH_SHAPE, seeds=BATCH_SEEDS, device="cuda", workers=8) -> dict:
    """Phase 12, batched lanes (``checker/batched.py`` over
    ``device.run_search_lanes``).  ``headline_events`` is phase 7's
    headline, the group's first lane; ``headline_walls`` its first and warm
    walls through ``-backend=device`` there, printed beside the group's.
    Returns the fold's launches on the batched paths and the batched
    path's largest fold call measured."""
    from s2_verification_tpu_torch.checker import batched
    from s2_verification_tpu_torch.checker.native import check_native
    from s2_verification_tpu_torch.collector.campaign import builtin_campaigns, collect_labeled
    from s2_verification_tpu_torch.models.encode import encode_batch

    t_phase = time.monotonic()
    out: dict = {"launches_by_path": {}}
    card = fb.card()

    def launch(lanes, what, record):
        """``check_batch_vmap`` of ``lanes`` on the card, with every fold
        call recorded if ``record``; returns its verdicts, the lanes'
        RunOuts, wall, fold launches, host syncs, loop iterations, peak
        memory and recorded calls."""
        runs = []
        real = batched._mega_launch
        batched._mega_launch = lambda *a: runs.append(real(*a)) or runs[-1]
        try:
            with fb.recording_folds(dev_mod) if record else contextlib.nullcontext([]) as calls:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fold_cuda.reset_launches()
                syncs0, iters0 = dev_mod.SYNCS[0], dev_mod.LANE_ITERS[0]
                t0 = time.monotonic()
                verdicts = batched.check_batch_vmap(lanes, device=device)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
        finally:
            batched._mega_launch = real
        got = dict(verdicts=verdicts, runs=runs[0] if runs else [], wall=wall,
                   launches=fold_cuda.LAUNCHES["fold_lanes"], syncs=dev_mod.SYNCS[0] - syncs0,
                   iters=dev_mod.LANE_ITERS[0] - iters0, peak=torch.cuda.max_memory_allocated(), calls=calls)
        if got["launches"] == 0 or (record and len(calls) != got["launches"]):
            fail(f"{what}: {got['launches']} fold launches, {len(calls)} recorded")
        return got

    def per_iter(run):
        return (f"{run['iters']} iterations, {run['syncs']} host syncs ({run['syncs'] / run['iters']:.2f} an "
                f"iteration), {run['launches']} fold launches ({run['launches'] / run['iters']:.2f} an iteration)")

    # (a) One launch group at full width: the headline and more seeds of
    # its shape.
    workflow, clients, ops = shape
    t0 = time.monotonic()
    events = [headline_events] + collect_lanes(shape, seeds, workers)
    hists = [prepare(e) for e in events]
    lanes = [batched.BatchLane(h, e) for h, e in zip(hists, encode_batch(hists))]
    enc = lanes[0].enc
    print(f"batched lanes (a): {len(lanes)} lanes of {workflow} {clients}x{ops} (phase 7's headline and seeds "
          f"{seeds[0]}-{seeds[-1]}) collected ({workers} processes), prepared and encoded in "
          f"{time.monotonic() - t0:.1f} s; lane dims "
          f"N {enc.op_type.shape[0]}, rh {tuple(enc.rh_hi.shape)}, chains {tuple(enc.chain_ops.shape)}; "
          f"ops left per lane {[lane.enc.total_remaining for lane in lanes]}", flush=True)
    first = launch(lanes, "the headline-shape launch group", True)
    bad = [i for i, v in enumerate(first["verdicts"]) if v.result is None or v.result.outcome.value != "ok"]
    if bad:
        fail(f"batched lanes (a): lanes {bad} are not OK")
    layers = [v.layers for v in first["verdicts"]]
    # (d), for (a): its fold calls, before the warm call, so that no
    # recorded copy counts in that call's peak memory.
    group_calls = first.pop("calls")
    steps = recheck_calls(group_calls, "batched lanes (a)")
    largest = max(range(len(group_calls)), key=lambda j: (steps[j], -j))
    out["batched_call"] = measure(group_calls[largest], f"batched lanes (a) call {largest + 1}, the largest by steps")
    del group_calls
    warm = launch(lanes, "the headline-shape launch group, warm", False)
    if [(v.result.outcome, v.layers) for v in warm["verdicts"]] != [(v.result.outcome, v.layers)
                                                                     for v in first["verdicts"]]:
        fail("batched lanes (a): the warm launch differs from the first")

    # The headline lane alone through run_search, at the lanes' capacity.
    max_layers = max(lane.enc.total_remaining for lane in lanes) + 2
    fold_cuda.reset_launches()
    syncs0 = dev_mod.SYNCS[0]
    t0 = time.monotonic()
    single = dev_mod.run_search(
        dev_mod.build_tables(enc, device),
        dev_mod.init_frontier(enc, batched.VMAP_LANE_CAPACITY, device),
        max_layers,
        allow_prune=True,
    )
    torch.cuda.synchronize()
    single_wall = time.monotonic() - t0
    single_syncs, single_launches = dev_mod.SYNCS[0] - syncs0, fold_cuda.LAUNCHES["fold_lanes"]
    if single.stop_code != dev_mod.STOP_ACCEPT or single.layers != layers[0]:
        fail(f"batched lanes (a): the headline lane took {layers[0]} layers in the group, "
             f"{single.layers} alone (stop {single.stop_code})")
    cli_first, cli_warm = headline_walls
    print(
        f"batched lanes (a): check_batch_vmap of {len(lanes)} lanes at capacity {batched.VMAP_LANE_CAPACITY}: "
        f"every lane OK, layers per lane {layers} (the headline lane {layers[0]}; its pinned count through "
        f"check_device {HEADLINE_STATS['layers']}); first call {first['wall']:.3f} s ({per_iter(first)}, peak "
        f"memory {first['peak'] / 2**30:.3f} GiB with its fold inputs recorded), warm {warm['wall']:.3f} s "
        f"({per_iter(warm)}, peak memory {warm['peak'] / 2**30:.3f} GiB); card {card}",
        flush=True,
    )
    print(
        f"batched lanes (a): the headline lane alone, run_search at capacity {batched.VMAP_LANE_CAPACITY}: "
        f"{single.layers} layers (== its lane in the group) in {single_wall:.3f} s, {single_syncs} host syncs "
        f"({single_syncs / single.layers:.2f} a layer), {single_launches} fold launches; through check "
        f"-backend=device in phase 7: first {cli_first:.3f} s, warm "
        + ", ".join(f"{w:.3f}" for w in cli_warm)
        + f" s; the group's warm wall is {warm['wall'] / single_wall:.2f}x the lane alone for "
        f"{len(lanes)} lanes ({sum(len(h.ops) for h in hists) / warm['wall']:.0f} ops verified per s, the "
        f"lane alone {len(hists[0].ops) / single_wall:.0f}); the {sum(layers)} layers of all lanes at the lane "
        f"alone's {1e3 * single_wall / single.layers:.3f} ms a layer would take {sum(layers) * single_wall / single.layers:.1f} s "
        f"one lane after another (an extrapolation from the headline lane's rate, not a measurement: the other "
        f"lanes were not timed alone)",
        flush=True,
    )

    # (b) Mixed verdicts in one launch: the campaign matrix.
    labeled = [(name, *collect_labeled(camp, seed=CAMPAIGN_SEED))
               for name, camp in sorted(builtin_campaigns().items())]
    hists_b = [prepare(e) for _, e, _ in labeled]
    lanes_b = [batched.BatchLane(h, e) for h, e in zip(hists_b, encode_batch(hists_b))]
    mixed = launch(lanes_b, "the campaign launch group", True)
    mixed_calls = mixed.pop("calls")
    live = [i for i, v in enumerate(mixed["verdicts"]) if v.skipped is None and lanes_b[i].enc.total_remaining]
    pruned = {i: run.pruned_ever for i, run in zip(live, mixed["runs"])}
    line = []
    for i, ((name, _e, label), v) in enumerate(zip(labeled, mixed["verdicts"])):
        want = {"legal": "ok", "illegal": "illegal"}[label["expect"]]
        got_v = None if v.result is None else v.result.outcome.value
        if got_v is None and not pruned.get(i):
            fail(f"batched lanes (b): campaign {name} undecided without pruning")
        if got_v is not None and got_v != want:
            fail(f"batched lanes (b): campaign {name} {got_v} against its label {label['expect']}")
        line.append(f"{name} {got_v or 'escalate'} ({v.layers} layers{', pruned' if pruned.get(i) else ''})")
    print(f"batched lanes (b): the campaign matrix (seed {CAMPAIGN_SEED}) in one launch of {len(lanes_b)} "
          f"lanes, {mixed['wall']:.3f} s, {per_iter(mixed)}: decided lanes == their labels: " + "; ".join(line),
          flush=True)

    # (c) The native engine's batch over the same lanes.
    t0 = time.monotonic()
    for what, lns, vm in (("(a)", lanes, first["verdicts"]), ("(b)", lanes_b, mixed["verdicts"])):
        nat = batched.check_batch_native(lns)
        for i, (lane, v, w) in enumerate(zip(lns, nat, vm)):
            alone = check_native(lane.history)
            if (v.result.outcome, v.result.linearization) != (alone.outcome, alone.linearization):
                fail(f"batched lanes (c): check_batch_native lane {i} of {what} differs from check_native")
            if w.result is not None and w.result.outcome != alone.outcome:
                fail(f"batched lanes (c): check_batch_vmap lane {i} of {what} differs from the native engine")
    print(f"batched lanes (c): check_batch_native over (a) and (b) == check_native lane by lane, and every "
          f"lane check_batch_vmap decided == the native engine's verdict ({time.monotonic() - t0:.3f} s)",
          flush=True)

    # (d), for (b): its fold calls.
    recheck_calls(mixed_calls, "batched lanes (b)")
    del mixed_calls
    out["launches_by_path"][f"{len(lanes)} lanes of {workflow} {clients}x{ops} through check_batch_vmap (12a)"] = (
        first["launches"])
    out["launches_by_path"][f"campaign matrix, {len(lanes_b)} lanes through check_batch_vmap (12b)"] = (
        mixed["launches"])
    out["seconds"] = time.monotonic() - t_phase
    return out


@contextlib.contextmanager
def counting_exchange(distributed):
    """Count what the mesh moves while inside: the bytes of the rows
    ``FrontierMesh.exchange`` sends from one shard to another, and the
    bytes of the vectors ``FrontierMesh.gather`` stacks."""
    box = {"row_bytes": 0, "exchanges": 0, "gather_bytes": 0, "gathers": 0}
    cls = distributed.FrontierMesh
    real = cls.exchange, cls.gather

    def exchange(self, pieces, sizes):
        box["exchanges"] += 1
        box["row_bytes"] += sum(p.numel() * p.element_size() for i, row in enumerate(pieces)
                                for d, p in enumerate(row) if d != self.first + i)
        return real[0](self, pieces, sizes)

    def gather(self, vecs):
        box["gathers"] += 1
        box["gather_bytes"] += sum(v.numel() * v.element_size() for v in vecs)
        return real[1](self, vecs)

    cls.exchange, cls.gather = exchange, gather
    try:
        yield box
    finally:
        cls.exchange, cls.gather = real


@contextlib.contextmanager
def last_frontier(dev_mod):
    """Keep the frontier of the last ``run_search`` call made through
    ``dev_mod`` while inside (``box["frontier"]``)."""
    box: dict = {}
    real = dev_mod.run_search

    def run(*a, **kw):
        out = real(*a, **kw)
        box["frontier"] = out.frontier
        return out

    dev_mod.run_search = run
    try:
        yield box
    finally:
        dev_mod.run_search = real


def run_mesh_phase(dev_mod, distributed, fold_cuda, fb, prepare, adversarial_events, recheck_calls, events,
                   device="cuda", bucket=MESH_BUCKET, spill_bucket=MESH_SPILL_BUCKET, shards=MESH_SHARDS,
                   want_stats=TIER_K10_STATS, spill_stats=SPILL_K10_STATS) -> dict:
    """Phase 13, the frontier sharded over a mesh (``parallel/distributed.py``,
    ``device.place_frontier``, ``check_device(mesh=)``).  ``events`` is the
    main path's adversarial k=10; ``want_stats`` its statistics beam off in
    core, ``spill_stats`` through the spill.
    Returns the fold's launches on the mesh paths and the phase's seconds."""
    from s2_verification_tpu_torch.checker.checkpoint import load_checkpoint
    from s2_verification_tpu_torch.models.encode import encode_history

    t_phase = time.monotonic()
    out: dict = {"launches_by_path": {}}
    card = fb.card()
    hist = prepare(events)

    def gib(b):
        return f"{b / 2**30:.3f} GiB"

    # (a) The main path's history beam off in one bucket: unsharded, over
    # meshes of several shards on one card and, where there are more, one
    # shard a card; first call (fold inputs recorded) and warm.
    meshes = [("unsharded", None)] + [
        (f"{n} shards on {device}", distributed.frontier_mesh(devices=[device] * n)) for n in shards
    ]
    if device == "cuda" and torch.cuda.device_count() > 1:
        every = distributed.frontier_mesh()
        meshes.append((f"{every.size} shards, one a card", every))
    kw = dict(max_frontier=bucket, beam=False, collect_stats=True, profile=True)
    ref = None
    for label, mesh in meshes:
        opts = dict(kw, mesh=mesh) if mesh is not None else dict(kw, device=device)
        runs = []
        for record in (True, False):
            with contextlib.ExitStack() as stack:
                calls = stack.enter_context(fb.recording_folds(dev_mod)) if record else None
                moved = stack.enter_context(counting_exchange(distributed))
                last = stack.enter_context(last_frontier(dev_mod))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fold_cuda.reset_launches()
                syncs0 = dev_mod.SYNCS[0]
                t0 = time.monotonic()
                res = dev_mod.check_device(hist, **opts)
                torch.cuda.synchronize()
                runs.append(dict(res=res, wall=time.monotonic() - t0, syncs=dev_mod.SYNCS[0] - syncs0,
                                 launches=fold_cuda.LAUNCHES["fold_lanes"], peak=torch.cuda.max_memory_allocated(),
                                 moved=dict(moved), calls=calls,
                                 frontier=dev_mod.gather_frontier(last["frontier"])))
        first, warm = runs
        res = first["res"]
        tag = f"mesh (a): adversarial k=10, batch=100, seed 0, beam off, {bucket}-row bucket, {label}"
        got = {k: getattr(res.stats, k) for k in want_stats}
        for r in runs:
            if (r["res"].outcome.value != "ok" or {k: getattr(r["res"].stats, k) for k in want_stats} != want_stats
                    or not replay_ok(hist, r["res"].linearization or [])):
                fail(f"{tag}: {r['res'].outcome.value} with statistics {got} (want {want_stats}), "
                     "or the witness does not replay")
        if len(first["calls"]) != first["launches"] or first["launches"] == 0:
            fail(f"{tag}: {first['launches']} fold launches, {len(first['calls'])} recorded")
        if ref is None:
            ref = first
        for r in runs:
            same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(r["frontier"], ref["frontier"]))
            if not same or r["res"].linearization != ref["res"].linearization:
                fail(f"{tag}: the final frontier arrays or the witness differ from the unsharded run's")
        layers = res.stats.layers
        mv = first["moved"]
        sh = res.stats.shards
        print(
            f"{tag}: OK, statistics {json.dumps(got)} == the unsharded run's and the JAX engine's; final "
            f"frontier arrays ({ref['frontier'].capacity} rows) and witness == the unsharded run's, witness "
            f"replays; first {first['wall']:.3f} s (fold inputs recorded), warm {warm['wall']:.3f} s; host "
            f"syncs {first['syncs']} ({first['syncs'] / layers:.1f} a layer), fold launches {first['launches']} "
            f"({first['launches'] / layers:.1f} a layer); rows between shards {mv['row_bytes']} bytes "
            f"({mv['row_bytes'] / layers:.0f} a layer) in {mv['exchanges']} exchanges, {mv['gathers']} "
            f"gathers of {mv['gather_bytes']} bytes; shards: peak occupancy {[e['peak_occupancy'] for e in sh]}, "
            f"skew {[e['skew'] for e in sh]}, fetch wall {[e['collective_wall_s'] for e in sh]} s; peak memory "
            f"{gib(first['peak'])} first, {gib(warm['peak'])} warm; card {card}",
            flush=True,
        )
        recheck_calls(first.pop("calls"), tag)
        out["launches_by_path"][f"adversarial k=10, beam off, {bucket}-row bucket, {label} (13a)"] = (
            first["launches"])
        if ref is not first:
            del first["frontier"]
    ref_lin = ref["res"].linearization
    del ref

    # (b) The sharded spill with a re-grant: two shards, preempted after two
    # segments, resumed over four.
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "k10.ck")
        kw_b = dict(max_frontier=spill_bucket, beam=False, spill=True, collect_stats=True, checkpoint_path=ck)
        segs = {"n": 0}

        def after_two(_max_layers, _last):
            segs["n"] += 1
            return segs["n"] == 3

        tag = f"mesh (b): adversarial k=10, {spill_bucket}-row bucket and the spill, 2 shards, resumed over 4"
        with fb.recording_folds(dev_mod) as calls:
            fold_cuda.reset_launches()
            try:
                with preempting(dev_mod, after_two):
                    dev_mod.check_device(hist, mesh=distributed.frontier_mesh(devices=[device] * 2), **kw_b)
            except KeyboardInterrupt:
                pass
            else:
                fail(f"{tag}: not preempted")
            first_launches = fold_cuda.LAUNCHES["fold_lanes"]
            snaps = [os.path.basename(p) for p in (ck, ck + ".spill.npz") if os.path.exists(p)]
            if not snaps:
                fail(f"{tag}: no snapshot after the preemption")
            saved = load_checkpoint(ck) if os.path.exists(ck) else None
            fold_cuda.reset_launches()
            t0 = time.monotonic()
            res = dev_mod.check_device(hist, mesh=distributed.frontier_mesh(devices=[device] * 4), **kw_b)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            resumed_launches = fold_cuda.LAUNCHES["fold_lanes"]
        got = {k: getattr(res.stats, k) for k in spill_stats}
        left = [p for p in (ck, ck + ".spill.npz") if os.path.exists(p)]
        if (res.outcome.value != "ok" or got != spill_stats or left or not replay_ok(hist, res.linearization or [])
                or len(res.linearization) != len(ref_lin)):
            fail(f"{tag}: {res.outcome.value} with {got} (want {spill_stats}), snapshots left {left}, or the "
                 "witness does not replay at the unsharded run's length")
        print(
            f"{tag}: preempted after 2 segments ({snaps}"
            + (f": {saved.f}-row bucket, layer {saved.layers_done}" if saved else "")
            + f"), resumed over 4 shards in {wall:.3f} s: OK, statistics == the uninterrupted run's "
            f"{json.dumps(got)}, witness replays at the unsharded run's length ({len(ref_lin)} ops), both "
            f"snapshots spent; shards {[e['peak_occupancy'] for e in res.stats.shards]}; fold launches "
            f"{first_launches} + {resumed_launches}; card {card}",
            flush=True,
        )
        recheck_calls(calls, tag)
        del calls
    out["launches_by_path"]["adversarial k=10, 2^18-row bucket and the spill, 2 shards resumed over 4 (13b)"] = (
        first_launches + resumed_launches)

    # (c) SPMD: one process group of one rank that holds two shards.
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    distributed.init_distributed(f"127.0.0.1:{port}", 1, 0, local_device_count=2)
    try:
        supported = distributed.multiprocess_supported()
        mesh = distributed.frontier_mesh()
        enc = encode_history(prepare(adversarial_events(4, batch=3, seed=5)))
        tables = dev_mod.build_tables(enc, device)
        cap = enc.total_remaining + 2
        want = dev_mod.run_search(tables, dev_mod.init_frontier(enc, 256, device), cap, allow_prune=False)
        with fb.recording_folds(dev_mod) as calls:
            fold_cuda.reset_launches()
            got = dev_mod.run_search(tables, dev_mod.place_frontier(dev_mod.init_frontier(enc, 256, device), mesh),
                                     cap, allow_prune=False)
            launches = fold_cuda.LAUNCHES["fold_lanes"]
        import torch.distributed as dist

        backend = dist.get_backend()
        same = all(torch.equal(a, b) for a, b in zip(dev_mod.gather_frontier(got.frontier), want.frontier))
        if (got.stop_code != dev_mod.STOP_ACCEPT or (got.layers, got.max_live, got.expanded)
                != (want.layers, want.max_live, want.expanded) or not same):
            fail(f"mesh (c): the SPMD run stopped {got.stop_code} after {got.layers} layers (one process: "
                 f"{want.layers}), or its frontier differs")
        print(f"mesh (c): {backend} process group of 1 rank holding {mesh.local} shards on {mesh.local_devices[0]} "
              f"(multiprocess_supported {supported}): run_search SPMD on adversarial k=4, batch=3, seed 5, "
              f"256-row bucket: ACCEPT after {got.layers} layers == the one-process run's, frontier == its; "
              f"fold launches {launches}", flush=True)
        recheck_calls(calls, "mesh (c)")
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    out["launches_by_path"]["adversarial k=4, run_search SPMD, 1 rank of 2 shards (13c)"] = launches
    out["seconds"] = time.monotonic() - t_phase
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from s2_verification_tpu_torch import breakdown, cli
    from s2_verification_tpu_torch import foldbench as fb
    from s2_verification_tpu_torch.checker import device as dev_mod
    from s2_verification_tpu_torch.checker.entries import prepare
    from s2_verification_tpu_torch.checker.oracle import check
    from s2_verification_tpu_torch.collector.adversarial import adversarial_events
    from s2_verification_tpu_torch.ops import fold_cuda, xxh3
    from s2_verification_tpu_torch.parallel import distributed
    from s2_verification_tpu_torch.utils import events as ev

    t_start = time.monotonic()
    print(fb.card(), flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
        flush=True,
    )

    # -- 2. build -----------------------------------------------------------
    fold_cuda.build()
    print(
        f"build: fold_lanes nvcc {fold_cuda.BUILD['seconds']:.2f}s -> "
        f"{os.path.relpath(fold_cuda.BUILD['path'], here)}",
        flush=True,
    )
    for line in fb.ptxas_lines(fold_cuda.BUILD["log"]):
        print(f"  ptxas: {line}", flush=True)
    cuobjdump = os.path.join(os.path.dirname(fold_cuda.nvcc_path()), "cuobjdump")
    sass = fb.sass_step_counts(fold_cuda.BUILD["path"], cuobjdump)
    clocks, sms, max_mhz = fb.sm_clocks_per_s()
    sm_hz = max_mhz * 1e6
    print(f"  fold blocks of 1024 threads resident per SM: "
          f"{fb.blocks_per_sm(fold_cuda.build(), sms)}", flush=True)
    k = fb.STEP_INSTRUCTIONS
    for variant, c in sorted(sass.items()):
        print(
            f"  sass {variant}-table step loop (unrolled x{c['unroll']}), per step: "
            f"alu {c['alu']:.2f}, fma {c['fma']:.2f}, issued {c['issue']:.2f} instructions "
            f"(the bound's fixed costs: {k['alu']:.2f} / {k['fma']:.2f} / {k['issue']:.2f}); "
            f"{sms} SMs at {max_mhz:.0f} MHz max",
            flush=True,
        )

    def on_card(arrays):
        return [torch.from_numpy(x).cuda() for x in arrays]

    def check_exact(a, what):
        got = fold_cuda.fold_lanes(*a)
        want = xxh3.fold_record_hashes_indexed(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fold_lanes differs from the plain fold ({what}): "
                 f"{int((got != want).sum())} of {got.numel()} lanes")
        return got, want

    def measure(a, what, reps=20):
        """Bit-exact check, kernel and plain times, bound; one line."""
        got, want = check_exact(a, what)
        launch = dict(fold_cuda.LAST_LAUNCH)
        dev_ms, call_ms, host_ms = fb.times(lambda: fold_cuda.fold_lanes(*a), reps, sm_hz)
        plain_ms = fb.call_ms(lambda: xxh3.fold_record_hashes_indexed(*a), 2)
        r, w = int(a[3].shape[0]), int(a[3].shape[1])
        b_ms, b_by = fb.fold_bound_ms(a[2], r, w, clocks)
        st = fb.call_stats(a[2], w)
        print(
            f"fold_lanes vs plain, {what}: R={r} L={w} lanes={st['lanes']} active={st['active']} "
            f"steps={st['steps']} shared={launch['shared']} blocks={launch['blocks']}: bit-exact; "
            f"kernel {call_ms:.4f} ms per call, {dev_ms:.4f} ms device, {host_ms:.4f} ms host; "
            f"plain {plain_ms:.3f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}), device time at {100 * b_ms / dev_ms:.0f}% of it",
            flush=True,
        )
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        return {"ms": call_ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "max_abs_err": err}

    def recheck_calls(calls, what, max_lanes=1 << 23):
        """Every recorded fold call again, bit-exact against the plain fold
        (one plain fold per run of calls on one table, up to ``max_lanes``
        lanes), then timed in groups small enough to queue behind one spin
        kernel; prints one line and returns each call's steps."""
        outs = [fold_cuda.fold_lanes(*a) for a in calls]
        groups: list[list[int]] = []
        group_lanes = 0
        for j, a in enumerate(calls):
            g = groups[-1] if groups else None
            n = int(a[0].numel())
            if (g and (calls[g[0]][3] is a[3] or calls[g[0]][3].shape == a[3].shape
                       and torch.equal(calls[g[0]][3], a[3]))
                    and group_lanes + n <= max_lanes):
                g.append(j)
                group_lanes += n
            else:
                groups.append([j])
                group_lanes = n
        for g in groups:
            want = xxh3.fold_record_hashes_indexed(
                *(torch.cat([calls[j][i] for j in g]) for i in range(3)), calls[g[0]][3]
            )
            if not torch.equal(torch.cat([outs[j] for j in g]), want):
                fail(f"{what} fold calls differ from the plain fold (group of {len(g)} calls)")
        del outs
        lanes = sum(int(a[0].numel()) for a in calls)
        steps = [int(a[2].clamp(min=0, max=a[3].shape[1]).sum()) for a in calls]
        bound_sum = sum(fb.fold_bound_ms(a[2], int(a[3].shape[0]), int(a[3].shape[1]), clocks)[0]
                        for a in calls)
        dev_sum = call_sum = host_sum = 0.0
        for i in range(0, len(calls), 256):
            chunk = calls[i:i + 256]

            def run_chunk(chunk=chunk):
                for a in chunk:
                    fold_cuda.fold_lanes(*a)

            d, c, h = fb.times(run_chunk, 1, sm_hz)
            dev_sum, call_sum, host_sum = dev_sum + d, call_sum + c, host_sum + h
        shapes = sorted({(int(a[0].numel()), int(a[3].shape[0]), int(a[3].shape[1])) for a in calls})
        print(
            f"{what} fold calls: {len(calls)} calls bit-exact in {len(groups)} group(s), "
            f"{lanes} lanes, {sum(steps)} steps, shapes (lanes, R, L) {shapes[:4]}"
            f"{' ...' if len(shapes) > 4 else ''}; device {dev_sum:.3f} ms in all "
            f"({dev_sum / len(calls):.4f} ms per call), per call from Python {call_sum / len(calls):.4f} ms, "
            f"host {host_sum / len(calls):.4f} ms; summed bound {bound_sum:.4f} ms "
            f"(device time at {100 * bound_sum / dev_sum:.1f}% of it)",
            flush=True,
        )
        return steps

    # -- 3. kernel vs plain on random inputs and edge cases ------------------
    for label, (r, w), seed in (
        ("2^20 random lanes, shared-memory table", (13, 100), 0),
        ("2^20 random lanes, global-memory table", (4096, 128), 1),
    ):
        measure(fb.random_inputs(r, w, 1 << 20, seed), label)
    for name, arrays in fb.edge_cases().items():
        a = on_card(arrays)
        check_exact(a, f"edge case {name}")
        print(f"fold_lanes vs plain, edge case {name}: {a[0].numel()} lanes "
              f"R={a[3].shape[0]} L={a[3].shape[1]} blocks={fold_cuda.LAST_LAUNCH['blocks']}: "
              "bit-exact", flush=True)
    one = on_card(fb.edge_cases()["one_lane"])
    dev_ms, call_ms, host_ms = fb.times(lambda: fold_cuda.fold_lanes(*one), 50, sm_hz)
    print(f"fold_lanes, one lane of length 100 (the calls of _fast_multi): "
          f"{dev_ms:.4f} ms device, {call_ms:.4f} ms per call, {host_ms:.4f} ms host", flush=True)

    # -- 4. main path through the CLI ----------------------------------------
    def run_cli(events, tag, extra=()):
        captured = {}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, f"{tag}.jsonl")
            with open(path, "w", encoding="utf-8") as f:
                ev.write_history(events, f)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(
                    ["check", f"-file={path}", "-backend=device", "-no-viz", "-stats", *extra],
                    on_result=lambda _p, res, hist: captured.update(res=res, hist=hist),
                )
        stats = json.loads(out.getvalue().strip().splitlines()[-1]) if out.getvalue().strip() else {}
        return rc, captured, stats

    main_events = adversarial_events(10, batch=100, seed=0)
    with fb.recording_folds(dev_mod) as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fold_cuda.reset_launches()
        syncs0 = dev_mod.SYNCS[0]
        t0 = time.monotonic()
        rc, captured, stats = run_cli(main_events, "adversarial-k10")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(fold_cuda.LAUNCHES)
        syncs = dev_mod.SYNCS[0] - syncs0
        peak = torch.cuda.max_memory_allocated()
    res = captured.get("res")
    if rc != 0 or res is None or res.outcome.value != "ok":
        fail(f"main path: adversarial k=10 exit {rc}, outcome {res and res.outcome}")
    if res.linearization is None or not replay_ok(captured["hist"], res.linearization):
        fail("main path: the witness does not replay")
    if not replay_fast(captured["hist"], res.linearization):
        fail("main path: the O(n) replay check refuses a witness the pairwise one accepts")
    print(
        f"main path: check adversarial k=10 batch=100 seed=0 -> exit 0 OK, witness replays; "
        f"wall {wall:.3f} s, layers {stats.get('layers')}, peak frontier "
        f"{stats.get('max_frontier')}, expanded {stats.get('expanded')}, host syncs {syncs}, "
        f"fold launches {launches['fold_lanes']}, peak memory {peak / 2**30:.3f} GiB",
        flush=True,
    )
    print(f"cli stats: {json.dumps(stats)}", flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"main path launched {name} no time")

    # The same check again in this process, no profiler: what a long-lived
    # caller pays once the CUDA context, kernels and allocator are warm.
    warm = []
    for _ in range(3):
        t0 = time.monotonic()
        res_w = dev_mod.check_device_auto(captured["hist"])
        torch.cuda.synchronize()
        warm.append(time.monotonic() - t0)
        if res_w.outcome.value != "ok" or not replay_ok(captured["hist"], res_w.linearization or []):
            fail("warm check_device_auto of adversarial k=10 is not OK with a replaying witness")
    print(
        "warm check_device_auto, adversarial k=10, three runs after the CLI run: "
        + ", ".join(f"{w:.4f} s" for w in warm),
        flush=True,
    )

    # Every fold call of the main path again: bit-exact, timed, bounded.
    if len(calls) != launches["fold_lanes"]:
        fail(f"recorded {len(calls)} fold calls, counted {launches['fold_lanes']} launches")
    dev_sum = call_sum = bound_sum = 0.0
    for j, a in enumerate(calls):
        check_exact(a, f"main-path call {j + 1}")
        w = int(a[3].shape[1])
        st = fb.call_stats(a[2], w)
        dev_ms, call_ms, host_ms = fb.times(lambda: fold_cuda.fold_lanes(*a), 10, sm_hz)
        b_ms, _ = fb.fold_bound_ms(a[2], int(a[3].shape[0]), w, clocks)
        dev_sum += dev_ms
        call_sum += call_ms
        bound_sum += b_ms
        eff = "-" if st["warp_efficiency"] is None else f"{st['warp_efficiency']:.3f}"
        print(
            f"main-path fold call {j + 1}: lanes {st['lanes']}, active {st['active']}, steps "
            f"{st['steps']}, one-thread-per-lane warp efficiency {eff}; bit-exact; kernel "
            f"{call_ms:.4f} ms per call, {dev_ms:.4f} ms device, {host_ms:.4f} ms host, "
            f"bound {b_ms:.4f} ms",
            flush=True,
        )
    print(f"main-path fold calls, all {len(calls)}: kernel {call_sum:.4f} ms per call and "
          f"{dev_sum:.4f} ms device in all, bound {bound_sum:.4f} ms in all "
          f"(device time at {100 * bound_sum / dev_sum:.0f}% of it)", flush=True)
    steps = [int(a[2].clamp(min=0, max=a[3].shape[1]).sum()) for a in calls]
    largest = max(range(len(calls)), key=lambda j: steps[j])
    widest = max(range(len(calls)), key=lambda j: (calls[j][0].numel(), -j))
    picks = {widest: "the first call with the most lanes"}
    picks[largest] = picks.get(largest, "") + ("; " if largest in picks else "") + "the largest call by steps"
    measured = {j: measure(calls[j], f"main-path call {j + 1}, {what}", reps=10) for j, what in picks.items()}
    at_largest = measured[largest]
    kernels = [
        {
            "name": "fold_lanes",
            "route": "cuda",
            "source": "s2_verification_tpu_torch/csrc/fold_lanes.cu",
            "replaces": "s2_verification_tpu/ops/fold_pallas.py:145",
            "launches": launches["fold_lanes"],
            "max_abs_err": at_largest["max_abs_err"],
            "ms": at_largest["ms"],
            "device_ms": at_largest["device_ms"],
            "plain_ms": at_largest["plain_ms"],
            "bound_ms": at_largest["bound_ms"],
            "bound_by": at_largest["bound_by"],
            "library_ms": None,
        }
    ]
    del calls

    # The same history through the exhaustive phase alone, at full width
    # (the 2^20-row bucket the main path falls back to when its beam fails).
    torch.cuda.reset_peak_memory_stats()
    fold_cuda.reset_launches()
    syncs0 = dev_mod.SYNCS[0]
    t0 = time.monotonic()
    res = dev_mod.check_device(
        prepare(main_events), max_frontier=1 << 20, beam=False, collect_stats=True
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if res.outcome.value != "ok" or not replay_ok(captured["hist"], res.linearization or []):
        fail(f"exhaustive k=10: outcome {res.outcome}, or the witness does not replay")
    st = res.stats
    print(
        f"exhaustive k=10 (beam off, 2^20 bucket): OK, witness replays; wall {wall:.3f} s, "
        f"layers {st.layers}, peak frontier {st.max_frontier}, expanded {st.expanded}, "
        f"host syncs {dev_mod.SYNCS[0] - syncs0}, fold launches {fold_cuda.LAUNCHES['fold_lanes']}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
        flush=True,
    )

    # -- 5. unsatisfiable k=8 ------------------------------------------------
    t0 = time.monotonic()
    syncs0 = dev_mod.SYNCS[0]
    rc, captured, stats = run_cli(adversarial_events(8, batch=100, seed=0, unsatisfiable=True), "k8-unsat")
    if rc != 1:
        fail(f"unsatisfiable k=8 exited {rc}, expected 1")
    print(
        f"unsatisfiable k=8: exit 1 ILLEGAL in {time.monotonic() - t0:.3f} s, "
        f"layers {stats.get('layers')}, peak frontier {stats.get('max_frontier')}, "
        f"host syncs {dev_mod.SYNCS[0] - syncs0}",
        flush=True,
    )

    # -- 6. oracle agreement at k=6 ------------------------------------------
    for unsat in (False, True):
        hist = prepare(adversarial_events(6, batch=100, seed=0, unsatisfiable=unsat))
        syncs0 = dev_mod.SYNCS[0]
        got_v = dev_mod.check_device_auto(hist).outcome
        syncs = dev_mod.SYNCS[0] - syncs0
        want_v = check(hist).outcome
        expect = "illegal" if unsat else "ok"
        if got_v != want_v or got_v.value != expect:
            fail(f"k=6 unsatisfiable={unsat}: device {got_v}, oracle {want_v}")
        print(
            f"k=6 unsatisfiable={unsat}: device {got_v.value} == oracle {want_v.value} "
            f"(host syncs {syncs})",
            flush=True,
        )

    # -- 7. the collector path ---------------------------------------------
    from s2_verification_tpu_torch.collector.collect import CollectConfig, collect_history

    def collect(workflow, clients, ops, seed):
        t0 = time.monotonic()
        events = collect_history(
            CollectConfig(clients, ops, workflow, seed=seed, faults=bench_faults(clients, ops))
        )
        return events, time.monotonic() - t0

    table_events, table_verdicts = {}, {}
    for workflow, clients, ops in TABLE_CONFIGS:
        events, collect_s = collect(workflow, clients, ops, 4242)
        table_events[f"{workflow}-{clients}x{ops}"] = events
        hist = prepare(events)
        syncs0 = dev_mod.SYNCS[0]
        t0 = time.monotonic()
        res = dev_mod.check_device_auto(hist, collect_stats=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if res.outcome.value != "ok" or not replay_fast(hist, res.linearization or []):
            fail(f"{workflow} {clients}x{ops}: device {res.outcome}, or the witness does not replay")
        table_verdicts[f"{workflow}-{clients}x{ops}"] = res.outcome.value
        line = (
            f"collector {workflow} {clients}x{ops} seed 4242: collected in {collect_s:.3f} s, "
            f"{len(events)} events, {len(hist.ops)} checked ops; device OK in {wall:.3f} s, "
            f"layers {res.stats.layers}, peak frontier {res.stats.max_frontier}, "
            f"host syncs {dev_mod.SYNCS[0] - syncs0}"
        )
        if ops < 2000:
            want_v = check(hist).outcome
            if want_v != res.outcome:
                fail(f"{workflow} {clients}x{ops}: device {res.outcome}, oracle {want_v}")
            if not replay_ok(hist, res.linearization):
                fail(f"{workflow} {clients}x{ops}: the pairwise replay check refuses the witness")
            bad = swap_real_time_pair(hist, list(res.linearization))
            if bad is None or replay_ok(hist, bad) or replay_fast(hist, bad):
                fail(f"{workflow} {clients}x{ops}: a witness with a real-time pair swapped "
                     "is not refused by both replay checks")
            line += (f"; == oracle {want_v.value}, both replay checks pass, and both refuse "
                     "the witness with a real-time pair swapped")
        print(line, flush=True)

    events, collect_s = collect("match-seq-num", 5, 2000, 20260729)
    buf = io.StringIO()
    ev.write_history(events, buf)
    digest = hashlib.sha256(buf.getvalue().encode("utf-8")).hexdigest()
    if digest != HEADLINE_SHA256:
        fail(f"headline JSONL sha256 {digest}, want {HEADLINE_SHA256}")
    print(f"collector headline match-seq-num 5x2000 seed 20260729: collected in {collect_s:.3f} s, "
          f"{len(events)} events, JSONL sha256 {digest} (pinned)", flush=True)
    with fb.recording_folds(dev_mod) as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fold_cuda.reset_launches()
        syncs0 = dev_mod.SYNCS[0]
        t0 = time.monotonic()
        rc, captured, stats = run_cli(events, "headline-5x2000")
        torch.cuda.synchronize()
        first_wall = time.monotonic() - t0
        collector_launches = dict(fold_cuda.LAUNCHES)
        syncs = dev_mod.SYNCS[0] - syncs0
        peak = torch.cuda.max_memory_allocated()
    res, hist = captured.get("res"), captured.get("hist")
    if rc != 0 or res is None or res.outcome.value != "ok":
        fail(f"headline: exit {rc}, outcome {res and res.outcome}")
    if res.linearization is None or not replay_fast(hist, res.linearization):
        fail("headline: the witness does not replay")
    got_stats = {k: stats.get(k) for k in HEADLINE_STATS}
    if got_stats != HEADLINE_STATS:
        fail(f"headline search statistics {got_stats}, the CPU run's {HEADLINE_STATS}")
    for name, count in collector_launches.items():
        if count == 0:
            fail(f"the collector path launched {name} no time")
    warm = []
    for _ in range(HEADLINE_WARM_CALLS):
        t0 = time.monotonic()
        res_w = dev_mod.check_device_auto(hist)
        torch.cuda.synchronize()
        warm.append(time.monotonic() - t0)
        if res_w.outcome.value != "ok" or not replay_fast(hist, res_w.linearization or []):
            fail("warm check_device_auto of the headline is not OK with a replaying witness")
    warm_median = sorted(warm)[len(warm) // 2]
    card_name = fb.card()
    print(
        f"headline check (CLI, in process): exit 0 OK, witness replays; {len(hist.ops)} checked ops; "
        f"layers {stats['layers']}, peak frontier {stats['max_frontier']}, expanded "
        f"{stats['expanded']} (== the CPU run); host syncs {syncs}, fold launches "
        f"{collector_launches['fold_lanes']}; first call {first_wall:.3f} s, warm "
        + ", ".join(f"{w:.3f}" for w in warm)
        + f" s; {len(hist.ops) / warm_median:.0f} ops verified per s "
        f"({'warm median' if len(warm) > 1 else 'one warm call'}); "
        f"peak memory {peak / 2**30:.3f} GiB; card {card_name}",
        flush=True,
    )
    print(f"cli stats: {json.dumps(stats)}", flush=True)
    headline_events, headline_walls = events, (first_wall, list(warm))

    # Every fold call of the headline again: bit-exact against the plain
    # fold (one plain fold per table over all its calls' lanes), then timed
    # in groups small enough to queue behind one spin kernel.
    if len(calls) != collector_launches["fold_lanes"]:
        fail(f"recorded {len(calls)} headline fold calls, counted {collector_launches['fold_lanes']}")
    steps = recheck_calls(calls, "headline")
    largest = max(range(len(calls)), key=lambda j: (steps[j], -j))
    at_headline = measure(calls[largest], f"headline call {largest + 1}, the largest by steps", reps=20)
    print(f"LAST_LAUNCH at the headline's largest call: {json.dumps(fold_cuda.LAST_LAUNCH)}", flush=True)
    kernels[0]["launches_by_path"] = {
        "adversarial k=10 batch=100 (main path)": kernels[0]["launches"],
        "collector 5x2000 match-seq-num headline": collector_launches["fold_lanes"],
    }
    kernels[0]["collector_call"] = {k: at_headline[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    del calls

    # -- 8. prune and speculation --------------------------------------------
    def stats_of(st, keys):
        return {k: getattr(st, k) for k in keys}

    adv_hist = prepare(main_events)
    adv_kw = dict(max_frontier=1 << 21, start_frontier=1 << 14, beam=False, collect_stats=True,
                  prune=True, speculate_depth=3)
    with fb.recording_folds(dev_mod) as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fold_cuda.reset_launches()
        syncs0 = dev_mod.SYNCS[0]
        t0 = time.monotonic()
        res = dev_mod.check_device(adv_hist, **adv_kw)
        torch.cuda.synchronize()
        first_wall = time.monotonic() - t0
        adv_launches = dict(fold_cuda.LAUNCHES)
        syncs = dev_mod.SYNCS[0] - syncs0
        peak = torch.cuda.max_memory_allocated()
    if res.outcome.value != "ok" or not replay_ok(adv_hist, res.linearization or []):
        fail(f"pruned adversarial k=10: outcome {res.outcome}, or the witness does not replay")
    got_stats = stats_of(res.stats, PRUNED_ADV_STATS)
    if got_stats != PRUNED_ADV_STATS:
        fail(f"pruned adversarial k=10 statistics {got_stats}, the JAX engine's {PRUNED_ADV_STATS}")
    if adv_launches["fold_lanes"] == 0:
        fail("the pruned adversarial path launched fold_lanes no time")
    warm = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res_w = dev_mod.check_device(adv_hist, **adv_kw)
        torch.cuda.synchronize()
        warm.append((time.monotonic() - t0, torch.cuda.max_memory_allocated()))
        if (res_w.outcome.value != "ok" or not replay_ok(adv_hist, res_w.linearization or [])
                or stats_of(res_w.stats, PRUNED_ADV_STATS) != PRUNED_ADV_STATS):
            fail("a warm pruned adversarial k=10 call differs from the first")
    print(
        f"pruned adversarial k=10 (check_device beam off, cap 2^21, first bucket 2^14, prune, "
        f"speculate_depth=3): OK, witness replays; statistics == the JAX engine's "
        f"{json.dumps(got_stats)}; host syncs {syncs}, fold launches {adv_launches['fold_lanes']}; "
        f"first call {first_wall:.3f} s, peak memory {peak / 2**30:.3f} GiB; warm "
        + ", ".join(f"{w:.3f} s ({m / 2**30:.3f} GiB)" for w, m in warm),
        flush=True,
    )
    if len(calls) != adv_launches["fold_lanes"]:
        fail(f"recorded {len(calls)} pruned adversarial fold calls, counted {adv_launches['fold_lanes']}")
    recheck_calls(calls, "pruned adversarial k=10")
    del calls

    pruned_args = ["--prune", "--speculate-depth", "3"]
    with fb.recording_folds(dev_mod) as calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fold_cuda.reset_launches()
        syncs0 = dev_mod.SYNCS[0]
        t0 = time.monotonic()
        rc, captured, stats = run_cli(events, "headline-5x2000-pruned", pruned_args)
        torch.cuda.synchronize()
        first_wall = time.monotonic() - t0
        head_launches = dict(fold_cuda.LAUNCHES)
        syncs = dev_mod.SYNCS[0] - syncs0
        peak = torch.cuda.max_memory_allocated()
    res = captured.get("res")
    if rc != 0 or res is None or res.outcome.value != "ok":
        fail(f"pruned headline: exit {rc}, outcome {res and res.outcome}")
    if res.linearization is None or not replay_fast(hist, res.linearization):
        fail("pruned headline: the witness does not replay")
    got_stats = {k: stats.get(k, 0) for k in PRUNED_HEADLINE_STATS}
    if got_stats != PRUNED_HEADLINE_STATS:
        fail(f"pruned headline statistics {got_stats}, the JAX engine's {PRUNED_HEADLINE_STATS}")
    if head_launches["fold_lanes"] == 0:
        fail("the pruned headline launched fold_lanes no time")
    warm = []
    for _ in range(HEADLINE_WARM_CALLS):
        t0 = time.monotonic()
        res_w = dev_mod.check_device_auto(hist, prune=True, speculate_depth=3)
        torch.cuda.synchronize()
        warm.append(time.monotonic() - t0)
        if res_w.outcome.value != "ok" or not replay_fast(hist, res_w.linearization or []):
            fail("warm pruned check_device_auto of the headline is not OK with a replaying witness")
    # Kernels per layer: a 100-layer window from the middle of one more
    # call, under the profiler (the whole call's launches would take the
    # profiler longer to process than the search).
    box: dict = {}
    start = (PRUNED_HEADLINE_STATS["layers"] - 100) // 2
    real_expand = dev_mod._expand_layer
    dev_mod._expand_layer = breakdown.profiled_window(real_expand, start, 100, box)
    try:
        dev_mod.check_device_auto(hist, prune=True, speculate_depth=3)
        torch.cuda.synchronize()
    finally:
        dev_mod._expand_layer = real_expand
    if "wall" not in box:
        fail(f"pruned headline: the search expanded fewer than {start + 100} layers")
    window = breakdown.busy(box["prof"], box["wall"])
    print(
        f"pruned headline check (CLI --prune --speculate-depth 3, in process): exit 0 OK, witness "
        f"replays; statistics == the JAX engine's {json.dumps(got_stats)}; host syncs {syncs} "
        f"(un-pruned: see above), fold launches {head_launches['fold_lanes']}; first call "
        f"{first_wall:.3f} s, warm " + ", ".join(f"{w:.3f}" for w in warm)
        + f" s; {len(hist.ops) / min(warm):.0f} ops verified per s "
        f"({'best warm' if len(warm) > 1 else 'one warm call'}); peak memory "
        f"{peak / 2**30:.3f} GiB; profiled window of 100 layers ({start}-{start + 100}): "
        f"{window['kernels']} kernels ({window['kernels'] / 100:.1f} a layer), {box['syncs']} host "
        f"syncs, {box['wall']:.3f} s, device busy {window['device_busy_ms']:.2f} ms "
        f"({100 * window['device_busy_share']:.2f}% under the profiler); card {fb.card()}",
        flush=True,
    )
    print(f"cli stats: {json.dumps(stats)}", flush=True)
    if len(calls) != head_launches["fold_lanes"]:
        fail(f"recorded {len(calls)} pruned headline fold calls, counted {head_launches['fold_lanes']}")
    recheck_calls(calls, "pruned headline")
    del calls

    from s2_verification_tpu_torch.collector.campaign import (
        VIOLATION_CLASSES,
        builtin_campaigns,
        collect_labeled,
    )

    classes = set()
    calls, camp_launches = [], 0
    for name, camp in sorted(builtin_campaigns().items()):
        events_c, label = collect_labeled(camp, seed=CAMPAIGN_SEED)
        hist_c = prepare(events_c)
        fold_cuda.reset_launches()
        with fb.recording_folds(dev_mod) as pruned_calls:
            t0 = time.monotonic()
            pruned = dev_mod.check_device_auto(hist_c, prune=True, speculate_depth=3, collect_stats=True)
            torch.cuda.synchronize()
            t1 = time.monotonic()
        camp_launches += fold_cuda.LAUNCHES["fold_lanes"]
        calls += pruned_calls
        plain = dev_mod.check_device_auto(hist_c, collect_stats=True)
        torch.cuda.synchronize()
        t2 = time.monotonic()
        expect = label.get("expect")
        if pruned.outcome != plain.outcome:
            fail(f"campaign {name}: pruned {pruned.outcome.value}, un-pruned {plain.outcome.value}")
        if pruned.outcome.value in ("ok", "illegal") and pruned.outcome.value != {
            "legal": "ok", "illegal": "illegal"
        }.get(expect):
            fail(f"campaign {name}: {pruned.outcome.value} against its label {expect}")
        if pruned.outcome.value == "ok" and not replay_fast(hist_c, pruned.linearization or []):
            fail(f"campaign {name}: the pruned witness does not replay")
        if camp.violation_class() is not None:
            classes.add(camp.violation_class())
        ps = pruned.stats
        print(
            f"campaign {name} (seed {CAMPAIGN_SEED}, {len(hist_c.ops)} ops, label {expect}): pruned "
            f"{pruned.outcome.value} in {t1 - t0:.3f} s (layers {ps.layers}, peak frontier "
            f"{ps.max_frontier}, commits {ps.prune_commits}, dead {ps.prune_dead}, spec "
            f"layers/accepts/rollbacks {ps.spec_layers}/{ps.spec_accepts}/{ps.spec_rollbacks}) "
            f"== un-pruned {plain.outcome.value} in {t2 - t1:.3f} s (layers {plain.stats.layers})",
            flush=True,
        )
    if len(calls) != camp_launches:
        fail(f"recorded {len(calls)} pruned campaign fold calls, counted {camp_launches}")
    if set(VIOLATION_CLASSES) - classes:
        fail(f"violation classes never exercised: {sorted(set(VIOLATION_CLASSES) - classes)}")
    if camp_launches == 0:
        fail("the pruned campaign runs launched fold_lanes no time")
    recheck_calls(calls, "pruned campaign matrix")
    del calls
    kernels[0]["launches_by_path"].update({
        "adversarial k=10 batch=100, check_device beam off, prune, speculate_depth=3": adv_launches["fold_lanes"],
        "collector headline, --prune --speculate-depth 3": head_launches["fold_lanes"],
        "campaign matrix (9 histories), pruned, speculate_depth=3": camp_launches,
    })

    # -- 9. the chunked device-resident tier -------------------------------
    tier = run_tier_phase(dev_mod, fold_cuda, xxh3, fb, prepare, adversarial_events, main_events,
                          recheck_calls, clocks, sm_hz, stats_of)
    kernels[0]["launches_by_path"].update(tier["launches_by_path"])
    kernels[0]["chunked_call"] = tier["chunked_call"]

    # -- 10. the host-RAM spill and checkpoints ----------------------------
    t_phase = time.monotonic()
    spill = run_spill_phase(dev_mod, fold_cuda, xxh3, fb, prepare, adversarial_events, run_cli,
                            recheck_calls, clocks, sm_hz, stats_of, counting_chunks)
    print(f"phase 10 (spill and checkpoints): {time.monotonic() - t_phase:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(spill["launches_by_path"])
    kernels[0]["spill_call"] = spill["spill_call"]

    # -- 11. the check command ---------------------------------------------
    phase11 = run_check_phase(dev_mod, fold_cuda, fb, prepare, adversarial_events, cli, ev, recheck_calls,
                              table_events, table_verdicts, events)
    print(f"phase 11 (the check command): {phase11['seconds']:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(phase11["launches_by_path"])

    # -- 12. batched lanes ---------------------------------------------------
    phase12 = run_batch_phase(dev_mod, fold_cuda, fb, prepare, recheck_calls, measure,
                              headline_events, headline_walls)
    print(f"phase 12 (batched lanes): {phase12['seconds']:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(phase12["launches_by_path"])
    kernels[0]["batched_call"] = {k: phase12["batched_call"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}

    # -- 13. the mesh --------------------------------------------------------
    phase13 = run_mesh_phase(dev_mod, distributed, fold_cuda, fb, prepare, adversarial_events, recheck_calls,
                             main_events)
    print(f"phase 13 (the mesh): {phase13['seconds']:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(phase13["launches_by_path"])

    print(f"kernels: {', '.join(k['name'] for k in kernels)}", flush=True)
    print(f"total {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
