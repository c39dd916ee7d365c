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
   :data:`HEADLINE_STATS`, and its wall (:data:`HEADLINE_WARM_CALLS`); every
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
   syncs, wall, and the kernels per layer of a
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
   (but (a), (b) and (d)),
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
   through ``check_batch_vmap`` on the card, every lane OK, with the
   group's wall (one launch since phase 15), loop iterations, host syncs and
   fold launches per iteration and peak memory beside phase 7's
   ``-backend=device`` walls (the headline lane alone through
   ``run_search`` is not run since phase 18); (b) the campaign matrix (seed 11)
   in one launch, each decided lane equal to its label and an undecided one
   only where it pruned; (c) ``check_batch_native`` over the same lanes
   equal to ``check_native`` lane by lane, and every lane the card decided
   equal to the native verdict; (d) every fold call of (a)'s launch and of
   (b) bit-exact against the plain fold, and the largest measured;
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
14. the supervised device escalation (``checker/resilient.py``,
   ``service/supervise.py``, ``service/devicepool.py``), every search in a
   bounded child process beside this one: (a) the probe child answers;
   (b) ``supervised_device_check`` of the main path's history, with no
   ``device=``, decides OK with a witness that replays and the steps and
   statistics of the same ``check_device_auto`` call in this process,
   and says whether the child built a library; (c) a child killed (from a
   wrapper, :data:`CRASH_AFTER_SAVES`) right after its second checkpoint
   save is relaunched by ``drive`` and resumes to the same verdict and
   counts in exactly two attempts; (d) a one-slot ``DevicePool`` grant runs
   the mesh in the child, whose ``stats.shards`` feed a ``ServiceStats``'s
   ``verifyd_shard_*`` families; (e) a cancel after the child's first
   spooled heartbeat (phase 7's headline) returns None with no relaunch,
   and the child's process group is gone within ``grace_s + 1`` s.  Each
   sub-phase's wall is printed with the card's name and power limit; the
   children's fold launches are the ones each child reports;
15. verifyd, the resident daemon (``service/daemon.py``): the port's
   ``serve`` as its own process (through :data:`VERIFYD_WRAPPER`, which
   records each job's result and every fold call of the processes that
   search on the card), driven with the port's ``submit`` CLI and
   ``VerifydClient``: (a) ``--device supervised --time-budget 2``: the main
   path's k=10 escalates to a supervised child — OK, backend
   ``device-supervised``, no ``degrade`` event, the child's fold launches
   > 0 (as the daemon's ``stats`` op counts them), a witness that replays
   and the steps and statistics of ``check_device_auto`` in this process
   (:data:`K10_DEVICE_STATS`); resubmitted, a cache hit; (b) the headline
   decided on the native rung, as the one-shot ``check`` decides it, and an
   unsatisfiable history refused with an HTML artifact naming the refused
   ops; (c) phase 12's 16 lanes at once from 16 client threads to a
   daemon with ``--workers 4``: the burst wall, ops verified per second,
   p50 / p95 submit latency, the daemon's counts and queue peak, every
   verdict equal to phase 12's; (d) ``--device inline``: the k=10 and its
   client-id twin (:func:`client_twin`, a cache miss with the same search),
   each ``device-inline`` with the fold launches counted in the daemon
   process and the witness and statistics of (a), the walls beside (a)'s;
   (e) the unsatisfiable k=10 under ``--deadline 20``: ``DeadlineExceeded``
   while the child searches, its process group gone within
   ``--deadline-grace``, the daemon still answering; (f) a signed TCP
   submit answered as the unix socket answers, a wrong secret refused
   before admission, and SIGTERM under ``--drain-timeout 30`` with a job in
   flight: answered, exit 0; then every recorded fold call bit-exact
   against the plain fold;
16. verifyd's durability and ops layer: the port's ``serve`` as its own
   process (through :data:`VERIFYD_WRAPPER`) on one ``--state-dir``, over
   three boots: (a) ``--device inline --state-dir D --telemetry-dir
   D/telemetry --metrics-port 0 --alert-url`` (a receiver this script runs
   on 127.0.0.1) ``--alert-rule done``: k=10 past a 2 s CPU budget decides
   on the card with :data:`K10_DEVICE_STATS` and (a)'s witness, ``/metrics``
   answers in OpenMetrics with the fold's launch count, ``/dashboard``
   renders, the ``tsq`` op returns the jobs series, the ``profiles`` op
   lists the job and the receiver gets the ``done`` alert; (b) k=10's
   client-id twin submitted and the daemon SIGKILLed once the wrapper has
   recorded the twin's first fold call: ``doctor --state-dir`` on the
   killed boot's files names the orphan, and the next boot charges one
   crash to its fingerprint (below the threshold of 3), replays it first
   onto the card again (the pinned statistics, its launches counted in the
   daemon) and answers the twin from ``D/verdicts``; (c) after a SIGTERM
   drain, a third boot under ``--device supervised`` (no torch in the
   daemon) answers k=10 and the twin from ``D/verdicts`` with no fold
   launch, no CPU rung and no child, and a cold ``tsq --telemetry-dir``
   agrees with what its live ``tsq`` op gave; then every fold call of the
   phase bit-exact against the plain fold;
17. batching, prefix resume and the operator commands: the port's
   ``serve`` as its own process (through :data:`VERIFYD_WRAPPER`): (a)
   ``--device inline --batching --batch-engine vmap --time-budget 2
   --workers 1``: the eight match-seq-num 5×200 histories of
   :data:`PHASE17_SEEDS` (one shape key, printed) from eight client threads
   at once, sent once the one worker has started phase 7's headline (so
   the burst queues behind a busy worker): every verdict equal to the
   one-shot ``check``'s, at least one vmap launch of two lanes or more,
   every lane decided by the vmap launches (the ``batch_launch`` events:
   lanes, decided, early exits, occupancy, wall; every reply's backend
   ``batch-vmap``), the fold launched in the daemon, the
   burst's wall, p50 / p95 and ops/s beside a daemon without
   ``--batching``; (b) ``--device supervised --prefix --state-dir D
   --time-budget 2``: ``follow`` over phase 7's headline in windows of
   :data:`FOLLOW_WINDOW` events (every window OK and carried, no fold
   launch), the daemon SIGKILLed after half of them and the next boot
   carrying on from ``--frontier`` with no resync, the rest of the stream
   answered as one window; 60% of the headline at a closed cut and then
   the whole headline (a ``prefix_hit`` with ``resume_ops`` > 0, the
   verdict of a cold ``check``); the main path's k=10, whose cold prefix
   plan runs out of the budget and escalates to a supervised child (11
   fold launches, :data:`K10_DEVICE_STATS`); (c) ``trace``, ``watch`` and
   one ``dash`` frame against (b)'s daemon, exit 0 each; then every fold
   call of the phase bit-exact against the plain fold;
18. the fleet tier (``service/router.py``, ``service/distsearch.py``,
   ``obs/federate.py``, ``service/soak.py``): two of the port's ``serve``
   backends as their own processes (through :data:`VERIFYD_WRAPPER`, fold
   calls saved as they happen), each ``--device inline --time-budget 2
   --state-dir Di --metrics-port Pi --drain-timeout 30`` on the one card,
   behind the port's ``route serve --backend a=...@healthz --backend
   b=...@healthz --metrics-port 0 --state-dir DR``: (a) the main path's k=10
   through the router, decided on its ring home's card (OK,
   :data:`K10_DEVICE_STATS`, a witness that replays, its fold launches
   counted on that node) and resubmitted, answered from the router's edge
   cache with no launch; (b) k=10's client-id twin (:func:`client_twin`),
   its home node SIGKILLed once the twin's escalation has launched the
   fold: the router fails over to the other node, which decides it on the
   card with the same statistics, the victim restarts on its state dir and
   replays the orphan on the card, and ``route fleet`` shows both nodes up;
   (c) ``/fleet/metrics`` carries both nodes'
   ``verifyd_kernel_launches_total`` under their ``node`` labels, equal to
   each node's own ``/metrics``, and the stitched ``trace`` holds router and
   backend spans; (d) ``submit --distributed`` of
   :func:`dist_workload` (the shape of the JAX package's
   ``scripts/distsearch_check.py:72``), whose verdict equals the port's
   ``check_frontier_auto`` on the host, with zero stale deltas merged and
   the grant ledger, read cold, closed with zero open grants; (e) ``route
   drain a``: the backend exits 0 and the router answers on b; (f) ``soak``
   through the router over two builtin campaigns (``steady``, legal, and
   ``drop-acked``, a violation) exits 0, and with ``--mislabel-control``
   exits 1 while a receiver this script runs gets the
   ``checker_false_verdict`` webhook; then every fold call of the phase
   bit-exact against the plain fold;
19. ``lint`` on the host, from the checkout: ``python -m
   s2_verification_tpu_torch lint --json`` exits 0 with no new error and
   no stale baseline key, in a process that imports neither torch, jax
   nor the JAX package, and prints its files, findings, suppressions and wall; ``lint
   --check-events-md`` exits 0;
20. the kernel list, one JSON line of kernel measurements, and as the last
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
import dataclasses
import hashlib
import io
import json
import logging
import os
import re
import signal
import socket
import subprocess
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
#: warm calls of the headline in phases 7 and 8, plain and pruned: none
#: since phase 15, for the script's time limit (their first calls run
#: after phases 1–6 have warmed the CUDA context, kernels and allocator;
#: phase 12 runs the headline's shape for about 10,000 layers)
HEADLINE_WARM_CALLS = 0


def walls_text(first: float, warm: list, ops: int) -> str:
    """``first call ... s[, warm ... s]; N ops verified per s (...)``, the
    rate over the warm median, or over the first call without warm calls."""
    rate_wall = sorted(warm)[len(warm) // 2] if warm else first
    what = "warm median" if len(warm) > 1 else ("one warm call" if warm else "the first call")
    warm_s = (", warm " + ", ".join(f"{w:.3f}" for w in warm) + " s") if warm else ""
    return f"first call {first:.3f} s{warm_s}; {ops / rate_wall:.0f} ops verified per s ({what})"
#: phase 12's launch group: lanes of the headline's shape, the headline
#: first and then one lane a seed of these (16 lanes, the daemon's default
#: ``--batch-max``)
BATCH_SHAPE = ("match-seq-num", 5, 2000)
BATCH_SEEDS = list(range(20260730, 20260745))
#: phase 15: the main path's k=10 through ``check_device_auto(profile=True)``
#: in process and in verifyd's supervised child, as phase 14 (b) measures it
#: on the H100 (PERF.md §6)
K10_DEVICE_STATS = {"layers": 7, "max_frontier": 65536, "expanded": 506362, "host_syncs": 30}
#: phase 14: a wrapper around the supervised child's entry point
#: (``service/supervise.py::_child_main``), written to a temporary file and
#: run as ``python WRAPPER MARKER SAVES EVERY HIST CKPT OUT [extras]``: it
#: lowers ``check_device_auto``'s ``checkpoint_every`` to EVERY and, when
#: MARKER is absent, creates it and SIGKILLs its own process right after
#: checkpoint save number SAVES — a crash with no cleanup, from outside the
#: product code.  A relaunch finds MARKER and runs to its end.
CRASH_AFTER_SAVES = """\
import functools, os, signal, sys
from s2_verification_tpu_torch.checker import device
from s2_verification_tpu_torch.service import supervise

marker, saves, every = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
device.check_device_auto = functools.partial(device.check_device_auto, checkpoint_every=every)
real_save, done = device.save_checkpoint, []


def save_then_die(path, ckpt):
    real_save(path, ckpt)
    done.append(path)
    if len(done) == saves and not os.path.exists(marker):
        open(marker, "w").close()
        os.kill(os.getpid(), signal.SIGKILL)


device.save_checkpoint = save_then_die
sys.exit(supervise._child_main(sys.argv[4:]))
"""
#: phase 15: a wrapper around the port's CLI, written to a temporary file and
#: run as ``python WRAPPER RECORD serve-supervised|serve-inline ARGS`` (the
#: daemon: ``cli.main(ARGS)``) or ``python WRAPPER RECORD child ARGS`` (a
#: supervised child: ``supervise._child_main(ARGS)``).  It observes and
#: changes nothing the product decides: the daemon's ``Scheduler._finish``
#: writes each decided job's result (backend, outcome, witness, steps,
#: statistics, refused ops, a child's launches) to
#: ``RECORD/job-<daemon pid>-<job id>.json``;
#: the daemon launches its supervised children through this file; and the
#: processes that search on the card (a child, an inline daemon) save every
#: ``fold_lanes`` call's inputs to ``RECORD/folds-<role>-<pid>.pt`` when they
#: exit.  A supervised daemon never imports torch through it.  With
#: ``VERIFYD_RECORD_LIVE`` set (phase 16), the fold calls are saved after
#: every call instead, and ``RECORD/fold-count-<pid>`` holds their number,
#: so a process SIGKILLed mid-search leaves its calls behind.
VERIFYD_WRAPPER = """\
import dataclasses, json, os, sys

record, role, argv = sys.argv[1], sys.argv[2], sys.argv[3:]


def record_folds():
    import atexit
    import torch
    from s2_verification_tpu_torch.checker import device

    calls, tables = [], []
    real = device.fold_lanes

    live = bool(os.environ.get("VERIFYD_RECORD_LIVE"))

    def recording(seed, row, length, rh):
        if not tables or tables[-1][0] is not rh:
            tables.append((rh, rh.detach().cpu().clone()))
        calls.append([t.detach().cpu().clone() for t in (seed, row, length)] + [len(tables) - 1])
        out = real(seed, row, length, rh)
        if live:
            save()
            count = os.path.join(record, f"fold-count-{os.getpid()}")
            with open(count + ".tmp", "w") as f:
                f.write(str(len(calls)))
            os.replace(count + ".tmp", count)
        return out

    def save():
        if calls:
            path = os.path.join(record, f"folds-{role}-{os.getpid()}.pt")
            torch.save({"calls": calls, "tables": [t for _, t in tables]}, path + ".tmp")
            os.replace(path + ".tmp", path)

    device.fold_lanes = recording
    atexit.register(save)


if role == "child":
    record_folds()
    from s2_verification_tpu_torch.service import supervise

    sys.exit(supervise._child_main(argv))

from s2_verification_tpu_torch import cli
from s2_verification_tpu_torch.checker import resilient
from s2_verification_tpu_torch.service import scheduler

real_drive, real_finish = resilient.drive, scheduler.Scheduler._finish


def drive(cmd, **kw):
    at = cmd.index("-m")
    return real_drive([cmd[0], os.path.abspath(__file__), record, "child", *cmd[at + 2:]], **kw)


def finish(self, job, res, backend, **kw):
    reply = real_finish(self, job, res, backend, **kw)
    st = getattr(res, "stats", None)
    rec = {
        "pid": os.getpid(), "job": job.id, "backend": backend, "outcome": res.outcome.value,
        "linearization": res.linearization, "steps": res.steps,
        "stats": None if st is None else dataclasses.asdict(st),
        "refused": sorted({job.hist.ops[i].op_id for _p, r in res.refusals or [] for i in r}),
        "child_launches": getattr(res, "child_launches", None),
    }
    with open(os.path.join(record, f"job-{os.getpid()}-{job.id}.json"), "w", encoding="utf-8") as f:
        json.dump(rec, f)
    return reply


resilient.drive, scheduler.Scheduler._finish = drive, finish
if role == "serve-inline":
    record_folds()
sys.exit(cli.main(argv))
"""
#: phase 17 (a): ``TABLE_CONFIGS``' match-seq-num 5×200 at the seeds from
#: 4242 up whose histories share the shape key ``1024x12x16`` (seeds
#: 4242–4249 give three keys: 1024x8x16, 1024x12x16 and 1024x16x16), so
#: the eight form one shape group
PHASE17_SHAPE = ("match-seq-num", 5, 200)
PHASE17_SEEDS = [4244, 4245, 4249, 4250, 4251, 4254, 4255, 4256]
#: phase 17 (b): the follow window, in events
FOLLOW_WINDOW = 2048
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

    # (a) The tier hands the unsatisfiable k=8 to the spill.  No warm call
    # since phase 17, for the script's time limit: with it the script took
    # 958.6 s on an H100 at 700 W, 14.3 s of it in this warm call.
    k8 = prepare(adversarial_events(8, batch=100, seed=0, unsatisfiable=True))
    kw_a = dict(max_frontier=1 << 10, device_rows_cap=SPILL_K8_ROWS, beam=False, spill=True, collect_stats=True)
    tag = "spill (a): unsatisfiable k=8, 2^10-row bucket, tier to 2^16 rows, then the spill"
    _, first = first_and_warm(tag, lambda: dev_mod.check_device(k8, **kw_a), "illegal", TIER_K8_UNSAT_STATS,
                              SPILL_K8_SLABS, warm_calls=0)
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
    # No warm call of (d) since phase 15 (for the script's time limit): it
    # repeated the first call's search.

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
    # (d), for (a): its fold calls.  No warm launch of the group since
    # phase 15, for the script's time limit (116-128 s on the H100).
    group_calls = first.pop("calls")
    steps = recheck_calls(group_calls, "batched lanes (a)")
    largest = max(range(len(group_calls)), key=lambda j: (steps[j], -j))
    out["batched_call"] = measure(group_calls[largest], f"batched lanes (a) call {largest + 1}, the largest by steps")
    del group_calls

    # The headline lane alone is not run since phase 18 (for the script's
    # time limit: 27.9 s on the H100); its layers through check_device stand
    # beside the group's.
    cli_first, cli_warm = headline_walls
    print(
        f"batched lanes (a): check_batch_vmap of {len(lanes)} lanes at capacity {batched.VMAP_LANE_CAPACITY}: "
        f"every lane OK, layers per lane {layers} (the headline lane {layers[0]}; its pinned count through "
        f"check_device {HEADLINE_STATS['layers']}); first call {first['wall']:.3f} s ({per_iter(first)}, peak "
        f"memory {first['peak'] / 2**30:.3f} GiB with its fold inputs recorded), "
        f"{sum(len(h.ops) for h in hists) / first['wall']:.0f} ops verified per s; the headline through check "
        f"-backend=device in phase 7: {walls_text(cli_first, cli_warm, len(hists[0].ops))}; card {card}",
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
    out["lane_events"] = events
    out["lane_verdicts"] = [v.result.outcome.value for v in first["verdicts"]]
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


def _group_of(needle: str) -> int | None:
    """The process group of the one process whose command line holds
    ``needle`` (a supervised child's spool path), from /proc."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if needle.encode() in f.read():
                    return os.getpgid(int(pid))
        except OSError:
            continue
    return None


def _group_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
        return True
    except ProcessLookupError:
        return False


def run_supervise_phase(dev_mod, fb, prepare, events, long_events, device=None, crash_every=2,
                        attempt_timeout_s=300.0, grace_s=2.0) -> dict:
    """Phase 14, the supervised device escalation (``checker/resilient.py``,
    ``service/supervise.py``, ``service/devicepool.py``): every search runs
    in a bounded child process that this one never shares a card with.
    ``events`` is the main path's history, ``long_events`` one that runs
    long enough to spool heartbeats (phase 7's headline); ``device=None``
    is the card, ``"cpu"`` rehearses the phase on the CPU.  Returns the
    children's fold launches by path and the sub-phases' walls."""
    from s2_verification_tpu_torch.checker.progress import ProgressSink
    from s2_verification_tpu_torch.checker.resilient import DriveOutcome, default_probe_cmd, drive
    from s2_verification_tpu_torch.obs.trace import Tracer
    from s2_verification_tpu_torch.service import supervise
    from s2_verification_tpu_torch.service.devicepool import DevicePool
    from s2_verification_tpu_torch.service.scheduler import shape_key
    from s2_verification_tpu_torch.service.stats import ServiceStats

    t_phase = time.monotonic()
    card = fb.card()
    here = os.path.dirname(os.path.abspath(__file__))
    # The children import the port from this checkout, whatever their cwd.
    os.environ["PYTHONPATH"] = os.pathsep.join([here, *filter(None, [os.environ.get("PYTHONPATH")])])
    out = {"launches_by_path": {}, "walls": {}}
    hist = prepare(events)
    shape = shape_key(hist)
    extra = [] if device is None else [f"device={device}"]
    probe_cmd = default_probe_cmd(device) if device is None else None

    def attempts_of(said):
        """Attempts ``drive`` launched, from its log lines."""
        return sum(1 for s in said if re.match(r"attempt \d+: ", s))

    def wall(tag, seconds):
        out["walls"][tag] = seconds
        print(f"supervised {tag}: {seconds:.3f} s wall; {card}", flush=True)

    if device is None:
        # The parent keeps its context, but hands its cached blocks back.
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        torch.cuda.empty_cache()
        print(f"supervised: parent's reserved card memory {before} B -> {torch.cuda.memory_reserved()} B "
              "after empty_cache", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the probe child answers.
        t0 = time.monotonic()
        probe = subprocess.run(default_probe_cmd(device), capture_output=True, text=True, timeout=300)
        if probe.returncode != 0:
            fail(f"supervised (a): the probe child exited {probe.returncode}: {probe.stderr[-2000:]}")
        print(f"supervised (a): the probe child printed {probe.stdout.strip()}", flush=True)
        wall("(a) probe", time.monotonic() - t0)

        # (b) the main path's history in a supervised child, against the same
        # call in this process.
        said: list[str] = []
        t0 = time.monotonic()
        res = supervise.supervised_device_check(
            events, spool_dir=tmp, job_id=1, profile=True, attempt_timeout_s=attempt_timeout_s,
            log=said.append, device=device,
        )
        wall_b = time.monotonic() - t0
        if res is None:
            fail(f"supervised (b): the supervised check returned None (the device never answered): {said}")
        t0 = time.monotonic()
        ref = dev_mod.check_device_auto(hist, checkpoint_path=os.path.join(tmp, "ref.ckpt.npz"), profile=True,
                                        device=device)
        wall_ref = time.monotonic() - t0
        if res.outcome.value != "ok" or ref.outcome.value != "ok":
            fail(f"supervised (b): child {res.outcome.value}, in process {ref.outcome.value}; want ok")
        if not replay_ok(hist, res.linearization):
            fail("supervised (b): the child's witness does not replay")
        got, want = _stats_view(res.stats), _stats_view(ref.stats)
        if res.steps != ref.steps or got != want:
            fail(f"supervised (b): the child's steps/stats {res.steps} {got} != in process {ref.steps} {want}")
        built = res.child_jit.get("compiles") or {}
        launches = res.child_launches.get("fold_lanes", 0)
        out["launches_by_path"]["adversarial k=10 in a supervised child, beam then exhaustive (14b)"] = launches
        print(
            f"supervised (b): {shape} decided {res.outcome.value} in {attempts_of(said)} attempt(s), "
            f"{wall_b:.3f} s wall (in process, warm: {wall_ref:.3f} s); witness replays, equal to the "
            f"in-process witness: {res.linearization == ref.linearization}; steps and stats equal the "
            f"in-process run's ({got}); the child's fold launches {launches}; the child built "
            f"{'nothing (libraries loaded from _build/)' if not built else built}",
            flush=True,
        )
        wall("(b) supervised k=10", wall_b)

        # (c) a child killed after its second checkpoint save resumes.
        wrapper = os.path.join(tmp, "crash_after_saves.py")
        with open(wrapper, "w", encoding="utf-8") as f:
            f.write(CRASH_AFTER_SAVES)
        hist_path, ckpt, res_path, marker = (os.path.join(tmp, n) for n in ("c.jsonl", "c.ckpt.npz", "c.json", "c.killed"))
        with open(hist_path, "w", encoding="utf-8") as f:
            from s2_verification_tpu_torch.utils import events as ev

            ev.write_history(events, f)
        said = []
        tracer = Tracer(64)
        t0 = time.monotonic()
        outcome = drive(
            [sys.executable, wrapper, marker, "2", str(crash_every), hist_path, ckpt, res_path, "profile=1", *extra],
            done=lambda: os.path.exists(res_path), attempt_timeout_s=attempt_timeout_s, max_restarts=2,
            probe_cmd=probe_cmd, log=said.append, tracer=tracer,
        )
        wall_c = time.monotonic() - t0
        if outcome != DriveOutcome(True, 2, 0, "conclusive") or not os.path.exists(marker):
            fail(f"supervised (c): {outcome}, marker {os.path.exists(marker)}; want 2 attempts: {said}")
        with open(res_path, encoding="utf-8") as f:
            resumed = supervise._result_from_json(json.load(f))
        keys = ("layers", "max_frontier", "expanded", "auto_closed", "pruned")
        got = {k: getattr(resumed.stats, k) for k in keys}
        want = {k: getattr(ref.stats, k) for k in keys}
        if resumed.outcome != ref.outcome or resumed.steps != ref.steps or got != want:
            fail(f"supervised (c): resumed {resumed.outcome.value} {resumed.steps} {got}, "
                 f"in process {ref.outcome.value} {ref.steps} {want}")
        if not replay_ok(hist, resumed.linearization):
            fail("supervised (c): the resumed child's witness does not replay")
        left = [n for n in os.listdir(tmp) if n.startswith("c.ckpt")]
        if left:
            fail(f"supervised (c): the conclusive run left its snapshot behind: {left}")
        spans = {e["name"]: e["dur"] / 1e6 for e in tracer.export()["traceEvents"] if e.get("ph") == "X"}
        out["launches_by_path"]["adversarial k=10, relaunched after a kill at its second save (14c)"] = (
            resumed.child_launches.get("fold_lanes", 0))
        print(
            f"supervised (c): killed after checkpoint save 2 (checkpoint_every={crash_every}), resumed to "
            f"{resumed.outcome.value} with the in-process counts {got} in {outcome.attempts} attempts; "
            f"attempt 1 {spans.get('attempt 1', 0):.3f} s, probe between attempts "
            f"{spans.get('backend_probe', 0):.3f} s, attempt 2 {spans.get('attempt 2', 0):.3f} s; the resumed "
            f"attempt's host syncs {resumed.stats.host_syncs} (the whole run's in process: "
            f"{ref.stats.host_syncs}), its fold launches {resumed.child_launches.get('fold_lanes', 0)}; "
            "snapshots removed",
            flush=True,
        )
        wall("(c) kill and resume", wall_c)

        # (d) a one-slot DevicePool grant runs the mesh in the child.
        stats = ServiceStats(None)
        pool = DevicePool(1, stats=stats)
        t0 = time.monotonic()
        lease = pool.acquire(shape=shape, job=4, timeout_s=0)
        if lease is None:
            fail("supervised (d): DevicePool(1) granted nothing")
        try:
            res_d = supervise.supervised_device_check(
                events, spool_dir=tmp, job_id=4, devices=lease.indices, attempt_timeout_s=attempt_timeout_s,
                device=device,
            )
        finally:
            pool.release(lease)
        wall_d = time.monotonic() - t0
        if res_d is None or res_d.outcome != ref.outcome or len(res_d.stats.shards) != lease.size:
            fail(f"supervised (d): {res_d and res_d.outcome.value}, shards "
                 f"{res_d and res_d.stats.shards}; want ok with {lease.size} shard(s)")
        got = {k: getattr(res_d.stats, k) for k in keys}
        if got != want:
            fail(f"supervised (d): the mesh child's counts {got} != the unsharded run's {want}")
        stats.emit("done", job=4, wall_s=wall_d, verdict=0, backend=f"device-mesh[{lease.size}]",
                   shape=shape, shards=res_d.stats.shards)
        out["launches_by_path"][f"adversarial k=10, a {lease.size}-slot DevicePool grant in a child (14d)"] = (
            res_d.child_launches.get("fold_lanes", 0))
        print(f"supervised (d): grant {list(lease.indices)} of DevicePool(1) for {shape}: "
              f"{res_d.outcome.value} with the unsharded counts, stats.shards {res_d.stats.shards}, "
              f"fold launches {res_d.child_launches.get('fold_lanes', 0)}", flush=True)
        for line in stats.registry.render().splitlines():
            if (line.startswith(("verifyd_shard_", "verifyd_leases_granted", "verifyd_devices_leased"))
                    and "_bucket{" not in line):
                print(f"  {line}", flush=True)
        wall("(d) DevicePool grant", wall_d)

        # (e) a cancel after the first spooled heartbeat stops the child.
        said, beats, seen = [], [], {}
        progress_path = os.path.join(tmp, "job5.progress.json")
        hist_e = os.path.join(tmp, "job5.jsonl")

        def cancel():
            if "t" not in seen and os.path.exists(progress_path):
                seen["pgid"] = _group_of(hist_e)
                seen["t"] = time.monotonic()
            return "smoke cancel" if "t" in seen else None

        t0 = time.monotonic()
        res_e = supervise.supervised_device_check(
            long_events, spool_dir=tmp, job_id=5, attempt_timeout_s=attempt_timeout_s, log=said.append,
            cancel=cancel, grace_s=grace_s, progress=ProgressSink(beats.append), device=device,
        )
        t_back = time.monotonic()
        if res_e is not None or "t" not in seen:
            fail(f"supervised (e): {res_e and res_e.outcome.value}, cancelled {'t' in seen}; want None")
        if attempts_of(said) != 1:
            fail(f"supervised (e): a cancelled job was relaunched: {said}")
        stop_s = t_back - seen["t"]
        if seen.get("pgid") is None or _group_alive(seen["pgid"]) or stop_s > grace_s + 1:
            fail(f"supervised (e): child group {seen.get('pgid')} alive "
                 f"{seen.get('pgid') is not None and _group_alive(seen['pgid'])}, "
                 f"{stop_s:.3f} s after the cancel (grace {grace_s} s)")
        print(f"supervised (e): cancelled {seen['t'] - t0:.3f} s in, after the first spooled heartbeat; "
              f"None with no relaunch; the child's process group was gone {stop_s:.3f} s after the cancel "
              f"(grace {grace_s} s)", flush=True)
        wall("(e) cancel", t_back - t0)
    out["seconds"] = time.monotonic() - t_phase
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _has_torch(pid: int) -> bool:
    """Whether process ``pid`` has loaded torch's library, from /proc."""
    with open(f"/proc/{pid}/maps", encoding="utf-8", errors="replace") as f:
        return "libtorch" in f.read()


def client_twin(events, offset: int) -> list:
    """``events`` with every client id moved by ``offset``: another verdict-
    cache fingerprint for the same search (the encoder numbers chains in
    client order, so witness, steps and statistics are the same)."""
    import dataclasses

    return [dataclasses.replace(e, client_id=e.client_id + offset) for e in events]


class ServeProcesses:
    """The port's ``serve`` processes of one phase (15 to 18), run through
    :data:`VERIFYD_WRAPPER` from ``tmp``, which holds their sockets, stats
    logs, stderr and the wrapper's ``record`` directory.  ``common`` is
    appended to every ``serve`` command line, ``env`` to the environment."""

    def __init__(self, tmp: str, label: str, common: list, **env) -> None:
        self.tmp, self.label, self.common = tmp, label, common
        self.record = os.path.join(tmp, "record")
        os.makedirs(self.record)
        self.wrapper = os.path.join(tmp, "verifyd_wrapper.py")
        with open(self.wrapper, "w", encoding="utf-8") as f:
            f.write(VERIFYD_WRAPPER)
        here = os.path.dirname(os.path.abspath(__file__))
        self.env = dict(os.environ, TMPDIR=tmp, **env,
                        PYTHONPATH=os.pathsep.join([here, *filter(None, [os.environ.get("PYTHONPATH")])]))
        self.daemons: list = []

    def history_file(self, name, events) -> str:
        from s2_verification_tpu_torch.utils import events as ev

        path = os.path.join(self.tmp, f"{name}.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            ev.write_history(events, f)
        return path

    def boot(self, tag, mode, *args, sock=None):
        """One daemon (on ``sock``, by default ``TMP/<tag>.sock``); returns
        its namespace once it answers ``ping``."""
        return self.ready(self.spawn(tag, mode, *args, sock=sock))

    def spawn(self, tag, mode, *args, sock=None):
        """Start one daemon and return its namespace at once: daemons that
        boot side by side are each waited for with :meth:`ready`."""
        d = type("Daemon", (), {})()
        tmp = self.tmp
        d.tag, d.sock, d.log = tag, sock or os.path.join(tmp, f"{tag}.sock"), os.path.join(tmp, f"{tag}.stats.jsonl")
        d.what = f"serve --device {mode} {' '.join(args)}"
        d.err = open(os.path.join(tmp, f"{tag}.stderr"), "w", encoding="utf-8")
        d.t0 = time.monotonic()
        d.proc = subprocess.Popen(
            [sys.executable, self.wrapper, self.record, f"serve-{mode}", "serve", "-socket", d.sock, "--device",
             mode, "--stats-log", d.log, "-out-dir", os.path.join(tmp, f"{tag}-viz"), *self.common, *args],
            env=self.env, cwd=tmp, stdout=subprocess.DEVNULL, stderr=d.err,
        )
        self.daemons.append(d)
        return d

    def ready(self, d):
        """Wait until daemon ``d`` answers ``ping``; its boot wall counts
        from its start."""
        from s2_verification_tpu_torch.service.client import VerifydClient

        while not os.path.exists(d.sock):
            if d.proc.poll() is not None or time.monotonic() - d.t0 > 300:
                d.err.flush()
                fail(f"{self.label} {d.tag}: serve exited {d.proc.poll()} before its socket appeared: "
                     f"{open(d.err.name, encoding='utf-8').read()[-3000:]}")
            time.sleep(0.05)
        d.client = VerifydClient(d.sock, timeout=900)
        d.pid = d.client.ping()["pid"]
        d.boot_s = time.monotonic() - d.t0
        print(f"{self.label} {d.tag}: `{d.what}` answered ping in {d.boot_s:.3f} s "
              f"(pid {d.pid}, torch loaded in the daemon: {_has_torch(d.pid)})", flush=True)
        return d

    def stop(self, d) -> None:
        d.client.shutdown()
        rc = d.proc.wait(timeout=120)
        d.err.close()
        if rc != 0:
            fail(f"{self.label} {d.tag}: serve exited {rc} after shutdown")

    @staticmethod
    def events_of(d) -> list:
        with open(d.log, encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]

    @staticmethod
    def job_spans(d, job) -> dict:
        """Seconds of each span on job ``job``'s track of the daemon's
        ``trace`` op: ``cpu[native]`` (the CPU rung), ``device[MODE]``
        (the escalation), ``prepare`` (admission's decode), ..."""
        return {e["name"]: e["dur"] / 1e6 for e in d.client.trace()["traceEvents"]
                if e.get("ph") == "X" and e.get("tid") == job}

    def kill_all(self) -> None:
        for d in self.daemons:
            if d.proc.poll() is None:
                d.proc.kill()
                d.proc.wait(timeout=30)

    def fold_calls(self, device) -> list:
        """Every fold call the wrapper saved, on ``device`` (the card when
        None), as ``recheck_calls`` takes them."""
        calls = []
        for n in sorted(os.listdir(self.record)):
            if n.startswith("folds-") and n.endswith(".pt"):
                saved = torch.load(os.path.join(self.record, n))
                tables = [t.to(device or "cuda") for t in saved["tables"]]
                calls += [[t.to(device or "cuda") for t in c[:3]] + [tables[c[3]]] for c in saved["calls"]]
        return calls


def run_verifyd_phase(dev_mod, fb, prepare, recheck_calls, k10_events, headline_events, lane_events,
                      lane_verdicts, refused_events, long_events, small_events, device=None, budget_s=2.0,
                      deadline_s=20.0, grace_s=2.0) -> dict:
    """Phase 15, verifyd on the card: the port's daemon as its own process
    (``python -m s2_verification_tpu_torch serve``, through
    :data:`VERIFYD_WRAPPER`), driven with the port's ``submit`` CLI and
    ``VerifydClient``.  ``k10_events`` is the main path's history,
    ``headline_events`` phase 7's, ``lane_events`` / ``lane_verdicts``
    phase 12's lanes and outcomes, ``refused_events`` an unsatisfiable
    history the native rung refuses, ``long_events`` one it cannot decide
    inside 0.05 s and whose device search outlasts ``deadline_s`` (the
    unsatisfiable k=10), ``small_events`` a small one; ``device=None`` is
    the card,
    ``"cpu"`` rehearses the phase on the CPU (``--torch-device cpu``).
    Returns the fold launches by path and the sub-phases' walls."""
    from s2_verification_tpu_torch import cli
    from s2_verification_tpu_torch.checker.stats import FrontierStats
    from s2_verification_tpu_torch.service.client import VerifydClient, VerifydError, VerifydRefused

    t_phase = time.monotonic()
    card = fb.card()
    out = {"launches_by_path": {}, "walls": {}}
    torch_dev = [] if device is None else ["--torch-device", device]

    def wall(tag, seconds):
        out["walls"][tag] = seconds
        print(f"verifyd {tag}: {seconds:.3f} s wall; {card}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        serve = ServeProcesses(tmp, "verifyd", torch_dev)
        record, history_file = serve.record, serve.history_file
        boot, stop, events_of, job_spans = serve.boot, serve.stop, serve.events_of, serve.job_spans
        secret = os.path.join(tmp, "secret")
        with open(secret, "w", encoding="utf-8") as f:
            f.write("phase-15-secret\n")

        def text_of(path):
            with open(path, encoding="utf-8") as f:
                return f.read()

        def launches(d):
            return d.client.stats()["introspection"]["launches"]

        def submit_cli(d, path, *extra):
            """``submit -stats`` in this process: exit code, its JSON line,
            wall, and the job records the daemon wrote meanwhile."""
            before = set(os.listdir(record))
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["submit", "-file", path, "-socket", d.sock, "-stats", "-no-viz", *extra])
            took = time.monotonic() - t0
            new = sorted(n for n in set(os.listdir(record)) - before if n.startswith("job"))
            recs = []
            for n in new:
                with open(os.path.join(record, n), encoding="utf-8") as f:
                    recs.append(json.load(f))
            return rc, json.loads(buf.getvalue().strip().splitlines()[-1]), took, recs

        def job_records():
            recs = []
            for n in os.listdir(record):
                if n.startswith("job"):
                    with open(os.path.join(record, n), encoding="utf-8") as f:
                        recs.append(json.load(f))
            return recs

        def same_search(rec, ref, what):
            got = _stats_view(FrontierStats(**rec["stats"]))
            want = _stats_view(ref.stats)
            if rec["linearization"] != ref.linearization or rec["steps"] != ref.steps or got != want:
                fail(f"verifyd {what}: witness/steps/stats differ from check_device_auto in this process: "
                     f"{rec['steps']} {got} != {ref.steps} {want}")

        try:
            hist10 = prepare(k10_events)
            path10 = history_file("k10", k10_events)
            ref = dev_mod.check_device_auto(hist10, checkpoint_path=os.path.join(tmp, "ref.ckpt.npz"),
                                            profile=True, device=device)
            if ref.outcome.value != "ok":
                fail(f"verifyd: check_device_auto of the k=10 history in process: {ref.outcome.value}")
            pinned = {k: getattr(ref.stats, k) for k in K10_DEVICE_STATS}
            if device is None and pinned != K10_DEVICE_STATS:
                fail(f"verifyd: k=10 in process {pinned} != phase 14 (b)'s {K10_DEVICE_STATS}")

            # (a) --device supervised (the default): k=10 past a short CPU budget.
            d1 = boot("a", "supervised", "--time-budget", str(budget_s), "--profile")
            if _has_torch(d1.pid):
                fail("verifyd (a): the supervised daemon loaded torch")
            l0 = launches(d1)
            rc, line, wall_a, recs = submit_cli(d1, path10)
            l1 = launches(d1)
            if rc != 0 or line["backend"] != "device-supervised" or len(recs) != 1:
                fail(f"verifyd (a): exit {rc}, {line}, {len(recs)} job records")
            (rec_a,) = recs
            if rec_a["backend"] != "device-supervised" or not replay_ok(hist10, rec_a["linearization"]):
                fail(f"verifyd (a): backend {rec_a['backend']}, or the witness does not replay")
            same_search(rec_a, ref, "(a)")
            child_a = (rec_a["child_launches"] or {}).get("fold_lanes", 0)
            seen_a = l1["children"].get("fold_lanes", 0) - l0["children"].get("fold_lanes", 0)
            if device is None and (child_a <= 0 or seen_a != child_a):
                fail(f"verifyd (a): the child reported {child_a} fold launches, the daemon counted {seen_a}")
            if any(e["ev"] == "degrade" for e in events_of(d1)):
                fail("verifyd (a): a degrade event")
            rc, line2, wall_hit, _ = submit_cli(d1, path10)
            if rc != 0 or line2["cached"] is not True:
                fail(f"verifyd (a): the resubmit is not a cache hit: {line2}")
            out["launches_by_path"]["adversarial k=10 in verifyd's supervised child (15a)"] = child_a
            sp = job_spans(d1, rec_a["job"])
            esc_a = sp["device[supervised]"]
            print(f"verifyd (a): k=10 through `submit`: exit 0, backend {line['backend']}, daemon wall_s "
                  f"{line['wall_s']} (CPU rung {sp.get('cpu[native]', 0):.3f} s, escalation {esc_a:.3f} s), "
                  f"client wall {wall_a:.3f} s; witness replays, steps and statistics == "
                  f"check_device_auto in this process ({rec_a['stats']['layers']} layers, "
                  f"{rec_a['stats']['host_syncs']} host syncs); the child's fold launches {child_a} (the "
                  f"daemon's stats op: {seen_a}); no degrade event; resubmitted: cached, {wall_hit:.3f} s",
                  flush=True)
            wall("(a) supervised k=10", wall_a)
            wall("(a) supervised escalation", esc_a)
            wall("(a) cache hit", wall_hit)

            # (b) The headline and a refused history.
            path_h = history_file("headline", headline_events)
            buf = io.StringIO()
            quiet = logging.getLogger("s2_verification_tpu_torch.cli")
            level = quiet.level
            quiet.setLevel(logging.WARNING)  # not the headline's witness line
            try:
                with contextlib.redirect_stdout(buf):
                    one_shot = cli.main(["check", "-file", path_h, "-no-viz"])
            finally:
                quiet.setLevel(level)
            t0 = time.monotonic()
            rc, line, wall_b, _ = submit_cli(d1, path_h)
            if rc != 0 or one_shot != 0 or line["backend"] != "native":
                fail(f"verifyd (b): the headline exit {rc} ({line}), one-shot check exit {one_shot}")
            reply = d1.client.submit(text_of(history_file("refused", refused_events)), client="smoke")
            with open(reply.get("artifact") or os.devnull, encoding="utf-8") as f:
                page = f.read()
            (rec_r,) = [r for r in job_records() if (r["pid"], r["job"]) == (d1.pid, reply["job"])]
            named = f"<code>{', '.join(map(str, rec_r['refused']))}</code>"
            if reply["verdict"] != 1 or not rec_r["refused"] or named not in page:
                fail(f"verifyd (b): refused history verdict {reply['verdict']}, refused ops {rec_r['refused']}, "
                     f"named in the artifact: {named in page}")
            print(f"verifyd (b): the 5x2000 headline: exit 0 == one-shot `check` exit {one_shot}, backend "
                  f"{line['backend']}, daemon wall_s {line['wall_s']}, client {wall_b:.3f} s; the refused "
                  f"history: verdict 1 ({reply['backend']}), its artifact names the refused ops "
                  f"{rec_r['refused']}", flush=True)
            wall("(b) headline", wall_b)
            stop(d1)

            # (c) A burst: phase 12's lanes from 16 client threads at once.
            dc = boot("c", "supervised", "--workers", "4")
            texts = [text_of(history_file(f"lane{i}", e)) for i, e in enumerate(lane_events)]
            replies, lat = [None] * len(texts), [0.0] * len(texts)
            gate = threading.Barrier(len(texts) + 1)

            def one(i):
                c = VerifydClient(dc.sock, timeout=900)
                gate.wait()
                t = time.monotonic()
                replies[i] = c.submit(texts[i], client=f"lane{i}", no_viz=True)
                lat[i] = time.monotonic() - t

            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(texts))]
            for t in threads:
                t.start()
            gate.wait()
            t0 = time.monotonic()
            for t in threads:
                t.join(timeout=900)
            burst = time.monotonic() - t0
            if any(t.is_alive() for t in threads) or None in replies:
                fail("verifyd (c): a burst submit never came back")
            got = [r["outcome"] for r in replies]
            if got != list(lane_verdicts):
                fail(f"verifyd (c): burst verdicts {got} != phase 12's {list(lane_verdicts)}")
            snap = dc.client.stats()
            peak = max(e.get("depth", 0) for e in events_of(dc) if e["ev"] == "admit")
            spans = [job_spans(dc, r["job"]) for r in replies]
            prep = [sp.get("prepare", 0.0) for sp in spans]
            search = [sp.get("search", 0.0) for sp in spans]
            ops = sum(r["ops"] for r in replies)
            q = sorted(lat)
            print(f"verifyd (c): {len(texts)} headline-shape histories from {len(texts)} threads, --workers 4: "
                  f"burst wall {burst:.3f} s, {ops} ops, {ops / burst:.0f} ops verified per s, submit latency "
                  f"p50 {q[len(q) // 2]:.3f} s p95 {q[min(len(q) - 1, int(0.95 * len(q)))]:.3f} s; backends "
                  f"{sorted({r['backend'] for r in replies})}; every verdict == phase 12's; stats: submitted "
                  f"{snap['submitted']}, completed {snap['completed']}, queue peak {peak}; admission's decode "
                  f"(the `prepare` spans, on the acceptor's event loop) {sum(prep):.3f} s in all "
                  f"({sum(prep) / len(prep):.3f} s a history), the searches {sum(search):.3f} s in all; {card}",
                  flush=True)
            wall("(c) burst", burst)
            stop(dc)

            # (d) --device inline: the daemon holds one CUDA context.
            d2 = boot("d", "inline", "--time-budget", str(budget_s), "--profile")
            walls_d, esc_d, recs_d = [], [], []
            for k, path in enumerate((path10, history_file("k10-twin", client_twin(k10_events, 1000)))):
                j0, l0 = d2.client.stats()["introspection"]["jit"], launches(d2)
                rc, line, took, recs = submit_cli(d2, path)
                j1, l1 = d2.client.stats()["introspection"]["jit"], launches(d2)
                n = l1["inline"].get("fold_lanes", 0) - l0["inline"].get("fold_lanes", 0)
                if rc != 0 or line["backend"] != "device-inline" or line["cached"] or len(recs) != 1:
                    fail(f"verifyd (d) submit {k + 1}: exit {rc}, {line}, {len(recs)} job records")
                same_search(recs[0], ref, f"(d) submit {k + 1}")
                if device is None and n <= 0:
                    fail(f"verifyd (d) submit {k + 1}: {n} fold launches counted in the daemon")
                builds = sum(j1.get("compiles", {}).values()) - sum(j0.get("compiles", {}).values())
                sp = job_spans(d2, recs[0]["job"])
                walls_d.append(took)
                esc_d.append(sp["device[inline]"])
                recs_d.append(recs[0])
                out["launches_by_path"][f"adversarial k=10 in the inline daemon, submit {k + 1} (15d)"] = n
                print(f"verifyd (d) submit {k + 1}: backend device-inline, daemon wall_s {line['wall_s']} (CPU "
                      f"rung {sp.get('cpu[native]', 0):.3f} s, escalation {esc_d[-1]:.3f} s), client {took:.3f} s; "
                      f"fold launches counted in the daemon {n}; library builds {builds}; "
                      f"witness, steps and statistics == (a)'s and check_device_auto's", flush=True)
            if not _has_torch(d2.pid) or d2.client.ping()["pid"] != d2.pid:
                fail("verifyd (d): the inline daemon has no torch, or restarted")
            print(f"verifyd (d): inline k=10 {walls_d[0]:.3f} s (first, with the daemon's first CUDA work), "
                  f"{walls_d[1]:.3f} s (second, same pid {d2.pid} and context) against supervised {wall_a:.3f} s "
                  f"in (a): inline/supervised {walls_d[0] / wall_a:.3f} first, {walls_d[1] / wall_a:.3f} warm; "
                  f"the escalations alone {esc_d[0]:.3f} / {esc_d[1]:.3f} s against {esc_a:.3f} s "
                  f"({esc_d[0] / esc_a:.3f} / {esc_d[1] / esc_a:.3f}); daemon boot {d2.boot_s:.3f} s (supervised "
                  f"{d1.boot_s:.3f} s); {card}", flush=True)
            wall("(d) inline k=10, first", walls_d[0])
            wall("(d) inline k=10, second", walls_d[1])
            wall("(d) inline escalation, first", esc_d[0])
            wall("(d) inline escalation, second", esc_d[1])
            stop(d2)

            # (e) A deadline that expires while the child searches.  A
            # deadline floors the CPU budget at 0.05 s (scheduler.py), inside
            # which the native rung decides the headline's 2,885 steps; the
            # unsatisfiable k=10 it cannot, and its device search runs longer
            # than the deadline.
            port = _free_port()
            d3 = boot("e", "supervised", "--time-budget", "0.05", "--deadline-grace", str(grace_s),
                      "--drain-timeout", "30", "--tcp", f"127.0.0.1:{port}", "--secret-file", secret)
            spool = os.path.join(tmp, f"verifyd-spool-{d3.pid}")
            seen: dict = {}
            done = threading.Event()

            def watch_child():
                while not done.is_set():
                    pgid = _group_of(spool + "/job")
                    if pgid is not None and "pgid" not in seen:
                        seen["pgid"], seen["t"] = pgid, time.monotonic()
                    if os.path.isdir(spool) and any(n.endswith(".progress.json") for n in os.listdir(spool)):
                        seen.setdefault("beat", time.monotonic())
                    time.sleep(0.05)

            watcher = threading.Thread(target=watch_child)
            watcher.start()
            t0 = time.monotonic()
            try:
                d3.client.submit(text_of(history_file("long", long_events)), no_viz=True, deadline_s=deadline_s)
                err_cls = None
            except VerifydError as e:
                err_cls = e.cls
            t_reply = time.monotonic()
            done.set()
            watcher.join(timeout=30)
            gone = None
            while seen.get("pgid") is not None and time.monotonic() - t_reply < grace_s + 5:
                if not _group_alive(seen["pgid"]):
                    gone = time.monotonic()
                    break
                time.sleep(0.01)
            expiry = t0 + deadline_s
            if err_cls != "DeadlineExceeded" or "pgid" not in seen or gone is None or gone - expiry > grace_s + 1:
                fail(f"verifyd (e): reply {err_cls}, child seen {'pgid' in seen}, group gone "
                     f"{None if gone is None else round(gone - expiry, 3)} s after the deadline")
            if d3.client.ping()["server"] != "verifyd":
                fail("verifyd (e): the daemon stopped answering ping")
            beat = seen.get("beat")
            print(f"verifyd (e): the unsatisfiable k=10 with --time-budget 0.05 and --deadline {deadline_s}: "
                  f"DeadlineExceeded {t_reply - t0:.3f} s after submit; the child started "
                  f"{seen['t'] - t0:.3f} s in, spooled its first heartbeat "
                  f"{'never' if beat is None else f'{beat - t0:.3f} s in'}; its process group was gone "
                  f"{gone - expiry:.3f} s after the deadline (grace {grace_s} s); the daemon answers ping",
                  flush=True)
            wall("(e) deadline", t_reply - t0)
            out["walls"]["(e) cancel to gone"] = gone - expiry

            # (f) TCP and drain.
            small = text_of(history_file("small", small_events))
            keys = ("verdict", "outcome", "backend", "ops", "shape")
            by_unix = d3.client.submit(small, no_viz=True)
            tcp = VerifydClient(f"127.0.0.1:{port}", timeout=300, secret=b"phase-15-secret")
            by_tcp = tcp.submit(small, no_viz=True)
            if {k: by_unix[k] for k in keys} != {k: by_tcp[k] for k in keys}:
                fail(f"verifyd (f): TCP reply {by_tcp} != unix {by_unix}")
            before = d3.client.stats()
            try:
                VerifydClient(f"127.0.0.1:{port}", timeout=30, secret=b"wrong").submit(small)
                refused = None
            except VerifydRefused as e:
                refused = e.cls
            after = d3.client.stats()
            if refused != "AuthError" or after["submitted"] != before["submitted"] or (
                    after["auth_rejects"] != before["auth_rejects"] + 1):
                fail(f"verifyd (f): a wrong secret got {refused}; submitted {before['submitted']} -> "
                     f"{after['submitted']}, auth rejects {before['auth_rejects']} -> {after['auth_rejects']}")
            drained: dict = {}

            def in_flight():
                drained["reply"] = VerifydClient(d3.sock, timeout=600).submit(
                    text_of(history_file("k10-drain", client_twin(k10_events, 2000))), no_viz=True)

            t0 = time.monotonic()
            th = threading.Thread(target=in_flight)
            th.start()
            while d3.client.stats()["active"] < 1:
                if time.monotonic() - t0 > 60:
                    fail("verifyd (f): the drain's job never started")
                time.sleep(0.05)
            d3.proc.send_signal(signal.SIGTERM)
            t_sig = time.monotonic()
            rc = d3.proc.wait(timeout=120)
            th.join(timeout=60)
            d3.err.close()
            rep = drained.get("reply") or {}
            evs = events_of(d3)
            drain = [e for e in evs if e["ev"] == "drain_done"]
            if rc != 0 or rep.get("verdict") != 0 or rep.get("backend") != "device-supervised" or not drain or (
                    not drain[0]["clean"]):
                fail(f"verifyd (f): serve exited {rc}, the in-flight reply {rep}, drain {drain}")
            child_f = sum((r["child_launches"] or {}).get("fold_lanes", 0) for r in job_records()
                          if (r["pid"], r["job"]) == (d3.pid, rep.get("job")))
            out["launches_by_path"]["adversarial k=10 in flight through a drain, supervised child (15f)"] = child_f
            print(f"verifyd (f): a signed TCP submit == the unix socket's reply ({by_tcp['outcome']}, "
                  f"{by_tcp['backend']}); a wrong secret: {refused} before admission; SIGTERM with "
                  f"--drain-timeout 30 while k=10 was in flight: the job was answered "
                  f"({rep.get('backend')}, verdict 0, {child_f} fold launches in its child), serve exited 0 "
                  f"{time.monotonic() - t_sig:.3f} s after the signal (drain waited {drain[0]['waited_s']} s, "
                  f"clean)", flush=True)
            wall("(f) drain", time.monotonic() - t0)
        finally:
            serve.kill_all()

        # Every fold call the phase's device searches made, bit-exact.
        calls = serve.fold_calls(device)
        if device is None and not calls:
            fail("verifyd: no fold call was recorded")
        if calls:
            recheck_calls(calls, "verifyd (phase 15), children and inline daemon")
        print(f"verifyd: {len(calls)} recorded fold calls from "
              f"{sum(1 for n in os.listdir(record) if n.startswith('folds-'))} processes, bit-exact", flush=True)
    out["seconds"] = time.monotonic() - t_phase
    return out


def _alert_receiver():
    """A webhook receiver on 127.0.0.1 (an ephemeral port) that keeps the
    JSON body of every POST; returns ``(url, bodies, server)``."""
    import http.server

    bodies: list = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 (http.server API)
            n = int(self.headers.get("Content-Length") or 0)
            bodies.append(json.loads(self.rfile.read(n).decode("utf-8")))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *_args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}/alert", bodies, server


def run_durable_phase(dev_mod, fb, prepare, recheck_calls, k10_events, device=None, budget_s=2.0) -> dict:
    """Phase 16, verifyd's durability and ops layer on the card: the port's
    ``serve`` as its own process (through :data:`VERIFYD_WRAPPER`, fold
    calls saved as they happen) on one state directory over three boots —
    (a) inline, with the telemetry store, the metrics listener and an
    alert receiver; (b) SIGKILLed mid-escalation of k=10's client-id twin,
    ``doctor`` on what it left, and the next boot replaying the orphan on
    the card; (c) a supervised boot answering both from the verdict
    segments with no launch.  ``device=None`` is the card, ``"cpu"``
    rehearses the phase on the CPU (``--torch-device cpu``).  Returns the
    fold launches by path and the walls."""
    import urllib.request

    from s2_verification_tpu_torch.checker.stats import FrontierStats
    from s2_verification_tpu_torch.service.cache import history_fingerprint
    from s2_verification_tpu_torch.service.client import VerifydRefused, VerifydUnavailable

    t_phase = time.monotonic()
    card = fb.card()
    out = {"launches_by_path": {}, "walls": {}}
    torch_dev = [] if device is None else ["--torch-device", device]

    def wall(tag, seconds):
        out["walls"][tag] = seconds
        print(f"durable {tag}: {seconds:.3f} s wall; {card}", flush=True)

    url, alerts, receiver = _alert_receiver()
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state")
        tel = os.path.join(state, "telemetry")
        serve = ServeProcesses(tmp, "durable", [*torch_dev, "--no-viz", "--state-dir", state, "--telemetry-dir", tel,
                                                "--telemetry-sample", "0.5", "--metrics-port", "0", "--alert-url",
                                                url, "--alert-rule", "done", "--drain-timeout", "30"],
                               VERIFYD_RECORD_LIVE="1")
        record, history_file, events_of, job_spans = serve.record, serve.history_file, serve.events_of, serve.job_spans

        def boot(tag, mode, *args):
            d = serve.boot(tag, mode, *args)
            wall(f"({tag}) boot", d.boot_s)
            return d

        def inline_launches(d):
            return d.client.stats()["introspection"]["launches"]["inline"].get("fold_lanes", 0)

        def job_record(d, job):
            with open(os.path.join(record, f"job-{d.pid}-{job}.json"), encoding="utf-8") as f:
                return json.load(f)

        def submit(d, path, client):
            """One submit through the port's client: its reply and wall."""
            with open(path, encoding="utf-8") as f:
                text = f.read()
            t0 = time.monotonic()
            reply = d.client.submit(text, client=client, no_viz=True)
            return reply, time.monotonic() - t0

        def same_search(rec, what):
            got = _stats_view(FrontierStats(**rec["stats"]))
            if rec["backend"] != "device-inline" or rec["linearization"] != ref.linearization or (
                    rec["steps"] != ref.steps or got != _stats_view(ref.stats)):
                fail(f"durable {what}: backend {rec['backend']}, or witness/steps/stats differ from "
                     f"check_device_auto in this process")
            pinned = {k: rec["stats"][k] for k in K10_DEVICE_STATS}
            if device is None and pinned != K10_DEVICE_STATS:
                fail(f"durable {what}: statistics {pinned} != {K10_DEVICE_STATS}")

        def ledger():
            with open(os.path.join(state, "quarantine", "quarantine.json"), encoding="utf-8") as f:
                return json.load(f)

        try:
            path10 = history_file("k10", k10_events)
            twin_events = client_twin(k10_events, 3000)
            path_twin = history_file("k10-twin", twin_events)
            twin_fp = history_fingerprint(prepare(twin_events, elide_trivial=True))
            ref = dev_mod.check_device_auto(prepare(k10_events), checkpoint_path=os.path.join(tmp, "ref.ckpt.npz"),
                                            profile=True, device=device)

            # (a) First boot: inline, every durable and ops flag.
            d1 = boot("a", "inline", "--time-budget", str(budget_s), "--profile")
            n0 = inline_launches(d1)
            line, wall_a = submit(d1, path10, "k10")
            n_a = inline_launches(d1) - n0
            if line["verdict"] != 0 or line["backend"] != "device-inline" or line.get("durable") is not True:
                fail(f"durable (a): {line}")
            same_search(job_record(d1, line["job"]), "(a)")
            if device is None and n_a <= 0:
                fail(f"durable (a): {n_a} fold launches counted in the daemon")
            esc_a = job_spans(d1, line["job"])["device[inline]"]
            port = d1.client.stats()["metrics_port"]
            req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics",
                                         headers={"Accept": "application/openmetrics-text"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                om = resp.read().decode()
            want = f'verifyd_kernel_launches_total{{kernel="fold_lanes",where="inline"}} {n0 + n_a}'
            if not om.rstrip().endswith("# EOF") or (device is None and want not in om):
                fail(f"durable (a): /metrics is not OpenMetrics, or lacks `{want}`")
            page = urllib.request.urlopen(f"http://127.0.0.1:{port}/dashboard", timeout=30).read().decode()
            if "<svg" not in page:
                fail("durable (a): /dashboard rendered no sparkline")
            live_tsq = d1.client.tsq(metric="verifyd_jobs_completed_total")
            series = live_tsq["series"].get('verifyd_jobs_completed_total{verdict="ok"}') or []
            if not series or series[-1][1] != 1.0:
                fail(f"durable (a): the tsq op's jobs series {live_tsq['series']}")
            profiles = d1.client.profiles()["records"]
            if [(r["job"], r["backend"], r["verdict"]) for r in profiles] != [(line["job"], "device-inline", 0)]:
                fail(f"durable (a): the profiles op lists {profiles}")
            t0 = time.monotonic()
            while not any(a["labels"]["alertname"] == "done" for body in alerts for a in body):
                if time.monotonic() - t0 > 30:
                    fail(f"durable (a): the receiver got no `done` alert: {alerts}")
                time.sleep(0.05)
            print(f"durable (a): k=10 submitted: backend device-inline, durable, daemon wall_s "
                  f"{line['wall_s']} (escalation {esc_a:.3f} s), client wall {wall_a:.3f} s; statistics == "
                  f"K10_DEVICE_STATS and check_device_auto's; fold launches counted in the daemon {n_a} (== the "
                  f"OpenMetrics `verifyd_kernel_launches_total`); /dashboard renders; tsq op: jobs series "
                  f"{len(series)} point(s); profiles op: job {line['job']}; the receiver got the `done` alert",
                  flush=True)
            out["launches_by_path"]["adversarial k=10 in the durable inline daemon (16a)"] = n_a
            wall("(a) inline k=10", wall_a)
            wall("(a) inline escalation", esc_a)

            # (b) The twin, SIGKILLed mid-escalation; doctor; replay.
            count_file = os.path.join(record, f"fold-count-{d1.pid}")

            def recorded():
                try:
                    with open(count_file, encoding="utf-8") as f:
                        return int(f.read())
                except (OSError, ValueError):
                    return 0

            base = recorded()
            hung: dict = {}

            def submit_twin():
                try:
                    hung["reply"] = submit(d1, path_twin, "twin")
                except (VerifydRefused, VerifydUnavailable, OSError) as e:  # the kill's closed connection
                    hung["error"] = repr(e)

            th = threading.Thread(target=submit_twin)
            t0 = time.monotonic()
            th.start()
            while recorded() <= base:
                if time.monotonic() - t0 > 120 or not th.is_alive():
                    fail(f"durable (b): the twin's first fold call never came ({hung})")
                time.sleep(0.005)
            d1.proc.send_signal(signal.SIGKILL)
            d1.proc.wait(timeout=60)
            d1.err.close()
            th.join(timeout=60)
            killed_after = time.monotonic() - t0
            if "reply" in hung:
                fail(f"durable (b): the twin was answered before the kill: {hung['reply']}")
            kept = len(torch.load(os.path.join(record, f"folds-serve-inline-{d1.pid}.pt"))["calls"]) - base
            t0 = time.monotonic()
            doc = subprocess.run([sys.executable, "-m", "s2_verification_tpu_torch", "doctor", "--state-dir",
                                  state, "--json"], env=serve.env, cwd=tmp, capture_output=True, text=True, timeout=120)
            doctor_s = time.monotonic() - t0
            pm = json.loads(doc.stdout)
            orphans = [(o.get("fp"), o.get("client"), o.get("started")) for o in pm["orphans"]]
            if doc.returncode != 1 or pm["clean_shutdown"] or orphans != [(twin_fp, "twin", True)]:
                fail(f"durable (b): doctor exit {doc.returncode}, clean {pm['clean_shutdown']}, orphans {orphans}")
            print(f"durable (b): SIGKILL {killed_after:.3f} s after the twin's submit, once its first fold call "
                  f"was recorded ({kept} of the twin's calls saved); `doctor --state-dir` exit 1 (unclean) in "
                  f"{doctor_s:.3f} s names the orphan {twin_fp} (client twin, started)", flush=True)
            out["launches_by_path"]["k=10's twin in the inline daemon until its SIGKILL (16b)"] = kept

            d2 = boot("b", "inline", "--time-budget", str(budget_s), "--profile")
            crashes = ledger()["crashes"].get(twin_fp, {}).get("count")
            if crashes != 1:
                fail(f"durable (b): the ledger counts {crashes} crashes for the twin, not 1")
            t0 = time.monotonic()
            while d2.client.stats()["completed"] < 1:
                if time.monotonic() - t0 > 300:
                    fail("durable (b): the orphan never replayed")
                time.sleep(0.05)
            replay = [e for e in events_of(d2) if e["ev"] == "orphan"]
            if [e["fingerprint"] for e in replay] != [twin_fp]:
                fail(f"durable (b): orphan events {replay}")
            job_b = replay[0]["job"]
            same_search(job_record(d2, job_b), "(b) replay")
            n_b = inline_launches(d2)
            if device is None and n_b <= 0:
                fail(f"durable (b): the replay made {n_b} fold launches in the daemon")
            esc_b = job_spans(d2, job_b)["device[inline]"]
            line_b, wall_hit = submit(d2, path_twin, "twin-retry")
            if line_b["cached"] is not True or twin_fp in ledger()["crashes"]:
                fail(f"durable (b): the twin's retry {line_b}, or its crash was not forgiven: {ledger()}")
            print(f"durable (b): boot 2 charged 1 crash to the twin (threshold 3), replayed the orphan first "
                  f"(job {job_b}) on the card: escalation {esc_b:.3f} s, {n_b} fold launches counted in the "
                  f"daemon, statistics == K10_DEVICE_STATS; the twin's retry answered from D/verdicts in "
                  f"{wall_hit:.3f} s, and the conclusive verdict forgave the crash", flush=True)
            out["launches_by_path"]["k=10's twin replayed as an orphan after the SIGKILL (16b)"] = n_b
            wall("(b) replay escalation", esc_b)
            wall("(b) twin retry from the verdict segments", wall_hit)
            d2.proc.send_signal(signal.SIGTERM)
            rc = d2.proc.wait(timeout=120)
            d2.err.close()
            if rc != 0 or not any(e["ev"] == "drain_done" and e["clean"] for e in events_of(d2)):
                fail(f"durable (b): SIGTERM drain: serve exited {rc}")

            # (c) Third boot, supervised: both from the verdict segments.
            d3 = boot("c", "supervised")
            if _has_torch(d3.pid):
                fail("durable (c): the supervised daemon loaded torch")
            walls_c = []
            for name, path in (("k=10", path10), ("twin", path_twin)):
                line_c, took = submit(d3, path, name)
                if line_c["cached"] is not True or line_c["verdict"] != 0:
                    fail(f"durable (c) {name}: {line_c}")
                walls_c.append(took)
            snap = d3.client.stats()
            spool = os.path.join(tmp, f"verifyd-spool-{d3.pid}")
            if snap["completed"] != 0 or snap["introspection"]["launches"] != {"inline": {}, "children": {}} or (
                    os.path.isdir(spool) and os.listdir(spool)) or any(n.startswith(f"job-{d3.pid}-")
                                                                        for n in os.listdir(record)):
                fail(f"durable (c): a job ran: completed {snap['completed']}, launches "
                     f"{snap['introspection']['launches']}")
            live = d3.client.tsq(metric="verifyd_jobs_completed_total", limit=100000)
            d3.client.shutdown()
            if d3.proc.wait(timeout=120) != 0:
                fail("durable (c): serve exited nonzero after shutdown")
            d3.err.close()
            cold = subprocess.run([sys.executable, "-m", "s2_verification_tpu_torch", "tsq", "--telemetry-dir", tel,
                                   "--metric", "verifyd_jobs_completed_total", "--limit", "100000",
                                   "--until", repr(live["range"][1]), "--json"],
                                  env=serve.env, cwd=tmp, capture_output=True, text=True, timeout=120)
            said = json.loads(cold.stdout)
            if cold.returncode != 0 or said["series"] != live["series"] or said["points"] != live["points"]:
                fail(f"durable (c): cold tsq (exit {cold.returncode}) != the live op's answer")
            print(f"durable (c): supervised boot answered k=10 in {walls_c[0]:.3f} s and the twin in "
                  f"{walls_c[1]:.3f} s from D/verdicts: 0 fold launches, no CPU rung, no child; cold `tsq "
                  f"--telemetry-dir` == the live op's {live['points']} point(s)", flush=True)
            out["launches_by_path"]["k=10 and its twin from the verdict segments, third boot (16c)"] = 0
            wall("(c) k=10 from the verdict segments", walls_c[0])
            wall("(c) twin from the verdict segments", walls_c[1])
        finally:
            receiver.shutdown()
            serve.kill_all()

        calls = serve.fold_calls(device)
        if device is None and len(calls) != n_a + kept + n_b:
            fail(f"durable: {len(calls)} recorded fold calls, {n_a} + {kept} + {n_b} counted")
        if calls:
            recheck_calls(calls, "verifyd durability (phase 16)")
        print(f"durable: {len(calls)} recorded fold calls, bit-exact", flush=True)
    out["seconds"] = time.monotonic() - t_phase
    return out


def _closed_cut(lines, frac) -> int:
    """The line count nearest ``frac`` of ``lines`` after which no call is
    open (a cut no op spans)."""
    from s2_verification_tpu_torch.utils import events as ev

    open_ops, cuts = set(), []
    for i, line in enumerate(lines):
        le = ev.decode_obj(json.loads(line))
        (open_ops.add if le.is_start else open_ops.discard)((le.client_id, le.op_id))
        if not open_ops and 0 < i + 1 < len(lines):
            cuts.append(i + 1)
    return min(cuts, key=lambda c: abs(c - frac * len(lines)))


def _quantiles(xs) -> tuple:
    q = sorted(xs)
    return q[len(q) // 2], q[min(len(q) - 1, int(0.95 * len(q)))]


def run_batch_prefix_phase(dev_mod, fb, prepare, recheck_calls, k10_events, headline_events, batch_events,
                           device=None, budget_s=2.0, window=FOLLOW_WINDOW) -> dict:
    """Phase 17, the rest of single-node verifyd on the card: the port's
    ``serve`` as its own process (through :data:`VERIFYD_WRAPPER`) —
    (a) ``--batching --batch-engine vmap`` with ``--device inline``: a burst
    of ``batch_events`` (one shape group) from as many client threads,
    against a daemon without ``--batching``; (b) ``--device supervised
    --prefix --state-dir D``: ``follow`` over ``headline_events`` in
    windows of ``window`` events, SIGKILLed after half of them and carried
    on by the next boot from the store, a 60% cut and the whole headline
    submitted (a ``prefix_hit``), and ``k10_events``, whose cold prefix plan
    runs out of the CPU budget and escalates to the card in a supervised
    child; (c) ``trace``, ``watch`` and one ``dash`` frame against (b)'s
    daemon.  ``device=None`` is the card, ``"cpu"`` rehearses the phase on
    the CPU (``--torch-device cpu``).  Returns the fold launches by path
    and the walls."""
    from s2_verification_tpu_torch import cli
    from s2_verification_tpu_torch.service.client import VerifydClient
    from s2_verification_tpu_torch.service.prefixstore import read_cold
    from s2_verification_tpu_torch.service.scheduler import shape_key

    t_phase = time.monotonic()
    card = fb.card()
    out = {"launches_by_path": {}, "walls": {}}
    torch_dev = [] if device is None else ["--torch-device", device]

    def wall(tag, seconds):
        out["walls"][tag] = seconds
        print(f"batch-prefix {tag}: {seconds:.3f} s wall; {card}", flush=True)

    def quiet_cli(argv):
        """``cli.main(argv)`` in this process: exit code and stdout."""
        buf = io.StringIO()
        logger = logging.getLogger("s2_verification_tpu_torch.cli")
        level = logger.level
        logger.setLevel(logging.WARNING)
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
        finally:
            logger.setLevel(level)
        return rc, buf.getvalue()

    def launches(d):
        return d.client.stats()["introspection"]["launches"]

    def burst(d, texts, blocker=None):
        """Every text from its own client thread at once: replies,
        latencies, the burst's wall.  With a ``blocker`` text, that one is
        submitted first and the burst goes out once the daemon has started
        it, so the burst queues behind a busy worker (its reply is
        returned last)."""
        replies, lat = [None] * len(texts), [0.0] * len(texts)
        gate = threading.Barrier(len(texts) + 1)
        held: dict = {}
        if blocker is not None:
            th = threading.Thread(target=lambda: held.update(
                VerifydClient(d.sock, timeout=900).submit(blocker, client="blocker", no_viz=True)))
            th.start()
            t0 = time.monotonic()
            while d.client.stats()["active"] < 1:
                if time.monotonic() - t0 > 60 or not th.is_alive():
                    fail(f"batch-prefix: the blocker never started on {d.tag}: {held}")
                time.sleep(0.002)

        def one(i):
            c = VerifydClient(d.sock, timeout=900)
            gate.wait()
            t = time.monotonic()
            replies[i] = c.submit(texts[i], client=f"b{i}", no_viz=True)
            lat[i] = time.monotonic() - t

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        gate.wait()
        t0 = time.monotonic()
        for t in threads:
            t.join(timeout=900)
        took = time.monotonic() - t0
        if any(t.is_alive() for t in threads) or None in replies:
            fail(f"batch-prefix: a burst submit to {d.tag} never came back")
        if blocker is not None:
            th.join(timeout=900)
        return replies, lat, took, held

    with tempfile.TemporaryDirectory() as tmp:
        serve = ServeProcesses(tmp, "batch-prefix", [*torch_dev, "--no-viz"])
        try:
            # (a) Batching on the card: one shape group in a burst.
            keys = [shape_key(prepare(e, elide_trivial=True)) for e in batch_events]
            if len(set(keys)) != 1:
                fail(f"batch-prefix (a): the histories' shape keys differ: {keys}")
            paths = [serve.history_file(f"b{i}", e) for i, e in enumerate(batch_events)]
            want = [quiet_cli(["check", "-file", p, "-no-viz"])[0] for p in paths]
            texts = []
            for p in paths:
                with open(p, encoding="utf-8") as f:
                    texts.append(f.read())
            print(f"batch-prefix (a): {len(texts)} histories, every shape key {keys[0]} (one shape group); "
                  f"one-shot `check` exits {want}; the burst goes out once the one worker has started phase "
                  f"7's headline (its native rung), so it queues behind a busy worker", flush=True)
            da = serve.boot("a", "inline", "--batching", "--batch-engine", "vmap", "--time-budget", str(budget_s),
                            "--workers", "1")
            n0 = launches(da)["inline"].get("fold_lanes", 0)
            with open(serve.history_file("headline", headline_events), encoding="utf-8") as f:
                blocker = f.read()
            replies, lat, burst_wall, held = burst(da, texts, blocker)
            n_a = launches(da)["inline"].get("fold_lanes", 0) - n0
            snap = da.client.stats()
            groups = [e for e in serve.events_of(da) if e["ev"] == "batch_launch"]
            got = [r["verdict"] for r in replies]
            if got != want:
                fail(f"batch-prefix (a): verdicts {got} != one-shot check's {want}")
            if snap["batch_launches"] < 1 or max((e["lanes"] for e in groups), default=0) < 2:
                fail(f"batch-prefix (a): {snap['batch_launches']} launches, lanes {[e['lanes'] for e in groups]}")
            if device is None and n_a <= 0:
                fail(f"batch-prefix (a): {n_a} fold launches in the daemon")
            # Every lane decided by the vmap launches themselves: a lane
            # they leave undecided falls back to the sequential portfolio,
            # which would hold the native rung against one-shot `check`.
            backends = sorted({r["backend"] for r in replies})
            if sum(e["decided"] for e in groups) != len(texts) or backends != ["batch-vmap"]:
                fail(f"batch-prefix (a): the vmap launches decided {[e['decided'] for e in groups]} of "
                     f"{len(texts)} lanes, reply backends {backends}")
            if held.get("verdict") != 0:
                fail(f"batch-prefix (a): the headline ahead of the burst: {held}")
            ops = sum(r["ops"] for r in replies)
            p50, p95 = _quantiles(lat)
            for e in groups:
                print(f"batch-prefix (a): launch {e['engine']}: {e['lanes']} lanes, {e['decided']} decided, "
                      f"{e['early_exits']} early exits, occupancy {e['occupancy']}, late join {e['late_join']}, "
                      f"wall {e['wall_s']} s", flush=True)
            print(f"batch-prefix (a): backends {sorted(r['backend'] for r in replies)}; burst wall "
                  f"{burst_wall:.3f} s, {ops} ops, {ops / burst_wall:.0f} ops verified per s, submit latency p50 "
                  f"{p50:.3f} s p95 {p95:.3f} s; {snap['batch_launches']} launches, {snap['batch_lanes']} lanes; "
                  f"fold launches counted in the daemon {n_a}; every verdict == one-shot `check`; the headline "
                  f"ahead of it: {held['backend']}, daemon {held['wall_s']} s", flush=True)
            out["launches_by_path"]["8 match-seq-num 5x200 in the batching daemon's vmap launches (17a)"] = n_a
            wall("(a) inline batching boot", da.boot_s)
            wall("(a) burst", burst_wall)
            serve.stop(da)
            # The same burst through a daemon without --batching (the
            # sequential path: its native rung decides each history, so
            # it runs supervised, with no torch to load).
            dp = serve.boot("a-plain", "supervised", "--time-budget", str(budget_s), "--workers", "1")
            replies_p, lat_p, wall_p, _ = burst(dp, texts, blocker)
            if [r["verdict"] for r in replies_p] != want:
                fail(f"batch-prefix (a): the plain daemon's verdicts {[r['verdict'] for r in replies_p]}")
            q50, q95 = _quantiles(lat_p)
            print(f"batch-prefix (a): without --batching: backends {sorted({r['backend'] for r in replies_p})}; "
                  f"burst wall {wall_p:.3f} s, {ops / wall_p:.0f} ops verified per s, p50 {q50:.3f} s p95 "
                  f"{q95:.3f} s", flush=True)
            wall("(a) burst without --batching", wall_p)
            serve.stop(dp)

            # (b) Prefix resume: follow, SIGKILL, carry on from the store.
            state = os.path.join(tmp, "state")
            buf = io.StringIO()
            from s2_verification_tpu_torch.utils import events as ev

            ev.write_history(headline_events, buf)
            lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
            wins = [w for w, _ in cli._iter_follow_windows(lines, window)]
            # The windows cut at `window` events (every one but the EOF
            # remainder, which is answered on its own below).
            closed, tail = wins[:-1], wins[-1]
            half = len(closed) // 2

            def follow(d, chunks, token, tag):
                path = os.path.join(tmp, f"follow-{tag}.jsonl")
                with open(path, "w", encoding="utf-8") as f:
                    f.write("".join(line + "\n" for w in chunks for line in w))
                argv = ["follow", "-file", path, "-socket", d.sock, "--stream", "headline", "--window",
                        str(window), "-stats"] + (["--frontier", token] if token else [])
                t0 = time.monotonic()
                rc, text = quiet_cli(argv)
                rows = [json.loads(line) for line in text.splitlines() if line.strip()]
                if rc != 0 or len(rows) != len(chunks) or any(
                        (r["verdict"], r["advanced"], r["attempt"]) != (0, True, 0) for r in rows):
                    fail(f"batch-prefix (b) {tag}: follow exit {rc}, rows {rows}")
                return rows, time.monotonic() - t0

            prefix_flags = ["--prefix", "--state-dir", state, "--time-budget", str(budget_s), "--profile"]
            db = serve.boot("b", "supervised", *prefix_flags)
            rows1, fw1 = follow(db, closed[:half], None, "first")
            token = rows1[-1]["frontier"]
            db.proc.send_signal(signal.SIGKILL)
            db.proc.wait(timeout=60)
            db.err.close()
            db2 = serve.boot("b2", "supervised", *prefix_flags)
            loaded = [e for e in serve.events_of(db2) if e["ev"] == "prefix_loaded"]
            rows2, fw2 = follow(db2, closed[half:], token, "second")
            if rows2[0]["backend"] != "frontier-resume" or not loaded or loaded[0]["entries"] < half:
                fail(f"batch-prefix (b): after the SIGKILL the follow did not resume from the store: "
                     f"{rows2[0]}, {loaded}")
            rest = db2.client.follow("".join(line + "\n" for line in tail), stream="headline",
                                     frontier=rows2[-1]["frontier"])
            if rest["verdict"] != 0:
                fail(f"batch-prefix (b): the remaining {len(tail)} events: {rest}")
            child = launches(db2)["children"]
            if child or any(n.startswith("folds-child") for n in os.listdir(serve.record)):
                fail(f"batch-prefix (b): the follow windows launched the fold: {child}")
            window_walls = [r["wall_s"] for r in rows1 + rows2]
            w50, w95 = _quantiles(window_walls)
            print(f"batch-prefix (b): follow in windows of {window} events: {len(rows1)} windows "
                  f"({rows1[-1]['ops_total']} ops) in {fw1:.3f} s, SIGKILL, boot 2 in {db2.boot_s:.3f} s "
                  f"(prefix_loaded {loaded[0]['entries']} entries), {len(rows2)} more from --frontier "
                  f"{token} in {fw2:.3f} s, no resync, the first `frontier-resume` in {rows2[0]['wall_s']} s "
                  f"(daemon); every window OK and carried, window walls p50 {w50} s p95 {w95} s (daemon); "
                  f"0 fold launches; the remaining {len(tail)} events (to EOF, one window): verdict "
                  f"{rest['verdict']}, carried {rest['advanced']} ({rest['backend']})", flush=True)
            out["launches_by_path"]["follow windows of the headline (17b)"] = 0
            wall("(b) boot after the SIGKILL", db2.boot_s)
            wall("(b) first resumed window (daemon)", rows2[0]["wall_s"])
            wall("(b) follow windows p50 (daemon)", w50)
            wall("(b) follow windows p95 (daemon)", w95)

            path_h = serve.history_file("headline", headline_events)
            cut = _closed_cut(lines, 0.6)
            path_60 = os.path.join(tmp, "headline-60.jsonl")
            with open(path_60, "w", encoding="utf-8") as f:
                f.write("".join(line + "\n" for line in lines[:cut]))
            cold = quiet_cli(["check", "-file", path_h, "-no-viz"])[0]
            r60 = db2.client.submit(open(path_60, encoding="utf-8").read(), client="h60", no_viz=True)
            t0 = time.monotonic()
            rh = db2.client.submit(open(path_h, encoding="utf-8").read(), client="head", no_viz=True)
            wall_h = time.monotonic() - t0
            hits = [e for e in serve.events_of(db2) if e["ev"] == "prefix_hit"]
            if r60["verdict"] != 0 or rh["verdict"] != cold or not hits or hits[-1]["resume_ops"] <= 0 or (
                    not rh["backend"].startswith("frontier-resume")):
                fail(f"batch-prefix (b): the 60% cut {r60}, the headline {rh} (cold check exit {cold}), "
                     f"prefix_hit events {hits}")
            print(f"batch-prefix (b): 60% of the headline ({cut} of {len(lines)} events, a closed cut): "
                  f"{r60['backend']} {r60['wall_s']} s; the whole headline: prefix_hit, resume_ops "
                  f"{hits[-1]['resume_ops']} of {hits[-1]['ops']}, {rh['backend']}, daemon {rh['wall_s']} s, "
                  f"client {wall_h:.3f} s, verdict {rh['verdict']} == a cold `check`'s exit {cold}", flush=True)
            wall("(b) the whole headline after the 60% cut", wall_h)

            c0 = launches(db2)["children"].get("fold_lanes", 0)
            t0 = time.monotonic()
            r10 = db2.client.submit(open(serve.history_file("k10", k10_events), encoding="utf-8").read(),
                                    client="k10", no_viz=True)
            wall_10 = time.monotonic() - t0
            n_10 = launches(db2)["children"].get("fold_lanes", 0) - c0
            with open(os.path.join(serve.record, f"job-{db2.pid}-{r10['job']}.json"), encoding="utf-8") as f:
                rec = json.load(f)
            pinned = {k: (rec["stats"] or {}).get(k) for k in K10_DEVICE_STATS}
            spans = serve.job_spans(db2, r10["job"])
            if r10["verdict"] != 0 or r10["backend"] != "device-supervised" or "search.cold" not in spans:
                fail(f"batch-prefix (b): k=10 {r10}, spans {sorted(spans)}")
            if device is None and (n_10 != 11 or pinned != K10_DEVICE_STATS):
                fail(f"batch-prefix (b): k=10's child made {n_10} fold launches, statistics {pinned}")
            store = read_cold(state)
            print(f"batch-prefix (b): k=10: its cold prefix plan (`search.cold`, {spans['search.cold']:.3f} s "
                  f"against the {budget_s} s budget) escalated to a supervised child: backend {r10['backend']}, "
                  f"escalation {spans.get('device[supervised]', 0):.3f} s, client {wall_10:.3f} s, {n_10} fold "
                  f"launches, statistics {pinned}; the store: {store['entries']} entries, {store['bytes']} bytes, "
                  f"deepest {store['deepest_ops']} ops", flush=True)
            out["launches_by_path"]["adversarial k=10 prefix-planned, escalated in the supervised child (17b)"] = n_10
            wall("(b) k=10 prefix-planned", wall_10)
            wall("(b) k=10 cold prefix search", spans["search.cold"])

            # (c) The operator commands against (b)'s daemon.
            walls_c = {}
            for name, argv in (("trace", ["trace", "-socket", db2.sock, "-out", os.path.join(tmp, "trace.json")]),
                               ("watch", ["watch", "-socket", db2.sock, "--iterations", "1"]),
                               ("dash", ["dash", "-socket", db2.sock, "--iterations", "1"])):
                t0 = time.monotonic()
                rc, text = quiet_cli(argv)
                walls_c[name] = time.monotonic() - t0
                if rc != 0:
                    fail(f"batch-prefix (c): `{name}` exit {rc}")
            with open(os.path.join(tmp, "trace.json"), encoding="utf-8") as f:
                spans_n = len(json.load(f)["traceEvents"])
            print(f"batch-prefix (c): `trace` ({spans_n} events), `watch` and one `dash` frame against (b)'s "
                  f"daemon: exit 0 each, in " + ", ".join(f"{k} {v:.3f} s" for k, v in walls_c.items()), flush=True)
            serve.stop(db2)
        finally:
            serve.kill_all()
        calls = serve.fold_calls(device)
        if device is None and len(calls) != n_a + n_10:
            fail(f"batch-prefix: {len(calls)} recorded fold calls, {n_a} + {n_10} counted")
        if calls:
            recheck_calls(calls, "batching and prefix (phase 17)")
        print(f"batch-prefix: {len(calls)} recorded fold calls, bit-exact", flush=True)
    out["seconds"] = time.monotonic() - t_phase
    return out


#: phase 18 (d): the distributed search's workload, shaped like the JAX
#: package's ``scripts/distsearch_check.py:72`` ``build_workload``: rounds of
#: concurrent indefinite appends, each closed by a check-tail barrier, then
#: one impossible check-tail (ILLEGAL, decided by the exhaustive partition
#: searches).  7 rounds of 3 keep each partition inside the backends' 2 s
#: CPU budget (under a second for the largest in the phase's CPU
#: rehearsal, ``tests/test_torch_router.py``): a partition never escalates,
#: so one that outlasts the budget answers UNKNOWN
DIST_ROUNDS, DIST_BRANCH = 7, 3
#: phase 18 (b): the client-id offset of k=10's twin
FLEET_TWIN_OFFSET = 5000


def dist_workload(rounds: int = DIST_ROUNDS, k: int = DIST_BRANCH, base: int = 41_000) -> list:
    """The events of ``build_workload(rounds, k, base)``, from the port's
    own event types."""
    from s2_verification_tpu_torch.utils import events as ev

    out, next_op = [], [0]

    def start(client, payload):
        op = next_op[0]
        next_op[0] += 1
        out.append(ev.LabeledEvent(payload, client, op))
        return op

    def check_tail(tail):
        op = start(99, ev.CheckTailStart())
        out.append(ev.LabeledEvent(ev.CheckTailSuccess(tail=tail), 99, op))

    for r in range(rounds):
        ops = [(10 + i, start(10 + i, ev.AppendStart(num_records=1, record_hashes=(base + 10 * r + i,),
                                                      set_fencing_token=None, fencing_token=None,
                                                      match_seq_num=None)))
               for i in range(k)]
        for client, op in ops:
            out.append(ev.LabeledEvent(ev.AppendIndefiniteFailure(), client, op))
        check_tail(r + 1)
    check_tail(10_000)  # impossible: at most ``rounds`` records applied
    return out


def run_fleet_phase(dev_mod, fb, prepare, recheck_calls, k10_events, device=None, budget_s=2.0) -> dict:
    """Phase 18, the fleet tier on the card: two of the port's ``serve``
    backends as their own processes (through :data:`VERIFYD_WRAPPER`, fold
    calls saved as they happen), each ``--device inline`` with its own
    state dir and metrics listener, behind the port's ``route serve`` —
    (a) k=10 decided on its ring home's card and answered again from the
    router's edge cache; (b) k=10's client-id twin, its home SIGKILLed once
    its escalation has launched the fold: failed over to the other node's
    card, the victim back on its state dir replaying the orphan, ``route
    fleet`` showing both up; (c) both nodes' launch counts on
    ``/fleet/metrics`` and the stitched ``trace``; (d) ``submit
    --distributed`` against the host oracle, the grant ledger read cold;
    (e) ``route drain``; (f) ``soak`` clean and with its mislabeled
    control.  ``device=None`` is the card, ``"cpu"`` rehearses the phase on
    the CPU (``--torch-device cpu``).  Returns the fold launches by path and
    the walls."""
    import urllib.request

    from s2_verification_tpu_torch.checker.frontier import check_frontier_auto
    from s2_verification_tpu_torch.checker.stats import FrontierStats
    from s2_verification_tpu_torch.service.cache import history_fingerprint
    from s2_verification_tpu_torch.service.client import VerifydClient
    from s2_verification_tpu_torch.service.journal import read_grants_cold
    from s2_verification_tpu_torch.service.router import HashRing, VerifydRouter

    t_phase = time.monotonic()
    card = fb.card()
    out = {"launches_by_path": {}, "walls": {}}
    torch_dev = [] if device is None else ["--torch-device", device]

    def wall(tag, seconds):
        out["walls"][tag] = seconds
        print(f"fleet {tag}: {seconds:.3f} s wall; {card}", flush=True)

    url, alerts, receiver = _alert_receiver()
    with tempfile.TemporaryDirectory() as tmp:
        serve = ServeProcesses(tmp, "fleet", [*torch_dev, "--no-viz", "--time-budget", str(budget_s), "--profile",
                                              "--drain-timeout", "30"], VERIFYD_RECORD_LIVE="1")
        record, events_of = serve.record, serve.events_of
        # Each backend keeps its metrics port across a restart, so the
        # router's ``@healthz`` probe finds the restarted node again.
        ports = {n: _free_port() for n in "ab"}
        socks = {n: os.path.join(tmp, f"{n}.sock") for n in "ab"}
        nodes: dict = {}
        router_proc = None

        def spawn(name, tag):
            if os.path.exists(socks[name]):
                os.remove(socks[name])  # SIGKILL leaves the socket file; serve refuses it
            nodes[name] = serve.spawn(tag, "inline", "--state-dir", os.path.join(tmp, f"state-{name}"),
                                      "--metrics-port", str(ports[name]), sock=socks[name])
            return nodes[name]

        def ready(d):
            serve.ready(d)
            wall(f"boot {d.tag}", d.boot_s)
            return d

        def inline_launches(d):
            return d.client.stats()["introspection"]["launches"]["inline"].get("fold_lanes", 0)

        def job_record(d, job):
            with open(os.path.join(record, f"job-{d.pid}-{job}.json"), encoding="utf-8") as f:
                return json.load(f)

        def same_search(rec, events, what):
            got = _stats_view(FrontierStats(**rec["stats"]))
            if rec["backend"] != "device-inline" or rec["linearization"] != ref.linearization or (
                    rec["steps"] != ref.steps or got != _stats_view(ref.stats)):
                fail(f"fleet {what}: backend {rec['backend']}, or witness/steps/stats differ from "
                     f"check_device_auto in this process")
            if not replay_fast(prepare(events), rec["linearization"]):
                fail(f"fleet {what}: the witness does not replay")
            pinned = {k: rec["stats"][k] for k in K10_DEVICE_STATS}
            if device is None and pinned != K10_DEVICE_STATS:
                fail(f"fleet {what}: statistics {pinned} != {K10_DEVICE_STATS}")

        def run_cli(*argv, timeout=300):
            return subprocess.run([sys.executable, "-m", "s2_verification_tpu_torch", *argv], env=serve.env,
                                  cwd=tmp, capture_output=True, text=True, timeout=timeout)

        def fleet_view():
            got = run_cli("route", "fleet", "-socket", rsock, "--json", timeout=60)
            if got.returncode != 0:
                fail(f"fleet: `route fleet` exited {got.returncode}: {got.stderr[-2000:]}")
            return {b["name"]: b for b in json.loads(got.stdout)["backends"]}

        def wait_fleet(pred, what, limit=60):
            t0 = time.monotonic()
            while True:
                view = fleet_view()
                if pred(view):
                    return view, time.monotonic() - t0
                if time.monotonic() - t0 > limit:
                    fail(f"fleet {what}: `route fleet` shows {view}")
                time.sleep(0.2)

        try:
            ref = dev_mod.check_device_auto(prepare(k10_events), checkpoint_path=os.path.join(tmp, "ref.ckpt.npz"),
                                            profile=True, device=device)
            for d in [spawn(name, name) for name in "ab"]:  # side by side
                ready(d)
            rsock = os.path.join(tmp, "router.sock")
            router_err = open(os.path.join(tmp, "router.stderr"), "w", encoding="utf-8")
            t0 = time.monotonic()
            router_proc = subprocess.Popen(
                [sys.executable, "-m", "s2_verification_tpu_torch", "route", "serve", "--listen", rsock,
                 *[x for n in "ab" for x in ("--backend", f"{n}={socks[n]}@http://127.0.0.1:{ports[n]}/healthz")],
                 "--metrics-port", "0", "--state-dir", os.path.join(tmp, "state-router")],
                env=serve.env, cwd=tmp, stdout=subprocess.DEVNULL, stderr=router_err)
            while not os.path.exists(rsock):
                if router_proc.poll() is not None or time.monotonic() - t0 > 120:
                    router_err.flush()
                    fail(f"fleet: route serve exited {router_proc.poll()} before its socket appeared: "
                         f"{open(router_err.name, encoding='utf-8').read()[-3000:]}")
                time.sleep(0.05)
            rc = VerifydClient(rsock, timeout=900)
            if rc.ping()["server"] != "verifyd-router" or _has_torch(router_proc.pid):
                fail("fleet: the router answers no ping, or loaded torch")
            wall("router boot", time.monotonic() - t0)
            ring = HashRing(["a", "b"], replicas=64)

            def home(events):
                hist = prepare(events, elide_trivial=True)
                return ring.lookup(VerifydRouter._affinity_key(hist, history_fingerprint(hist)))

            def text_of(events):
                from s2_verification_tpu_torch.utils import events as ev

                buf = io.StringIO()
                ev.write_history(events, buf)
                return buf.getvalue()

            # (a) Affinity: k=10 decided on its home node's card.
            k10_home = home(k10_events)
            before = {n: inline_launches(d) for n, d in nodes.items()}
            t0 = time.monotonic()
            line = rc.submit(text_of(k10_events), client="k10", no_viz=True)
            wall_a = time.monotonic() - t0
            n_a = {n: inline_launches(d) - before[n] for n, d in nodes.items()}
            if line["verdict"] != 0 or line["node"] != k10_home or line["backend"] != "device-inline":
                fail(f"fleet (a): {line} (home {k10_home})")
            same_search(job_record(nodes[k10_home], line["job"]), k10_events, "(a)")
            if (device is None and n_a[k10_home] <= 0) or any(v for n, v in n_a.items() if n != k10_home):
                fail(f"fleet (a): fold launches by node {n_a}, home {k10_home}")
            t0 = time.monotonic()
            again = rc.submit(text_of(k10_events), client="k10", no_viz=True)
            wall_hit = time.monotonic() - t0
            if not (again["router_cached"] and again["node"] == k10_home) or any(
                    inline_launches(d) - before[n] - n_a[n] for n, d in nodes.items()):
                fail(f"fleet (a): the resubmit {again} was not answered from the edge cache with no launch")
            print(f"fleet (a): k=10 through the router: home {k10_home} (ring of 2 x 64), backend device-inline, "
                  f"statistics == K10_DEVICE_STATS and check_device_auto's, witness replays; fold launches by node "
                  f"{n_a}; the resubmit router_cached in {wall_hit:.3f} s with no launch", flush=True)
            out["launches_by_path"][f"adversarial k=10 routed to its home node {k10_home} (18a)"] = n_a[k10_home]
            wall("(a) routed k=10", wall_a)
            wall("(a) resubmit from the edge cache", wall_hit)

            # (b) Failover: the twin's home SIGKILLed mid-escalation.
            twin = client_twin(k10_events, FLEET_TWIN_OFFSET)
            victim = home(twin)
            other = "b" if victim == "a" else "a"
            vd = nodes[victim]
            count_file = os.path.join(record, f"fold-count-{vd.pid}")

            def recorded():
                try:
                    with open(count_file, encoding="utf-8") as f:
                        return int(f.read())
                except (OSError, ValueError):
                    return 0

            base, before_other = recorded(), inline_launches(nodes[other])
            got: dict = {}

            def submit_twin():
                try:
                    got["reply"] = rc.submit(text_of(twin), client="twin", no_viz=True)
                except Exception as e:  # noqa: BLE001 - reported below
                    got["error"] = repr(e)

            th = threading.Thread(target=submit_twin)
            t0 = time.monotonic()
            th.start()
            while recorded() <= base:
                if time.monotonic() - t0 > 120 or not th.is_alive():
                    fail(f"fleet (b): the twin's first fold call on {victim} never came ({got})")
                time.sleep(0.005)
            vd.proc.send_signal(signal.SIGKILL)
            vd.proc.wait(timeout=60)
            vd.err.close()
            killed_after = time.monotonic() - t0
            kept = len(torch.load(os.path.join(record, f"folds-serve-inline-{vd.pid}.pt"))["calls"]) - base
            # The victim restarts on its state dir at once, as a supervisor
            # would restart it, while the router fails the twin over.
            rd = spawn(victim, f"{victim}2")
            th.join(timeout=600)
            wall_b = time.monotonic() - t0
            reply = got.get("reply")
            if reply is None or reply["verdict"] != 0 or reply["node"] != other or reply["backend"] != "device-inline":
                fail(f"fleet (b): the twin's reply after the kill {got}")
            same_search(job_record(nodes[other], reply["job"]), twin, "(b) failover")
            n_fail = inline_launches(nodes[other]) - before_other
            if device is None and n_fail <= 0:
                fail(f"fleet (b): the failover made {n_fail} fold launches on {other}")
            failovers = rc.stats()["failovers"]
            if failovers < 1:
                fail(f"fleet (b): the router counts {failovers} failovers")
            print(f"fleet (b): SIGKILL of {victim} {killed_after:.3f} s after the twin's submit, once its first fold "
                  f"call was recorded ({kept} of its calls saved); the router failed over ({failovers} failover(s)) "
                  f"to {other}, which decided it on its card: device-inline, {n_fail} fold launches, statistics == "
                  f"K10_DEVICE_STATS, witness replays; the client waited {wall_b:.3f} s", flush=True)
            out["launches_by_path"][f"k=10's twin on {victim} until its SIGKILL (18b)"] = kept
            out["launches_by_path"][f"k=10's twin failed over to {other} (18b)"] = n_fail
            wall("(b) twin submit through the kill and the failover", wall_b)
            ready(rd)
            t0 = time.monotonic()
            while rd.client.stats()["completed"] < 1:
                if time.monotonic() - t0 > 300:
                    fail(f"fleet (b): {victim}'s orphan never replayed")
                time.sleep(0.05)
            orphan = [e for e in events_of(rd) if e["ev"] == "orphan"]
            twin_fp = history_fingerprint(prepare(twin, elide_trivial=True))
            if [e["fingerprint"] for e in orphan] != [twin_fp]:
                fail(f"fleet (b): orphan events {orphan}")
            same_search(job_record(rd, orphan[0]["job"]), twin, "(b) replay")
            n_replay = inline_launches(rd)
            if device is None and n_replay <= 0:
                fail(f"fleet (b): the replay made {n_replay} fold launches")
            done = [e for e in events_of(rd) if e["ev"] == "done" and e.get("job") == orphan[0]["job"]]
            wall("(b) orphan replay after the reboot's ping", time.monotonic() - t0)
            wall("(b) orphan replay in the daemon", float(done[0]["wall_s"]) if done else float("nan"))
            view, up_s = wait_fleet(lambda v: all(b["up"] is True for b in v.values()), "(b) rejoin")
            print(f"fleet (b): {victim} back on its state dir replayed the orphan on its card ({n_replay} fold "
                  f"launches, statistics == K10_DEVICE_STATS); `route fleet` shows "
                  f"{ {n: b['up'] for n, b in view.items()} } {up_s:.3f} s after the replay; every accepted job "
                  f"answered (the twin by {other}, its orphan replayed by {victim})", flush=True)
            out["launches_by_path"][f"k=10's twin replayed as an orphan on {victim} (18b)"] = n_replay

            # (c) The fleet plane and the stitched trace.
            rport = rc.stats()["metrics_port"]
            want = {}
            for n, d in nodes.items():
                if d.proc.poll() is None:
                    want[n] = inline_launches(d)
            # On the card each node's launch count; on the CPU (no launch
            # is counted) its up gauge.
            lines = {n: f'verifyd_kernel_launches_total{{node="{n}",kernel="fold_lanes",where="inline"}} {v}'
                     if device is None else f'verifyd_fleet_node_up{{node="{n}"}} 1' for n, v in want.items()}
            t0 = time.monotonic()
            while True:
                text = urllib.request.urlopen(f"http://127.0.0.1:{rport}/fleet/metrics", timeout=30).read().decode()
                if all(x in text.splitlines() for x in lines.values()):
                    break
                if time.monotonic() - t0 > 30:
                    fail(f"fleet (c): /fleet/metrics lacks {list(lines.values())}")
                time.sleep(0.2)
            for n, d in nodes.items():
                own = urllib.request.urlopen(f"http://127.0.0.1:{ports[n]}/metrics", timeout=30).read().decode()
                mine = f'verifyd_kernel_launches_total{{kernel="fold_lanes",where="inline"}} {want[n]}'
                if device is None and mine not in own.splitlines():
                    fail(f"fleet (c): {n}'s own /metrics lacks `{mine}`")
            trace = rc.trace()
            procs = sorted(e["args"]["name"] for e in trace["traceEvents"]
                           if e.get("ph") == "M" and e.get("name") == "process_name")
            router_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "router")
            backend_spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("pid", 0) >= 1000)
            if not router_spans or not backend_spans or not {"verifyd[a]", "verifyd[b]"} <= set(procs):
                fail(f"fleet (c): the stitched trace holds {router_spans} router and {backend_spans} backend "
                     f"spans, processes {procs}")
            print(f"fleet (c): /fleet/metrics carries " + "; ".join(lines.values()) + f" (== each node's own "
                  f"/metrics, the node label added); the stitched trace holds {router_spans} router and "
                  f"{backend_spans} backend spans over {procs}", flush=True)

            # (d) A distributed search.
            dist = dist_workload()
            dist_path = serve.history_file("dist", dist)
            t0 = time.monotonic()
            oracle = check_frontier_auto(prepare(dist))
            oracle_s = time.monotonic() - t0
            t0 = time.monotonic()
            dreply = rc.submit(text_of(dist), client="dist", no_viz=True, distributed=True)
            wall_d = time.monotonic() - t0
            want_v = {"ok": 0, "illegal": 1}[oracle.outcome.value]
            if not dreply.get("distributed") or dreply["verdict"] != want_v or dreply["stale_accepted"] != 0:
                fail(f"fleet (d): {dreply} against the host oracle's {oracle.outcome.value}")
            cli_d = run_cli("submit", "-socket", rsock, "-file", dist_path, "--distributed", "-stats")
            if cli_d.returncode != want_v:
                fail(f"fleet (d): `submit --distributed` exited {cli_d.returncode}, not {want_v}")
            ds = rc.stats()["distsearch"]
            cold = read_grants_cold(os.path.join(tmp, "state-router"))
            (search,) = cold["searches"].values()
            if ds["searches"] != 1 or ds["fallbacks"] != 0 or cold["open_total"] != 0 or (
                    search["verdict"] != want_v or search["open_grants"]):
                fail(f"fleet (d): distsearch {ds}, the ledger read cold {cold}")
            print(f"fleet (d): `submit --distributed` of build_workload({DIST_ROUNDS}, {DIST_BRANCH}) "
                  f"({len(prepare(dist).ops)} ops): verdict {dreply['outcome']} == check_frontier_auto's (host, "
                  f"{oracle_s:.3f} s), {dreply['partitions']} partitions, {dreply['grants']} grants, "
                  f"{dreply['regrants']} regrants, {dreply['fences']} fences, 0 stale deltas merged, owners "
                  f"{sorted(set(dreply['owners'].values()))}; the CLI exits {cli_d.returncode}; the grant ledger read "
                  f"cold: search closed ({search['outcome']}), 0 open grants, {search['fences']} fence records",
                  flush=True)
            wall("(d) distributed search", wall_d)
            wall("(d) host oracle", oracle_s)

            # (e) Drain a; the router keeps answering on b.
            t0 = time.monotonic()
            drain = run_cli("route", "drain", "a", "-socket", rsock)
            if drain.returncode != 0:
                fail(f"fleet (e): `route drain a` exited {drain.returncode}: {drain.stderr[-2000:]}")
            rc_a = nodes["a"].proc.wait(timeout=120)
            nodes["a"].err.close()
            if rc_a != 0:
                fail(f"fleet (e): backend a exited {rc_a} after the drain")
            wall("(e) drain a", time.monotonic() - t0)
            small = dist_workload(3, 2, base=77_000)[:-2]  # linearizable: no impossible tail
            after = rc.submit(text_of(small), client="after-drain", no_viz=True)
            if after["verdict"] != 0 or after["node"] != "b":
                fail(f"fleet (e): after the drain {after}")
            print("fleet (e): `route drain a` exit 0, backend a exit 0, a fresh history answered by b", flush=True)

            # (f) Soak through the router.
            soak = ["soak", rsock, "--campaign", "steady", "--campaign", "drop-acked", "--seed", str(CAMPAIGN_SEED)]
            t0 = time.monotonic()
            clean = run_cli(*soak)
            soak_s = time.monotonic() - t0
            t0 = time.monotonic()
            control = run_cli(*soak, "--mislabel-control", "--alert-url", url)
            control_s = time.monotonic() - t0
            fired = any(a["labels"]["alertname"] == "checker_false_verdict" for body in alerts for a in body)
            if clean.returncode != 0 or control.returncode != 1 or not fired:
                fail(f"fleet (f): soak exited {clean.returncode} (want 0), with --mislabel-control "
                     f"{control.returncode} (want 1), webhook {'received' if fired else 'missing'}: "
                     f"{clean.stderr[-1500:]} {control.stderr[-1500:]}")
            print(f"fleet (f): soak over steady and drop-acked through the router: exit 0 "
                  f"({clean.stdout.strip().splitlines()[-1]}); with --mislabel-control exit 1 and the "
                  f"checker_false_verdict webhook received", flush=True)
            wall("(f) soak", soak_s)
            wall("(f) soak with the mislabeled control", control_s)
            rc.shutdown()
            if router_proc.wait(timeout=60) != 0:
                fail("fleet: route serve exited nonzero after shutdown")
            router_err.close()
            serve.stop(nodes["b"])
        finally:
            receiver.shutdown()
            serve.kill_all()
            if router_proc is not None and router_proc.poll() is None:
                router_proc.kill()
                router_proc.wait(timeout=30)

        calls = serve.fold_calls(device)
        counted = n_a[k10_home] + kept + n_fail + n_replay
        if device is None and len(calls) != counted:
            fail(f"fleet: {len(calls)} recorded fold calls, {counted} counted")
        if calls:
            recheck_calls(calls, "the fleet (phase 18)")
        print(f"fleet: {len(calls)} recorded fold calls, bit-exact", flush=True)
    out["seconds"] = time.monotonic() - t_phase
    return out


def run_lint_phase(here: str) -> dict:
    """Phase 19, ``lint`` on the host: ``python -m s2_verification_tpu_torch
    lint --json`` over the checkout's port tree against its own baseline,
    which must exit 0 with no new error and no stale key, in a process
    that imports no torch, no jax and nothing of the JAX package (``-X
    importtime`` names every module it imports), and ``lint
    --check-events-md``.  Returns the phase's numbers."""
    t_phase = time.monotonic()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = here

    def lint(*args):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "s2_verification_tpu_torch", "lint", *args],
            cwd=here, env=env, capture_output=True, text=True, timeout=120,
        )
        return proc, time.monotonic() - t0

    proc, wall_s = lint("--json")
    if proc.returncode != 0:
        fail(f"lint: `lint --json` exited {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    doc = json.loads(proc.stdout)
    if doc["new_errors"] or doc["stale_baseline_keys"]:
        fail(f"lint: {len(doc['new_errors'])} new errors, stale keys {doc['stale_baseline_keys']}")
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in proc.stderr.splitlines() if line.startswith("import time:")}
    banned = imported & {"torch", "jax", "s2_verification_tpu"}
    if banned or "s2_verification_tpu_torch" not in imported:
        fail(f"lint: the lint process imported {sorted(banned)}, or importtime said nothing of it")
    out = {"files": doc["files"], "findings": len(doc["findings"]), "baselined": doc["baselined"],
           "suppressed": doc["suppressed"], "wall_s": wall_s}
    print(f"lint (a): `lint --json` exit 0 in {wall_s:.3f} s: {out['files']} files, {out['findings']} findings "
          f"({out['baselined']} baselined, 0 new, 0 stale keys), {out['suppressed']} suppressed; "
          f"{len(imported)} top-level modules imported, none of torch, jax or the JAX package", flush=True)
    proc, md_s = lint("--check-events-md")
    if proc.returncode != 0:
        fail(f"lint: `lint --check-events-md` exited {proc.returncode}: {proc.stderr[-1500:]}")
    print(f"lint (b): `lint --check-events-md` exit 0 in {md_s:.3f} s: {proc.stdout.strip()}", flush=True)
    out["events_md_s"] = md_s
    out["seconds"] = time.monotonic() - t_phase
    return out


def _stats_view(stats) -> dict:
    """Search statistics of a result, the profile timeline without its wall
    times: equal between a child and the same call in process."""
    import dataclasses

    d = dataclasses.asdict(stats)
    d["timeline"] = [{k: v for k, v in e.items() if k != "elapsed_s"} for e in d["timeline"]]
    return d


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
        graphs0 = dev_mod.GRAPH_CAPTURES[0], dev_mod.GRAPH_REPLAYS[0]
        t0 = time.monotonic()
        rc, captured, stats = run_cli(events, "headline-5x2000")
        torch.cuda.synchronize()
        first_wall = time.monotonic() - t0
        collector_launches = dict(fold_cuda.LAUNCHES)
        syncs = dev_mod.SYNCS[0] - syncs0
        peak = torch.cuda.max_memory_allocated()
        captures, replays = dev_mod.GRAPH_CAPTURES[0] - graphs0[0], dev_mod.GRAPH_REPLAYS[0] - graphs0[1]
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
    card_name = fb.card()
    print(
        f"headline check (CLI, in process): exit 0 OK, witness replays; {len(hist.ops)} checked ops; "
        f"layers {stats['layers']}, peak frontier {stats['max_frontier']}, expanded "
        f"{stats['expanded']} (== the CPU run); host syncs {syncs}, fold launches "
        f"{collector_launches['fold_lanes']}; {walls_text(first_wall, warm, len(hist.ops))}; "
        f"peak memory {peak / 2**30:.3f} GiB; card {card_name}",
        flush=True,
    )
    print(f"cli stats: {json.dumps(stats)}", flush=True)
    headline_events, headline_walls = events, (first_wall, list(warm))

    # The small buckets' layers replay from CUDA graphs: the recorder takes
    # each replayed fold's inputs after its replay, so the calls are every
    # fold that ran, a graph's warm-up included.  The same search with no
    # graph must give the same verdict, witness and statistics, and launch
    # the same folds less the warm-ups (one fold a graph).
    if not captures or not replays:
        fail(f"headline: {captures} layer graphs captured, {replays} layers replayed")
    if len(calls) != collector_launches["fold_lanes"]:
        fail(f"recorded {len(calls)} headline fold calls, counted {collector_launches['fold_lanes']}")
    eager_after = dev_mod._GRAPH_AFTER
    dev_mod._GRAPH_AFTER = 1 << 62
    try:
        fold_cuda.reset_launches()
        replays0 = dev_mod.GRAPH_REPLAYS[0]
        res_e = dev_mod.check_device_auto(hist, collect_stats=True)
        torch.cuda.synchronize()
        eager_launches = fold_cuda.LAUNCHES["fold_lanes"]
    finally:
        dev_mod._GRAPH_AFTER = eager_after
    if dev_mod.GRAPH_REPLAYS[0] != replays0:
        fail(f"headline without graphs: {dev_mod.GRAPH_REPLAYS[0] - replays0} layers replayed")
    if (res_e.outcome, res_e.linearization, dataclasses.asdict(res_e.stats)) != (
            res.outcome, res.linearization, dataclasses.asdict(res.stats)):
        fail("headline: the search with no graph differs from the replayed one in its verdict, witness "
             "or statistics")
    if eager_launches + captures != collector_launches["fold_lanes"]:
        fail(f"headline: {eager_launches} fold launches with no graph, {collector_launches['fold_lanes']} "
             f"with {captures} graphs")
    print(f"headline with no graph: the same verdict, witness and statistics; {eager_launches} fold "
          f"launches, the replayed run's {collector_launches['fold_lanes']} less its {captures} warm-ups "
          f"({replays} layers replayed)", flush=True)

    # Every fold call of the headline again, the replayed ones included:
    # bit-exact against the plain fold (one plain fold per table over all
    # its calls' lanes), then timed in groups small enough to queue behind
    # one spin kernel.
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
    with breakdown.expanded_layers(breakdown.profiled_window(start, 100, box)):
        dev_mod.check_device_auto(hist, prune=True, speculate_depth=3)
        torch.cuda.synchronize()
    if "wall" not in box:
        fail(f"pruned headline: the search expanded fewer than {start + 100} layers")
    window = breakdown.busy(box["prof"], box["wall"])
    print(
        f"pruned headline check (CLI --prune --speculate-depth 3, in process): exit 0 OK, witness "
        f"replays; statistics == the JAX engine's {json.dumps(got_stats)}; host syncs {syncs} "
        f"(un-pruned: see above), fold launches {head_launches['fold_lanes']}; "
        f"{walls_text(first_wall, warm, len(hist.ops))}; peak memory "
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

    # -- 14. the supervised device escalation ------------------------------
    phase14 = run_supervise_phase(dev_mod, fb, prepare, main_events, headline_events)
    print(f"phase 14 (supervised escalation): {phase14['seconds']:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(phase14["launches_by_path"])

    # -- 15. verifyd -----------------------------------------------------------
    small = next(e for name, e in table_events.items() if not name.endswith("x2000"))
    phase15 = run_verifyd_phase(dev_mod, fb, prepare, recheck_calls, main_events, headline_events,
                                phase12["lane_events"], phase12["lane_verdicts"],
                                adversarial_events(6, batch=100, seed=0, unsatisfiable=True),
                                adversarial_events(10, batch=100, seed=0, unsatisfiable=True), small)
    print(f"phase 15 (verifyd): {phase15['seconds']:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(phase15["launches_by_path"])

    # -- 16. verifyd's durability and ops layer ----------------------------
    phase16 = run_durable_phase(dev_mod, fb, prepare, recheck_calls, main_events)
    print(f"phase 16 (verifyd durability): {phase16['seconds']:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(phase16["launches_by_path"])

    # -- 17. batching, prefix resume and the operator commands --------------
    phase17 = run_batch_prefix_phase(dev_mod, fb, prepare, recheck_calls, main_events, headline_events,
                                     collect_lanes(PHASE17_SHAPE, PHASE17_SEEDS))
    print(f"phase 17 (batching and prefix resume): {phase17['seconds']:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(phase17["launches_by_path"])

    # -- 18. the fleet tier ----------------------------------------------------
    phase18 = run_fleet_phase(dev_mod, fb, prepare, recheck_calls, main_events)
    print(f"phase 18 (the fleet): {phase18['seconds']:.1f} s", flush=True)
    kernels[0]["launches_by_path"].update(phase18["launches_by_path"])

    # -- 19. lint, on the host ---------------------------------------------------
    phase19 = run_lint_phase(here)
    print(f"phase 19 (lint): {phase19['seconds']:.1f} s", flush=True)

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
