"""GPU frontier linearizability search (PyTorch + the CUDA fold kernel).

Port of the JAX package's ``checker/device.py``: the same layer-by-layer
frontier search with the same encoding, Zobrist draw, mixed-radix packed
keys, lane hashes, probe-table dedup, beam selection and compaction, so
both engines produce identical frontier arrays after every layer.

A configuration row is ``(counts per chain, ONE candidate state)``:

- ``counts [F, C] int64`` — linearized prefix length of every chain;
- ``tail/hash/tok [F] int64`` — one model state (tail a u32, hash the 64
  bits of the stream hash, tok an interned token id);
- ``valid [F] bool`` — row occupancy.

One layer:

1. **auto-close** — rows advance past indefinite appends whose effect
   branch is provably dead (a frontier-wide sweep repeated while any row
   moves; skipped outright when the history has no op it could close);
2. **accept** — a row whose remaining ops are all indefinite appends
   accepts the history;
3. **expand** — every (row × candidate chain) steps through
   :func:`..ops.step_kernel.step_kernel`, with the chain-hash folds of the
   whole layer computed by ONE call of :func:`..ops.fold_cuda.fold_lanes`
   (the CUDA kernel on the card); an indefinite append emits two child
   rows, everything else one;
4. **dedup + compact** — three probe rounds of a scatter-min hash table
   with an exact compare against each slot's winner (or, with
   ``sort_dedup``, one lexicographic sort of the packed child identity),
   then beam selection by a bincount threshold and a cumsum scatter into
   the next frontier.

An exhaustive frontier that outgrows its expansion bucket stays on the
device up to ``device_rows_cap`` rows and is expanded in bucket-sized
chunks (:func:`_expand_layer_chunked`), as in the JAX engine.

Where the JAX engine runs the whole search as one compiled
``lax.while_loop``, this port drives the layers from a host loop and
fetches the handful of scalars that steer it: each such fetch is one
host<->device synchronisation, counted in ``FrontierStats.host_syncs``.
A lone forced row (:func:`_fast_multi`) steps one op per synchronisation.

With ``prune=True`` the tables carry the verdict-exact prunes of
``checker/prune.py`` (append rank gate, eager commit in auto-close, tail
pins); with ``speculate_depth > 0`` every search segment starts with one
speculative dive (:func:`_spec_dive`) that expands the best few rows a few
layers ahead through the same :func:`_expand_layer`.

An exhaustive frontier that outgrows the device too goes to the host-RAM
spill (:func:`_spill_search`): the frontier lives in host memory and streams
through the device in one-layer slabs, with an exact host-side dedup between
layers.  With ``checkpoint_path`` the search snapshots its frontier (or the
spill its host matrix) in the JAX engine's file format
(:mod:`.checkpoint`) and resumes from a matching snapshot.

With ``witness_max_frontier > 0`` the search keeps the JAX engine's
per-layer witness log while the frontier bucket fits that cap: every
committed layer records each child row's parent row and ``op*2 + branch``,
a forced stretch stops after one op, and an OK walks
the log back from the accept row (:func:`_witness_linearization`).

With ``mesh`` (:mod:`..parallel.distributed`) the frontier axis is
sharded over several shards (:func:`place_frontier`), on one device or
several, and :func:`run_search` runs each layer's per-row work on the
shards' devices and its cross-row work — the dedup, beam selection and
compaction — through one routing helper (:func:`_route`), so that the
sharded search computes the unsharded one's frontiers row for row.

Soundness under capacity pressure mirrors the JAX engine: an OK is always
conclusive; a dead end after beam pruning is UNKNOWN and
:func:`check_device_auto` escalates to the exhaustive phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
import zipfile
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from ..models.encode import (
    INF_TIME,
    EncodedHistory,
    encode_history,
    intern_state,
    op_class_masks,
    round_pow2,
)
from ..models.stream import StreamState, step_set
from ..obs.introspect import get_job_context
from ..obs.trace import SEARCH_TRACER
from ..ops import fold_cuda
from ..ops.fold_cuda import fold_lanes
from ..ops.step_kernel import DeviceOps, DeviceState, join_u64, step_kernel
from ..ops.xxh3 import shr
from ..utils.hashing import NATIVE_FOLDS, fold_record_hashes
from .entries import History
from .checkpoint import (
    Checkpoint,
    CheckpointError,
    fingerprint_mismatch_reason,
    history_fingerprint,
    load_checkpoint,
    save_checkpoint,
)
from .oracle import CheckOutcome, CheckResult
from .prune import RANK_INF, analyze_encoded, neutral_tables
from .stats import FrontierStats

__all__ = [
    "SearchTables",
    "Frontier",
    "ShardedFrontier",
    "RunOut",
    "DeviceUnavailable",
    "resolve_device",
    "build_tables",
    "tables_from_arrays",
    "init_frontier",
    "frontier_from_arrays",
    "place_frontier",
    "gather_frontier",
    "shard_tables",
    "can_exact_pack",
    "run_search",
    "run_search_lanes",
    "check_device",
    "check_device_auto",
    "default_device_rows_cap",
    "SYNCS",
    "FETCH_NS",
    "CLOSE_SWEEPS",
    "TOKEN_CLOSES",
    "GRAPH_CAPTURES",
    "GRAPH_REPLAYS",
]

log = logging.getLogger("s2_verification_tpu_torch.device")

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
_RANK_INF = int(RANK_INF)
_INF_TIME = int(INF_TIME)

#: beam-priority classes (linearized-indefinite-append counts) are clamped
#: here; ties above the clamp only coarsen pruning priority, never verdicts.
_OPENS_CAP = 256

#: rows of the first frontier bucket; capacity stops escalate from here
_START_FRONTIER = 16

#: the widest bucket whose layer expansion :func:`run_search` replays from a
#: CUDA graph (:class:`_LayerGraph`): up to it a layer is bound by the
#: host's launches (about 1,100 PyTorch calls an expansion against well
#: under a millisecond of device work), and a graph's private memory pool
#: stays small
_GRAPH_MAX_ROWS = 4096
#: eager expansions of one key in one :func:`run_search` call before its
#: graph is captured: more than the adversarial escalation ladder runs in
#: any one bucket (at most 3), so that a graph is captured only where
#: hundreds of replays follow
_GRAPH_AFTER = 8

#: host<->device synchronisations made by the search (see :func:`_fetch`)
SYNCS = [0]
#: host nanoseconds spent inside those synchronisations (each counted site
#: times its transfer to the host)
FETCH_NS = [0]
#: sweeps of the auto-close (:func:`_auto_close`, and the sharded loop's
#: :func:`_close_pin_shards`), each one counted synchronisation
CLOSE_SWEEPS = [0]
#: ops the auto-close's token arm passed (an indefinite append whose token
#: no op sets), summed on the device over a layer's sweeps and fetched with
#: the layer's head; counted by :func:`run_search` on one frontier (not the
#: lane or sharded loops), for tables with such an op (``tok_close``)
TOKEN_CLOSES = [0]
#: layer-expansion graphs captured, and layer expansions replayed from
#: them (:class:`_LayerGraph`; host, process-wide)
GRAPH_CAPTURES = [0]
GRAPH_REPLAYS = [0]


class SearchTables(NamedTuple):
    """Device-resident static tables for one encoded history."""

    ops: DeviceOps
    #: per-op: indefinite append (two-branch step)
    is_indef: torch.Tensor  # [N] bool
    #: per-op: indefinite append with a match_seq_num guard (auto-close arm 1)
    ac_match: torch.Tensor  # [N] bool
    #: per-op: indefinite append whose batch token is never set by any op
    ac_tok: torch.Tensor  # [N] bool
    #: accept_tab[c, k]: ops k.. of chain c are all indefinite appends
    accept_tab: torch.Tensor  # [C, Lc+1] bool
    #: opens_tab[c, k]: # indefinite appends among the first k ops of chain c
    opens_tab: torch.Tensor  # [C, Lc+1] int64
    #: Zobrist tables: zob*[c, k] is the u32 contribution of "chain c has
    #: linearized k ops" (drawn from PCG64(0x52C0FFEE), as in the JAX engine)
    zob1: torch.Tensor  # [C, Lc+2] int64
    zob2: torch.Tensor  # [C, Lc+2] int64
    #: mixed-radix strides of the exact packed counts key (u64 bit patterns
    #: in int64); zeros when prod(chain_len + 1) overflows 2^64
    pack: torch.Tensor  # [C] int64
    #: commutativity-prune tables (checker/prune.py); neutral, so that every
    #: consumer is a no-op, unless the search runs with ``prune=True``
    app_rank: torch.Tensor  # [N] int64
    minrank_tab: torch.Tensor  # [C, Lc+1] int64
    pintail_tab: torch.Tensor  # [C, Lc+1] int64
    inert: torch.Tensor  # [N] bool
    filter_succ: torch.Tensor  # [N] bool
    #: host flag: some op can ever be auto-closed or eagerly committed; when
    #: False the auto-close sweep is a provable no-op and is skipped
    can_close: bool
    #: host flag: some op is closable by the token arm (``ac_tok``); only
    #: then does the layer loop count :data:`TOKEN_CLOSES`
    tok_close: bool


class Frontier(NamedTuple):
    counts: torch.Tensor  # [F, C] int64
    tail: torch.Tensor  # [F] int64 (u32 values)
    hash: torch.Tensor  # [F] int64 (u64 bit patterns)
    tok: torch.Tensor  # [F] int64
    valid: torch.Tensor  # [F] bool

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])


class ShardedFrontier(NamedTuple):
    """A frontier placed on a mesh (:func:`place_frontier`): ``blocks`` are
    this process's shards in shard order, each a :class:`Frontier` of
    ``F / mesh.size`` consecutive rows on its shard's device."""

    blocks: tuple
    mesh: object

    @property
    def capacity(self) -> int:
        return self.blocks[0].capacity * self.mesh.size


class RunOut(NamedTuple):
    """Result of one :func:`run_search` call (scalars already on the host)."""

    frontier: Frontier  # accepting/resume frontier (closed) or children (a ShardedFrontier over a mesh)
    stop_code: int  # 0 running, 1 accept, 2 empty, 3 capacity
    accept_idx: int
    layers: int
    pruned_ever: bool
    max_live: int
    auto_closed: int
    expanded: int
    eager_closed: int
    pin_killed: int
    #: speculation counters: dive layers advanced (incl. rolled back),
    #: dives that found the accept, dives discarded on misprediction
    spec_layers: int
    spec_accepts: int
    spec_rollbacks: int
    #: counts of one live row of the deepest committed layer (diagnostics)
    deep_counts: torch.Tensor  # [C]
    #: their sum (ops committed), fetched with the scalars that steer the loop
    deep_ops: int
    #: on STOP_CAPACITY: the aborted layer's unique-children count
    want: int
    #: valid rows of ``frontier``
    live: int
    #: with ``log``: the witness log of each committed layer but an
    #: accept, as host arrays ``(rows, parents, opbrs)`` (the rows that hold
    #: a child, each child's parent row in the layer before and its
    #: ``op*2 + branch``); else None
    wlog: list | None = None


STOP_RUNNING, STOP_ACCEPT, STOP_EMPTY, STOP_CAPACITY = 0, 1, 2, 3


class DeviceUnavailable(RuntimeError):
    """The search was asked to run on a CUDA device and none is present."""


def resolve_device(device=None) -> torch.device:
    """The search's device: CUDA unless the caller names another.  Raises
    :class:`DeviceUnavailable` (a ``RuntimeError``) when CUDA is asked for
    (or defaulted to) and absent — the search never moves to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass device='cpu' to run the "
            "search on the CPU"
        )
    return dev


def _synced(transfer, x: torch.Tensor):
    """``transfer(x)``, a copy of ``x`` to the host: one counted
    synchronisation, its host time added to :data:`FETCH_NS`."""
    SYNCS[0] += 1
    t0 = time.perf_counter_ns()
    out = transfer(x)
    FETCH_NS[0] += time.perf_counter_ns() - t0
    return out


def _fetch(*xs) -> list[int]:
    """Bring scalar tensors to the host in one transfer (one counted
    synchronisation)."""
    return _synced(torch.Tensor.tolist, torch.stack([torch.as_tensor(x).to(torch.int64).reshape(()) for x in xs]))


def _fetch_lanes(*xs) -> list[list[int]]:
    """Bring per-lane vectors to the host in one transfer (one counted
    synchronisation)."""
    flat = _synced(torch.Tensor.tolist, torch.cat([x.reshape(-1).to(torch.int64) for x in xs]))
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()])
        at += x.numel()
    return out


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when there is none
    (``jnp.argmax`` over a bool axis)."""
    n = mask.shape[-1]
    i = torch.where(mask, torch.arange(n, device=mask.device), n).min(-1).values
    return torch.where(i == n, 0, i)


def _pack_strides(chain_len: np.ndarray) -> tuple[bool, np.ndarray]:
    """Mixed-radix strides for the packed counts key, as Python-int math.

    Returns ``(exact, strides_u64)``: ``exact`` iff every reachable counts
    vector maps to a distinct value below 2^64 (prod(chain_len+1) <= 2^64),
    in which case two counts vectors are equal iff their packed keys are."""
    strides = []
    acc = 1
    for ln in chain_len:
        strides.append(acc % (1 << 64))
        acc *= int(ln) + 1
    exact = acc <= (1 << 64)
    return exact, np.array(strides, dtype=np.uint64)


def can_exact_pack(enc: EncodedHistory) -> bool:
    """Whether this history's counts vectors pack exactly into u64 keys."""
    return _pack_strides(enc.chain_len)[0]


def _table_arrays(enc: EncodedHistory, prune: bool = False) -> dict[str, np.ndarray]:
    """The JAX engine's ``build_tables`` contents as numpy arrays, under the
    JAX field names (``ops.*`` for the op columns); the prune tables come
    from :func:`.prune.analyze_encoded` when ``prune`` is set."""
    n = int(enc.op_type.shape[0])
    c, lc = enc.chain_ops.shape
    pt = analyze_encoded(enc) if prune else neutral_tables(n, (c, lc))

    is_indef = op_class_masks(enc)["is_indef"]
    settable = {int(enc.set_token[j]) for j in range(n) if enc.has_set_token[j]}
    tok_never = np.array(
        [
            bool(enc.has_batch_token[j]) and int(enc.batch_token[j]) not in settable
            for j in range(n)
        ],
        bool,
    )
    accept_tab = np.ones((c, lc + 1), bool)
    opens_tab = np.zeros((c, lc + 1), np.int32)
    for ci in range(c):
        ln = int(enc.chain_len[ci])
        for k in range(ln):
            opens_tab[ci, k + 1] = opens_tab[ci, k] + int(is_indef[enc.chain_ops[ci, k]])
        for k in range(ln - 1, -1, -1):
            accept_tab[ci, k] = accept_tab[ci, k + 1] and bool(is_indef[enc.chain_ops[ci, k]])
    rng = np.random.Generator(np.random.PCG64(0x52C0FFEE))
    zob = rng.integers(0, 1 << 32, size=(2, c, lc + 2), dtype=np.uint32)
    exact, strides = _pack_strides(enc.chain_len)
    if not exact:
        strides = np.zeros(c, np.uint64)
    d = {f"ops.{k}": getattr(enc, k) for k in _JAX_OPS_FIELDS}
    d.update(
        is_indef=is_indef,
        ac_match=is_indef & enc.has_match,
        ac_tok=is_indef & tok_never,
        accept_tab=accept_tab,
        opens_tab=opens_tab,
        zob1=zob[0],
        zob2=zob[1],
        pack_hi=(strides >> np.uint64(32)).astype(np.uint32),
        pack_lo=strides.astype(np.uint32),
        app_rank=pt.app_rank,
        minrank_tab=pt.minrank_tab,
        pintail_tab=pt.pintail_tab,
        inert=pt.inert,
        filter_succ=pt.filter_succ,
    )
    return d


#: the JAX engine's DeviceOps field names (u64 columns as hi/lo pairs)
_JAX_OPS_FIELDS = (
    "op_type", "has_set_token", "set_token", "has_batch_token", "batch_token",
    "has_match", "match_seq", "num_records", "rh_row", "rh_len",
    "out_failure", "out_definite", "out_tail", "out_has_hash", "out_hash_hi",
    "out_hash_lo", "call", "ret", "chain_of", "rh_hi", "rh_lo", "chain_ops",
    "chain_len",
)


def tables_from_arrays(d: dict, device) -> SearchTables:
    """Search tables from numpy arrays named as the JAX engine's
    ``SearchTables`` fields, with the ``ops`` columns flattened to
    ``ops.<field>`` — so a JAX-built table set (Zobrist draw included) can
    be handed to this engine unchanged."""
    dev = torch.device(device)
    ops = DeviceOps.from_arrays(
        {k[4:]: v for k, v in d.items() if k.startswith("ops.")}, dev
    )

    def b(name):
        return torch.as_tensor(np.array(d[name], dtype=bool), device=dev)

    def i(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64), device=dev)

    can_close = bool(
        np.asarray(d["ac_match"]).any()
        or np.asarray(d["ac_tok"]).any()
        or np.asarray(d["inert"]).any()
        or np.asarray(d["filter_succ"]).any()
    )
    return SearchTables(
        ops=ops,
        is_indef=b("is_indef"),
        ac_match=b("ac_match"),
        ac_tok=b("ac_tok"),
        accept_tab=b("accept_tab"),
        opens_tab=i(d["opens_tab"]),
        zob1=i(d["zob1"]),
        zob2=i(d["zob2"]),
        pack=i(join_u64(d["pack_hi"], d["pack_lo"])),
        app_rank=i(d["app_rank"]),
        minrank_tab=i(d["minrank_tab"]),
        pintail_tab=i(d["pintail_tab"]),
        inert=b("inert"),
        filter_succ=b("filter_succ"),
        can_close=can_close,
        tok_close=bool(np.asarray(d["ac_tok"]).any()),
    )


def build_tables(enc: EncodedHistory, device, prune: bool = False) -> SearchTables:
    return tables_from_arrays(_table_arrays(enc, prune), device)


def frontier_from_arrays(d: dict, device) -> Frontier:
    """A frontier from numpy arrays named as the JAX engine's ``Frontier``
    fields (``counts``, ``tail``, ``hi``, ``lo``, ``tok``, ``valid``)."""
    dev = torch.device(device)

    def i(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64), device=dev)

    return Frontier(
        counts=i(d["counts"]),
        tail=i(d["tail"]),
        hash=i(join_u64(d["hi"], d["lo"])),
        tok=i(d["tok"]),
        valid=torch.as_tensor(np.array(d["valid"], dtype=bool), device=dev),
    )


def init_frontier(enc: EncodedHistory, capacity: int, device) -> Frontier:
    """One row per initial state."""
    c = enc.num_chains
    states = sorted(intern_state(enc, s) for s in enc.init_states)
    if len(states) > capacity:
        raise ValueError(
            f"{len(states)} initial states exceed frontier capacity {capacity}"
        )
    counts = np.zeros((capacity, c), np.int32)
    counts[:] = enc.chain_start[None, :]
    tail = np.zeros(capacity, np.uint32)
    hi = np.zeros(capacity, np.uint32)
    lo = np.zeros(capacity, np.uint32)
    tok = np.zeros(capacity, np.int32)
    valid = np.zeros(capacity, bool)
    for r, (t, h, l, k) in enumerate(states):
        tail[r], hi[r], lo[r], tok[r] = t, h, l, k
        valid[r] = True
    return frontier_from_arrays(
        dict(counts=counts, tail=tail, hi=hi, lo=lo, tok=tok, valid=valid), device
    )


def place_frontier(frontier: Frontier, mesh) -> ShardedFrontier:
    """Shard the frontier axis evenly over ``mesh`` (the JAX engine's
    ``P("fr")``): shard ``s`` holds rows ``s·F/n ..`` on its device.  Under
    a process group every process passes the whole frontier and keeps its
    own shards.  The search tables are replicated by :func:`run_search`,
    once per distinct device."""
    n, f = mesh.size, frontier.capacity
    if f % n:
        raise ValueError(f"a {f}-row frontier does not shard evenly over {n} shards")
    fs = f // n
    return ShardedFrontier(
        tuple(
            Frontier(*(x[s * fs : (s + 1) * fs].to(d) for x in frontier))
            for s, d in enumerate(mesh.local_devices, mesh.first)
        ),
        mesh,
    )


def gather_frontier(fr: Frontier | ShardedFrontier) -> Frontier:
    """A placed frontier's shards as one :class:`Frontier` on the first
    shard's device (a :class:`Frontier` passes through): the host-side
    consumers the JAX engine's ``check_device`` materializes too — escalation, checkpoints,
    the spill's host matrix, the accept row, final states and refusals.
    The layer loop never calls it.  Raises ``NotImplementedError`` for a
    multi-process mesh, whose other shards this process does not hold."""
    if not isinstance(fr, ShardedFrontier):
        return fr
    if fr.mesh.world > 1:
        raise NotImplementedError(
            "gathering a frontier placed over a multi-process mesh: run run_search SPMD "
            "and read its scalars, as in the JAX package"
        )
    dev = fr.mesh.devices[0]
    return Frontier(*(torch.cat([x.to(dev) for x in xs]) for xs in zip(*fr.blocks)))


def _fetch_matrix(x: torch.Tensor) -> list[list[int]]:
    """Bring a small 2-D tensor to the host (one counted synchronisation)."""
    return _synced(torch.Tensor.tolist, x.to(torch.int64))


def _shard_occupancy(frontier: ShardedFrontier, mesh):
    """Per-shard live-row counts of a placed frontier, and the wall of
    their one fetch: the segment's cross-shard sync barrier, whose time is
    the collective/straggler cost the per-shard statistics report."""
    t0 = time.monotonic()
    per = _fetch_matrix(mesh.gather([b.valid.sum().reshape(1) for b in frontier.blocks]))
    return np.asarray([r[0] for r in per], dtype=np.int64), time.monotonic() - t0


def _note_shard_stats(stats: FrontierStats, mesh, live_per_shard, sync_s: float) -> None:
    """Fold one segment's per-shard occupancy into ``stats.shards`` (the
    JAX engine's entries, keyed by the shard's device string).

    A checkpoint resumed onto a *different* device set carries the old
    mesh's shard summary; the summary describes the current mesh, so a
    device-set mismatch starts it fresh.
    """
    devs = [str(d) for d in mesh.devices]
    if len(stats.shards) != len(devs) or any(e.get("device") != d for e, d in zip(stats.shards, devs)):
        stats.shards = [
            {
                "shard": i,
                "device": d,
                "peak_occupancy": 0,
                "occupancy_sum": 0,
                "segments": 0,
                "collective_wall_s": 0.0,
                "skew": 1.0,
            }
            for i, d in enumerate(devs)
        ]
    for e, n in zip(stats.shards, live_per_shard):
        e["peak_occupancy"] = max(e["peak_occupancy"], int(n))
        e["occupancy_sum"] += int(n)
        e["segments"] += 1
        e["collective_wall_s"] = round(e["collective_wall_s"] + sync_s, 6)
    mean_peak = sum(e["peak_occupancy"] for e in stats.shards) / len(devs)
    for e in stats.shards:
        e["skew"] = round(e["peak_occupancy"] / mean_peak, 4) if mean_peak else 1.0


# ---------------------------------------------------------------------------
# Per-row pieces, batched over the frontier axis
# ---------------------------------------------------------------------------


def _chains(counts: torch.Tensor, cbase=None) -> torch.Tensor:
    """Chain-table rows of the chains of rows ``[..., C]``: ``0..C-1``, or,
    in a lane-batched search (:func:`run_search_lanes`), offset by each
    row's lane base ``cbase [...]`` (its lane index times C)."""
    ar = torch.arange(counts.shape[-1], device=counts.device)
    return ar if cbase is None else cbase[..., None] + ar


def _next_and_cands(tables: SearchTables, counts: torch.Tensor, cbase=None):
    """Next-op index per chain and the candidate mask, for rows ``[..., C]``
    (``cbase``: each row's lane base, see :func:`_chains`)."""
    ops = tables.ops
    ar = _chains(counts, cbase)
    chain_len = ops.chain_len if cbase is None else ops.chain_len[ar]
    has_next = counts < chain_len
    idx = torch.minimum(counts, (chain_len - 1).clamp(min=0))
    nxt = torch.where(has_next, ops.chain_ops[ar, idx], 0)
    nret = torch.where(has_next, ops.ret[nxt], _INF_TIME)
    m = nret.min(-1, keepdim=True).values
    cand = has_next & (ops.call[nxt] < m)
    # Rank gate (checker/prune.py): successful appends linearize in
    # out_tail order in every accepting interleaving, so a ranked candidate
    # above the minimum remaining rank heads a branch that can never
    # accept.  A no-op under the neutral tables.
    minrank = tables.minrank_tab[ar, counts].min(-1, keepdim=True).values
    rank_nxt = tables.app_rank[nxt]
    cand = cand & ((rank_nxt == _RANK_INF) | (rank_nxt <= minrank))
    return nxt, cand


def _row_tail_pin(tables: SearchTables, counts: torch.Tensor, cbase=None) -> torch.Tensor:
    """Smallest statically-pinned tail among each row's remaining ops."""
    return tables.pintail_tab[_chains(counts, cbase), counts].min(-1).values


def _advance_now(tables: SearchTables, counts, fr: Frontier, cbase=None):
    nxt, cand = _next_and_cands(tables, counts, cbase)
    ops = tables.ops
    tail, tok, h = fr.tail[:, None], fr.tok[:, None], fr.hash[:, None]
    tok_dead = tables.ac_tok[nxt] & (tok != ops.batch_token[nxt])
    dead = (tables.ac_match[nxt] & (tail > ops.match_seq[nxt])) | tok_dead
    fpass = (
        tables.filter_succ[nxt]
        & (tail == ops.out_tail[nxt])
        & (~ops.out_has_hash[nxt] | (h == ops.out_hash[nxt]))
    )
    eager = cand & (tables.inert[nxt] | fpass) & ~dead
    return (cand & dead) | eager, eager, tok_dead


def _auto_close(tables: SearchTables, fr: Frontier, cbase=None):
    """Advance every row past candidate ops that are provably identity
    there (the JAX engine's vmapped ``_auto_close_row`` loop).

    Tails are monotone along every path, so a stale ``match_seq_num`` can
    never match again; a fencing token no remaining op sets can never come
    to match either.  A row keeps sweeping while it moves; the sweep
    repeats while any row moved (one synchronisation per sweep, counted in
    :data:`CLOSE_SWEEPS`).  Returns ``(closed_counts, n_closed [F],
    n_eager [F], n_tok [F])``, ``n_tok`` counting the ops the token arm
    passed, None unless ``tables.tok_close``; ``cbase`` as in
    :func:`_chains`.
    """
    counts = fr.counts
    zero = torch.zeros_like(fr.tail)
    if not tables.can_close:
        return counts, zero, zero, None
    n_eager = zero
    n_tok = zero if tables.tok_close else None
    while True:
        adv, eager, tok = _advance_now(tables, counts, fr, cbase)
        active = fr.valid & adv.any(-1)
        CLOSE_SWEEPS[0] += 1
        if not _fetch(active.any())[0]:
            break
        counts = counts + (adv & active[:, None]).long()
        n_eager = n_eager + (eager & active[:, None]).sum(-1)
        if n_tok is not None:
            # A moved op is the token arm's where its token is dead.
            n_tok = n_tok + (adv & tok & active[:, None]).sum(-1)
    return counts, (counts - fr.counts).sum(-1), n_eager, n_tok


def _accept_rows(tables: SearchTables, counts, valid, cbase=None) -> torch.Tensor:
    return valid & tables.accept_tab[_chains(counts, cbase), counts].all(-1)


def _fold_step(tables: SearchTables, op_idx, state: DeviceState, lens=None):
    """Chain-hash folds of ``state.hash`` over the record batches of ops
    ``op_idx`` (any broadcast shape), through the fold wrapper: ONE kernel
    launch on the card.  ``lens`` overrides the per-lane fold lengths.
    Inside a layer graph's capture (:func:`_capture_graph`) it calls
    :func:`..ops.fold_cuda.fold_lanes` itself, not this module's name for
    it, which a caller may have wrapped with host work that a capture
    cannot hold."""
    ops = tables.ops
    shape = torch.broadcast_shapes(op_idx.shape, state.hash.shape)
    seed = state.hash.expand(shape).reshape(-1)
    row = ops.rh_row[op_idx].expand(shape).reshape(-1)
    length = (ops.rh_len[op_idx] if lens is None else lens).expand(shape).reshape(-1)
    capturing = seed.is_cuda and torch.cuda.is_current_stream_capturing()
    return (fold_cuda.fold_lanes if capturing else fold_lanes)(seed, row, length, ops.rh).reshape(shape)


def _fast_multi(tables: SearchTables, fr: Frontier, rows: torch.Tensor, run: torch.Tensor, budget: list[int],
                cbase=None, extra=()):
    """Runs of forced steps on the lone live rows ``rows [k]``, inside one
    layer: a row keeps stepping while it stays alive, its candidate window
    stays single-chain, the next op is not an indefinite append and its
    layer budget ``budget[i]`` lasts.  The rows where the device mask
    ``run`` is set step together, one fold call and one synchronisation
    per op for all of them (the JAX engine runs this loop on device); a
    row that stops stays as it stopped while the others step on.  In a
    lane-batched search (:func:`run_search_lanes`) there is one row per
    lane, ``cbase [k]`` their lanes' bases as in :func:`_chains`.  The
    device vectors ``extra`` come over with the first step's fetch.

    Returns the rows' ``(counts, tail, hash, tok)`` (device), the host
    lists ``(alive, steps, deep_ops)`` (meaningful for the rows that
    stepped) and ``extra`` as host lists.  A row that dies mid-stretch
    keeps its death-point configuration (pre-attempt counts and state) so
    the refusal diagnostics can name the culprit; ``deep_ops`` is the sum
    of its counts.
    """
    ops = tables.ops
    k, c = rows.shape[0], fr.counts.shape[1]
    dev = fr.counts.device
    ar = torch.arange(c, device=dev)

    def nxt_op(counts):
        nxt, cand = _next_and_cands(tables, counts, cbase)
        chain = _first_true(cand)
        return nxt.gather(1, chain[:, None])[:, 0], chain, cand.sum(1) == 1

    counts, tail, h, tok = fr.counts[rows], fr.tail[rows], fr.hash[rows], fr.tok[rows]
    o, chain, _single = nxt_op(counts)
    alive = run
    steps = torch.zeros(k, dtype=torch.int64, device=dev)
    extra_h = []
    while True:
        st = DeviceState(tail, h, tok)
        sa, va, _sb, _vb = step_kernel(ops, o, st, _fold_step(tables, o, st))
        upd = va & run
        counts = torch.where(upd[:, None], counts + (ar == chain[:, None]).long(), counts)
        tail = torch.where(upd, sa.tail, tail)
        h = torch.where(upd, sa.hash, h)
        tok = torch.where(upd, sa.token, tok)
        alive = torch.where(run, va, alive)
        steps = steps + run.long()
        o, chain, single = nxt_op(counts)
        run = upd & single & ~tables.is_indef[o]
        more, alive_h, steps_h, ops_h, *got = _fetch_lanes(run, alive, steps, counts.sum(1), *extra)
        extra_h, extra = extra_h or got, ()
        going = False
        for i in range(k):
            if more[i] and steps_h[i] >= budget[i]:
                run[i] = False  # its layer budget is spent (a fill, no upload)
            elif more[i]:
                going = True
        if not going:
            return (counts, tail, h, tok), (alive_h, steps_h, ops_h), extra_h


# ---------------------------------------------------------------------------
# The batched layer
# ---------------------------------------------------------------------------


def _mix_hash(cols, seed: int) -> torch.Tensor:
    """FNV-1a-style column mix → one u32 lane hash per row (u32 arithmetic
    carried in int64 and masked after every step, bit-exact with the JAX
    engine's uint32 version)."""
    h = torch.full_like(cols[0], seed)
    for x in cols:
        h = ((h ^ (x & _M32)) * 0x01000193) & _M32
        h = (((h << 13) | (h >> 19)) ^ (h >> 7)) & _M32
    # final avalanche
    h = ((h ^ (h >> 16)) * 0x7FEB352D) & _M32
    h = ((h ^ (h >> 15)) * 0x846CA68B) & _M32
    return h ^ (h >> 16)


def _zob_fold(zob: torch.Tensor, counts: torch.Tensor, cbase=None) -> torch.Tensor:
    """XOR-fold a Zobrist table over a counts matrix: [F, C] → [F]."""
    contrib = zob[_chains(counts, cbase), counts]
    out = contrib[:, 0].clone()
    for ci in range(1, counts.shape[1]):
        out ^= contrib[:, ci]
    return out


_SIGN = -(1 << 63)


def _dedup_sort(invalid: torch.Tensor, ident, values=()):
    """Total-order sort + adjacent-equality head mask over a row identity
    ``(pk, tail, hash, tok)`` (the JAX engine's ``_dedup_sort``): the one
    dedup routine of the in-core sort path and both passes of the chunked
    tier.

    Rows sort lexicographically by (invalid, pk, tail, hash, tok, row
    index), ``pk`` and ``hash`` as unsigned 64-bit words (their sign bit
    flipped for the signed int64 compare) — the order of the JAX engine's
    six u32/i32 words.  ``torch.sort`` takes one key, so this is stable LSD
    passes, least significant key first, starting from index order: the
    row-index tiebreak needs no key of its own, and the first row of every
    equal run has the smallest index.  Returns ``(head, sorted_ident,
    sorted_idx, sorted_values)``; ``head`` marks, in sorted space, the
    first row of each valid identity run.
    """
    pk, tail, h, tok = ident
    perm = torch.arange(invalid.shape[0], device=invalid.device)
    for key in (tok, h ^ _SIGN, tail, pk ^ _SIGN, invalid.to(torch.uint8)):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    sid = tuple(x[perm] for x in ident)
    same_prev = torch.ones_like(invalid)
    same_prev[0] = False
    for w in sid:
        same_prev[1:] &= w[1:] == w[:-1]
    head = ~invalid[perm] & ~same_prev
    return head, sid, perm, tuple(v[perm] for v in values)


def _expand_slice(tables: SearchTables, fr: Frontier, cbase=None, nl: int = 1):
    """Candidate sweep, fold, step, and the flattened per-child arrays.

    Returns ``(t2, h2, k2, valid2, op2, parent2, chain2, cand)`` where the
    ``*2`` arrays have 2*F*C lanes (slot A then slot B).  The fold runs
    only for candidate lanes (others get length 0): their children are
    invalid, so their folded hashes are never read.

    A frontier of ``nl`` lanes (blocks of F/nl rows, ``cbase`` as in
    :func:`_chains`) lays its children out lane by lane, each lane's
    block of 2*F*C/nl lanes in the one-lane order (slot A then slot B);
    ``parent2`` is the global row.
    """
    f, c = fr.counts.shape
    e = f * c
    el = e // nl
    dev = fr.counts.device
    ops = tables.ops
    nxt, cand = _next_and_cands(tables, fr.counts, cbase)
    cand = cand & fr.valid[:, None]
    st = DeviceState(fr.tail[:, None], fr.hash[:, None], fr.tok[:, None])
    folded = _fold_step(tables, nxt, st, lens=torch.where(cand, ops.rh_len[nxt], 0))
    sa, va, _sb, vb = step_kernel(ops, nxt, st, folded)
    # slot A: the op's effect outcome; slot B: the no-effect fork (parent
    # state), live only for indefinite append failures.
    va = va & cand
    vb = vb & cand

    idx2 = torch.arange(2 * e, device=dev)
    within = idx2 % el
    parent2 = within // c
    chain2 = within % c
    if nl > 1:
        parent2 = parent2 + (idx2 // (2 * el)) * (f // nl)
    rep = lambda x: x[:, None].expand(f, c)  # noqa: E731

    def ab(a, b):
        return torch.cat([a.reshape(nl, el), b.reshape(nl, el)], 1).reshape(-1)

    t2 = ab(sa.tail, rep(fr.tail))
    h2 = ab(sa.hash, rep(fr.hash))
    k2 = ab(sa.token, rep(fr.tok))
    valid2 = ab(va, vb)
    op2 = ab(nxt, nxt)
    return t2, h2, k2, valid2, op2, parent2, chain2, cand


def _child_counts(fr: Frontier, parent2, chain2) -> torch.Tensor:
    """The children's counts rows: the parent's, plus one on the chain
    linearized."""
    ar = torch.arange(fr.counts.shape[1], device=fr.counts.device)
    return fr.counts[parent2] + (chain2[:, None] == ar).long()


def _child_hashes(tables: SearchTables, fr: Frontier, t2, h2, k2, parent2, chain2, pk2, cbase=None):
    """The two u32 lane hashes of each child's identity, over the packed
    key ``pk2``, or the Zobrist counts hash (updated incrementally from the
    parent's) when it is None; ``cbase`` as in :func:`_chains`."""
    hi2, lo2 = shr(h2, 32), h2 & _M32
    if pk2 is not None:
        pkh2, pkl2 = shr(pk2, 32), pk2 & _M32
        return (
            _mix_hash([pkh2, pkl2, t2, hi2, lo2, k2], 0x811C9DC5),
            _mix_hash([pkl2, pkh2, t2, hi2, lo2, k2], 0x9747B28C),
        )
    pz1 = _zob_fold(tables.zob1, fr.counts, cbase)
    pz2 = _zob_fold(tables.zob2, fr.counts, cbase)
    cnt_pc = fr.counts[parent2, chain2]
    zc2 = chain2 if cbase is None else cbase[parent2] + chain2
    cz1 = pz1[parent2] ^ tables.zob1[zc2, cnt_pc] ^ tables.zob1[zc2, cnt_pc + 1]
    cz2 = pz2[parent2] ^ tables.zob2[zc2, cnt_pc] ^ tables.zob2[zc2, cnt_pc + 1]
    return _mix_hash([cz1, t2, hi2, lo2, k2], 0x811C9DC5), _mix_hash([cz2, t2, hi2, lo2, k2], 0x9747B28C)


def _probe_table_size(e2: int) -> int:
    """Slots of the probe table over ``e2`` children."""
    return 1 << max(1, (e2 - 1).bit_length())


def _probe_dedup(tables: SearchTables, fr: Frontier, t2, h2, k2, valid2, parent2, chain2, pk2,
                 cbase=None, nl: int = 1):
    """Scatter-min hash-table dedup of a layer's children.  Equal children
    share both lane hashes (over the packed key ``pk2``, or the Zobrist
    counts hash when it is None), so all copies land in one slot; the
    smallest row index wins, copies that exact-compare equal to the winner
    drop, unequal collisions re-probe.  Rows still colliding after the
    probe rounds are kept — a missed merge wastes a row but never changes a
    verdict.  Returns the ``keep`` mask.

    Children of ``nl`` lanes (:func:`_expand_slice`'s layout) probe one
    table of ``nl`` segments, each of the one-lane table's size: a lane's
    winners and surviving collisions are those of the lane alone."""
    exact_pack = pk2 is not None
    e2 = valid2.shape[0]
    dev = valid2.device
    hh1, hh2 = _child_hashes(tables, fr, t2, h2, k2, parent2, chain2, pk2, cbase)
    tsz = _probe_table_size(e2 // nl)
    idx = torch.arange(e2, device=dev)
    keep_u = torch.zeros(e2, dtype=torch.bool, device=dev)
    surv = valid2
    seg = idx // (e2 // nl) * tsz if nl > 1 else None
    if not exact_pack:
        cc_i = _child_counts(fr, parent2, chain2)
    for r in range(3):
        slot = (hh1 + r * (hh2 | 1)) & (tsz - 1)
        if nl > 1:
            slot = slot + seg
        tbl = torch.full((nl * tsz,), e2, dtype=torch.int64, device=dev)
        tbl.scatter_reduce_(0, slot, torch.where(surv, idx, e2), "amin", include_self=True)
        win = tbl[slot]
        w = win.clamp(max=e2 - 1)
        is_win = surv & (win == idx)
        # Exact child-counts equality (full equality: the adversarial
        # family's merges are exactly the cross-chain reorderings).
        if exact_pack:
            cnt_eq = pk2 == pk2[w]
        else:
            cnt_eq = (cc_i == cc_i[w]).all(1)
        eq = (t2 == t2[w]) & (h2 == h2[w]) & (k2 == k2[w]) & cnt_eq
        dup = surv & ~is_win & eq
        keep_u = keep_u | is_win
        surv = surv & ~is_win & ~dup
    return keep_u | surv


def _child_opens(tables: SearchTables, fr: Frontier, parent2, op2, cbase=None) -> torch.Tensor:
    """Each child's lazy-order rank, the beam priority class: indefinite
    appends linearized in all (fewest first), clamped to the class range."""
    lc1 = tables.opens_tab.shape[1] - 1
    p_opens = tables.opens_tab[_chains(fr.counts, cbase), fr.counts.clamp(max=lc1)].sum(1)
    return (p_opens[parent2] + tables.is_indef[op2].long()).clamp(max=_OPENS_CAP - 1)


def _expand_layer(
    tables: SearchTables,
    fr: Frontier,
    *,
    allow_prune: bool,
    exact_pack: bool = False,
    sort_dedup: bool = False,
    log: bool = False,
    cbase=None,
    nl: int = 1,
):
    """Expand + dedup + compact one layer.  Returns ``(children, pruned,
    n_unique, expanded, wlog)`` with the middle three as device vectors,
    one entry per lane.

    ``sort_dedup`` (with ``exact_pack``) dedups by :func:`_dedup_sort`, a
    perfect dedup, in place of the probe table.  With ``log``, ``wlog`` is
    the layer's witness log ``(parent, opbr)``: each child row's parent row
    and ``op*2 + branch`` (valid on the children's live prefix); else
    None.

    A frontier of ``nl`` lanes (:func:`run_search_lanes`: blocks of F/nl
    rows, ``cbase`` as in :func:`_chains`) expands in one piece, one fold
    call for every lane (:func:`_expand_slice`) and one probe table of
    per-lane segments (:func:`_probe_dedup`); each lane selects its beam
    and compacts its children into its own F/nl rows, as it would alone.
    """
    f_all, c = fr.counts.shape
    f = f_all // nl
    e2 = 2 * f_all * c
    dev = fr.counts.device
    ar = torch.arange(c, device=dev)
    t2, h2, k2, valid2, op2, parent2, chain2, cand = _expand_slice(tables, fr, cbase, nl)
    # Exact mixed-radix counts key (when it packs): parent keys from an
    # [F, C] product and sum (mod 2^64), child keys incrementally (+ the
    # stride of the linearized chain); the dedup compare is then one word
    # per row.
    pk2 = (fr.counts * tables.pack).sum(1)[parent2] + tables.pack[chain2] if exact_pack else None
    if exact_pack and sort_dedup:
        # Sort dedup: with the packed key the child identity is four words,
        # so one lexicographic sort puts every duplicate beside its twin;
        # the run heads (smallest row index first) are written back in
        # lane order.
        head, _sid, sidx, _sv = _dedup_sort(~valid2, (pk2, t2, h2, k2))
        keep = torch.zeros(e2, dtype=torch.bool, device=dev).index_copy_(0, sidx, head)
    else:
        keep = _probe_dedup(tables, fr, t2, h2, k2, valid2, parent2, chain2, pk2, cbase, nl)
    # Per-lane views [nl, 2*F*C/nl] from here on.
    keep = keep.view(nl, -1)
    n_unique = keep.sum(1)

    opens2 = _child_opens(tables, fr, parent2, op2, cbase).view(nl, -1)

    if allow_prune:
        # Sort-free beam selection: bincount the priority classes, find the
        # threshold class, keep lower classes whole and the threshold class
        # partially (first-come within the layer, deterministic).
        cnt = torch.zeros(nl, _OPENS_CAP, dtype=torch.int64, device=dev)
        cnt.scatter_add_(1, opens2, keep.long())
        cum = cnt.cumsum(1)
        over = cum > f
        pruned = over.any(1)
        vstar = _first_true(over)[:, None]
        below_ct = torch.where(vstar > 0, cum.gather(1, (vstar - 1).clamp(min=0)), 0)
        in_class = keep & (opens2 == vstar)
        within = in_class.long().cumsum(1)
        sel = in_class & (within <= f - below_ct)
        final_keep = torch.where(pruned[:, None], keep & ((opens2 < vstar) | sel), keep)
    else:
        final_keep = keep
        pruned = n_unique > f

    # Compaction: each lane's first f kept children, in lane order, to its
    # slots 0..; every other lane writes the spare slot f, which is cut off.
    pos = final_keep.long().cumsum(1) - 1
    take = final_keep & (pos < f)
    dst = torch.where(take, pos, f)

    def place(vals, dtype=torch.int64):
        out = torch.zeros(nl, f + 1, dtype=dtype, device=dev)
        return out.scatter_(1, dst, vals.view(nl, -1))[:, :f].reshape(-1)

    valid_next = place(take, torch.bool)
    parent_next = place(parent2)
    chain_next = place(chain2)
    counts_next = torch.where(
        valid_next[:, None],
        fr.counts[parent_next] + (chain_next[:, None] == ar).long(),
        0,
    )
    children = Frontier(
        counts=counts_next,
        tail=place(t2),
        hash=place(h2),
        tok=place(k2),
        valid=valid_next,
    )
    wlog = (parent_next, place(op2 * 2 + (torch.arange(e2, device=dev) >= e2 // 2).long())) if log else None
    return children, pruned, n_unique, cand.view(nl, -1).sum(1), wlog


def _compact_children(cb: list[torch.Tensor], cursor: int):
    """Cross-chunk dedup of the chunked layer's children buffer: its first
    ``cursor`` rows sorted by :func:`_dedup_sort`, the run heads re-packed
    densely in sorted order, the rest zeroed.  Returns ``(buffer, rows)``,
    ``rows`` a device scalar."""
    f = cb[0].shape[0] - 1
    dev = cb[0].device
    head, sid, _sidx, svals = _dedup_sort(
        torch.arange(f, device=dev) >= cursor, [x[:f] for x in cb[:4]], [x[:f] for x in cb[4:]]
    )
    dst = torch.where(head, head.cumsum(0) - 1, f)
    new = [torch.zeros(f + 1, dtype=torch.int64, device=dev).index_copy_(0, dst, v) for v in (*sid, *svals)]
    return new, head.sum()


def _expand_layer_chunked(tables: SearchTables, fr: Frontier, *, chunk_rows: int):
    """One exhaustive layer over a frontier too wide to expand in one piece
    (the JAX engine's ``_expand_layer_chunked``): the frontier stays on the
    device at full width F while the expansion's working set, 2 ×
    ``chunk_rows`` × C child lanes, is bounded by the chunk.

    Needs the exact packed counts key.  Each chunk expands through
    :func:`_expand_slice`, dedups its children with :func:`_dedup_sort` and
    appends the unique ones behind a write cursor, in sorted order, with
    each row's global parent and ``op*2 + branch``.  When an append would
    not fit, the buffer is first deduped across the chunks so far
    (:func:`_compact_children`); an append that still does not fit drops
    rows and reports overflow, the pre-expansion frontier intact.  The fit
    test is conservative: a chunk's rows are not merged against the buffer
    before it, so a chunk of mostly buffered duplicates can report overflow
    though the union fits — an early escalation, never a verdict change.
    A final cross-chunk dedup compacts the buffer in sorted identity order.

    One host fetch per chunk (its unique count, which steers the append),
    one for the chunks holding a valid row (the others are skipped: they
    would append nothing), and one per compaction.  Returns ``(children,
    overflow, n_unique, expanded, wlog)``; ``overflow`` is a host bool, and
    on overflow ``n_unique`` is at least the rows appended, so the jump of
    :func:`check_device` to a fitting bucket keeps working; ``wlog`` is the
    layer's witness log ``(parent, opbr)`` as in :func:`_expand_layer`.
    """
    f, c = fr.counts.shape
    if chunk_rows <= 0 or chunk_rows >= f or f % chunk_rows:
        raise ValueError(f"chunk_rows={chunk_rows} must divide the frontier's {f} rows")
    n_chunks = f // chunk_rows
    ce = chunk_rows * c  # slot-A lanes of a chunk; slot B doubles them
    dev = fr.counts.device
    ar = torch.arange(c, device=dev)
    # Children buffer (pk, tail, hash, tok, global parent, op*2+branch),
    # dense behind the cursor; slot f takes the rows that are not written.
    cb = [torch.zeros(f + 1, dtype=torch.int64, device=dev) for _ in range(6)]
    pk_all = (fr.counts * tables.pack).sum(1)
    live = _synced(torch.Tensor.tolist, fr.valid.view(n_chunks, chunk_rows).any(1))
    cursor = appended = 0
    overflow = False
    expanded = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n_chunks):
        if not live[i]:
            continue
        rows = slice(i * chunk_rows, (i + 1) * chunk_rows)
        t2, h2, k2, valid2, op2, parent2, chain2, cand = _expand_slice(
            tables, Frontier(*(x[rows] for x in fr))
        )
        pk2 = pk_all[rows][parent2] + tables.pack[chain2]
        head, sid, sidx, _sv = _dedup_sort(~valid2, (pk2, t2, h2, k2))
        (u,) = _fetch(head.sum())
        if cursor + u > f:
            cb, rows_left = _compact_children(cb, cursor)
            (cursor,) = _fetch(rows_left)
        pos = cursor + head.cumsum(0) - 1
        dst = torch.where(head & (pos < f), pos, f)
        gparent = i * chunk_rows + (sidx % ce) // c
        gop = op2[sidx] * 2 + (sidx >= ce).long()
        for a, v in zip(cb, (*sid, gparent, gop)):
            a.index_copy_(0, dst, v)
        overflow = overflow or cursor + u > f
        cursor = min(cursor + u, f)
        appended += u
        expanded += cand.sum()
        # Free this chunk's lanes before the next chunk allocates its own.
        del t2, h2, k2, valid2, op2, parent2, chain2, cand, pk2, head, sid, sidx, pos, dst, gparent, gop

    # The final cross-chunk dedup leaves the children dense, in sorted
    # identity order.
    (_pk, tail, h, tok, parent, opbr), n_unique = _compact_children(cb, cursor)
    valid_next = torch.arange(f, device=dev) < n_unique
    chain_next = tables.ops.chain_of[opbr[:f] // 2]
    counts_next = torch.where(
        valid_next[:, None],
        fr.counts[parent[:f]] + (chain_next[:, None] == ar).long(),
        0,
    )
    children = Frontier(counts=counts_next, tail=tail[:f], hash=h[:f], tok=tok[:f], valid=valid_next)
    if overflow:
        n_unique = n_unique.clamp(min=appended)
    return children, overflow, n_unique, expanded, (parent[:f], opbr[:f])


# ---------------------------------------------------------------------------
# The search loop
# ---------------------------------------------------------------------------


def _close_and_pin(tables: SearchTables, fr: Frontier) -> Frontier:
    """Auto-close every row, then drop the rows the tail pins kill."""
    counts = _auto_close(tables, fr)[0]
    return fr._replace(counts=counts, valid=fr.valid & ~(fr.tail > _row_tail_pin(tables, counts)))


def _dive_keys(tables: SearchTables, entry: Frontier) -> torch.Tensor:
    """The dive's row order key over a closed, pinned frontier: the lazy
    beam priority, fewest linearized indefinite appends first, dead rows
    last."""
    ar = torch.arange(entry.counts.shape[1], device=entry.counts.device)
    opens = tables.opens_tab[ar, entry.counts].sum(1)
    return torch.where(entry.valid, opens.clamp(max=_OPENS_CAP), 2 * _OPENS_CAP)


def _dive(tables: SearchTables, beam: Frontier, depth: int, exact_pack: bool, sort_dedup: bool):
    """Expand the dive rows ``beam`` up to ``depth`` layers, checking for an
    accept after each; returns as :func:`_spec_dive` does."""
    acc = _accept_rows(tables, beam.counts, beam.valid)
    entry_acc, alive, idx = _fetch(acc.any(), beam.valid.any(), _first_true(acc))
    done, k, ops = entry_acc, 0, 0
    while not done and k < depth and alive:
        children = _expand_layer(
            tables, beam, allow_prune=True, exact_pack=exact_pack, sort_dedup=sort_dedup
        )[0]
        beam = _close_and_pin(tables, children)
        k += 1
        acc = _accept_rows(tables, beam.counts, beam.valid)
        i = _first_true(acc)
        done, alive, idx, ops = _fetch(acc.any(), beam.valid.any(), i, beam.counts[i].sum())
    return bool(done and not entry_acc), k, beam, idx, ops


def _spec_dive(
    tables: SearchTables, fr: Frontier, depth: int, width: int, exact_pack: bool, sort_dedup: bool
):
    """One speculative beam dive (the JAX engine's ``_spec_dive``).

    Copies the ``width`` best rows off the closed, pinned entry frontier —
    ordered by :func:`_dive_keys`, by a stable sort — and expands them up
    to ``depth`` layers, checking for an accept after each.  Every dive row
    is a real reachable configuration (each layer step-validates its
    states), so an accepting row is conclusive.  An entry frontier that
    already accepts is the exact loop's business: the dive stands down.

    Returns ``(found, k, beam, idx, ops)``: whether the dive found an
    accept (its row ``idx`` of ``beam``, which has ``ops`` ops committed),
    and the dive layers it ran.
    """
    entry = _close_and_pin(tables, fr)
    order = torch.argsort(_dive_keys(tables, entry), stable=True)[:width]
    return _dive(tables, Frontier(*(x[order] for x in entry)), depth, exact_pack, sort_dedup)


# ---------------------------------------------------------------------------
# The layer expansion replayed from a CUDA graph
# ---------------------------------------------------------------------------


def _graph_engages(device: torch.device, rows: int, *, chunked: bool, eager: int) -> bool:
    """Whether the expansion of a ``rows``-row frontier on ``device`` is
    replayed from a CUDA graph, after ``eager`` eager expansions in this
    :func:`run_search` call: on CUDA, for an unchunked frontier of at most
    :data:`_GRAPH_MAX_ROWS` rows, once :data:`_GRAPH_AFTER` eager
    expansions have run."""
    return device.type == "cuda" and not chunked and rows <= _GRAPH_MAX_ROWS and eager >= _GRAPH_AFTER


_CAPTURE_LOCK = threading.Lock()


def _capture_graph(body, device: torch.device):
    """Capture ``body()`` (fixed shapes, no synchronisation) on ``device``
    into a CUDA graph.  Returns ``(outputs, replay)``: the tensors the
    capture returned, which every replay writes anew, and a callable that
    replays the graph on the current stream and then hands each fold the
    graph holds to :func:`..ops.fold_cuda.replayed` (the captured calls
    launched nothing; their arguments, kept with the graph, hold each
    replay's inputs).

    As PyTorch's recipe has it, ``body`` first runs once on the capture
    stream.  That also makes the fold wrapper's scratch of the stream
    (:mod:`..ops.fold_cuda`) outside the capture, which the graph then
    keeps as its own, so that no later launch on the stream grows or
    shares what a replay reads.  The capture itself calls
    ``capture_begin``/``capture_end``, not ``torch.cuda.graph``, whose
    entry synchronises the device and empties the allocator's cache.  One
    capture at a time in the process; other threads' CUDA calls meanwhile
    are theirs (``thread_local``)."""
    with _CAPTURE_LOCK, torch.cuda.device(device):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            body()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = body()
            finally:
                graph.capture_end()
                folds = fold_cuda.take_captured()
        torch.cuda.current_stream().wait_stream(stream)
        held = graph, fold_cuda.take_scratch(stream.cuda_stream)

    def replay():
        held[0].replay()
        for args in folds:
            fold_cuda.replayed(*args)

    return outputs, replay


class _LayerGraph:
    """The layer expansions of one :func:`run_search` call: eager, or
    replayed from a CUDA graph once :func:`_graph_engages` says so.  One
    call keeps its bucket, chains and flags, so it needs one graph, which
    is dropped with the call, before the tables it reads.

    The graph reads the closed frontier from static input buffers, which
    :meth:`expand` copies it into, and writes the children, the four
    scalars of the layer's fetch and, with ``log``, the witness log into
    output buffers that the next replay overwrites.  So the next layer's
    frontier views those buffers, and a stop that keeps the pre-expansion
    frontier keeps the static inputs, which a replay reads and never
    writes."""

    def __init__(self, tables: SearchTables, **flags):
        self.tables = tables
        self.flags = flags
        self.eager_runs = 0
        #: (static inputs, outputs, replay) once captured
        self.graph = None

    def _body(self, fr: Frontier) -> tuple:
        children, pruned, n_unique, expanded, wlog = _expand_layer(self.tables, fr, **self.flags)
        return (*children, pruned, n_unique, expanded, children.valid.sum(), *(wlog or ()))

    @staticmethod
    def _split(out: tuple):
        """``(children, head, wlog)``: ``head`` the device scalars (pruned,
        unique children, candidates expanded, live children)."""
        return Frontier(*out[:5]), out[5:9], out[9:] or None

    def ready(self, fr: Frontier, chunked: bool) -> bool:
        """Whether :meth:`expand` replays ``fr``'s expansion, capturing the
        graph when it comes due."""
        if self.graph is None:
            dev = fr.valid.device
            if not _graph_engages(dev, fr.capacity, chunked=chunked, eager=self.eager_runs):
                return False
            static = Frontier(*(x.clone() for x in fr))
            self.graph = (static, *_capture_graph(lambda: self._body(static), dev))
            GRAPH_CAPTURES[0] += 1
        return True

    def expand(self, fr: Frontier):
        """Expand ``fr`` one layer, by the graph once captured, else
        eagerly: ``(kept, children, head, wlog)``, ``kept`` the frontier a
        stop keeps (``fr``, or the static inputs holding it)."""
        if self.graph is None:
            self.eager_runs += 1
            return (fr, *self._split(self._body(fr)))
        static, outputs, replay = self.graph
        for x, y in zip(static, fr):
            x.copy_(y)
        replay()
        GRAPH_REPLAYS[0] += 1
        return (static, *self._split(outputs))


def run_search(
    tables: SearchTables,
    frontier: Frontier,
    max_layers: int,
    *,
    allow_prune: bool,
    exact_pack: bool = False,
    spec_depth: int = 0,
    spec_width: int = 0,
    sort_dedup: bool = False,
    chunk_rows: int = 0,
    log: bool = False,
) -> RunOut:
    """Run the frontier search for at most ``max_layers`` layers or to a
    stop (the JAX engine's compiled ``run_search``, as a host loop).

    ``allow_prune=True``: capacity overruns prune to the lazy-best rows and
    the search continues (OK conclusive; dead ends inconclusive).
    ``allow_prune=False``: the loop stops with STOP_CAPACITY and the
    pre-expansion frontier, so the caller can escalate and resume exactly.
    ``exact_pack=True`` (valid only when :func:`can_exact_pack` holds)
    dedups on the exact u64 packed counts key; ``sort_dedup=True`` (with
    ``exact_pack``) dedups by a lexicographic sort of the whole child
    identity in place of the probe table.  ``chunk_rows`` below the
    frontier's rows (exhaustive, packed key) expands each layer in
    ``chunk_rows``-row chunks (:func:`_expand_layer_chunked`); the fast
    path, the accept test and the dive are unchanged.

    ``spec_depth > 0`` runs one speculative dive (:func:`_spec_dive`) of
    ``min(spec_width, F)`` rows before the first layer, as the JAX engine
    does once per compiled launch.  A dive accept is conclusive and
    returns at once: row 0 holds the accepting configuration, the only
    valid row, and ``layers`` counts the dive's depth.  A dive that finds
    nothing is discarded wholesale (``spec_rollbacks``) and the exact loop
    runs from the untouched entry frontier.

    ``log=True`` keeps the witness log: a forced stretch stops after one
    op, so that each committed layer but an accept records its children's
    parent rows and ``op*2 + branch``, returned on ``RunOut.wlog`` as host
    arrays.  The expansion layers' log stays on the device, a copy of each
    one's live prefix, until one transfer at the end of the call; a forced
    step's one entry is known on the host.  Incompatible with the dive, as
    in the JAX engine.
    """
    if spec_depth and log:
        raise ValueError("speculation drops the witness log: pass spec_depth=0 with log=True")
    if isinstance(frontier, ShardedFrontier):
        if chunk_rows and chunk_rows < frontier.capacity:
            raise ValueError("chunk_rows: the chunked tier does not run over a mesh, whose shards hold the rows")
        return _run_search_sharded(
            tables, frontier, max_layers, allow_prune=allow_prune, exact_pack=exact_pack, spec_depth=spec_depth,
            spec_width=spec_width, sort_dedup=sort_dedup, log=log,
        )
    #: per committed layer: a device pair (parents, opbrs) of its live
    #: prefix, or a host triple for a forced step or an empty layer
    wlog: list = []
    graphs = _LayerGraph(tables, allow_prune=allow_prune, exact_pack=exact_pack, sort_dedup=sort_dedup, log=log)
    fr = frontier
    stop = STOP_RUNNING
    layers = accept_idx = auto_closed = expanded = eager_closed = pin_killed = want = 0
    spec_layers = spec_accepts = spec_rollbacks = 0
    pruned_ever = False
    max_live, deep_ops = _fetch(fr.valid.sum(), fr.counts[0].sum())
    live = max_live
    deep_counts = fr.counts[0]
    if spec_depth > 0 and spec_width > 0:
        found, spec_layers, beam, idx, dive_ops = _spec_dive(
            tables, fr, spec_depth, min(spec_width, fr.capacity), exact_pack, sort_dedup
        )
        if found:
            # The JAX engine's accept carry: the entry frontier with row 0
            # replaced by the accepting row, the only valid one.
            acc = Frontier(*(x.clone() for x in fr))
            for x, y in zip(acc, beam):
                x[0] = y[idx]
            acc.valid.zero_()
            acc.valid[0] = True
            fr, stop, layers, live, spec_accepts = acc, STOP_ACCEPT, spec_layers, 1, 1
            deep_counts, deep_ops = beam.counts[idx], dive_ops
        elif spec_layers > 0:
            spec_rollbacks = 1
    while stop == STOP_RUNNING and layers < max_layers:
        closed_counts, ac_n, eager_n, tok_n = _auto_close(tables, fr)
        closed = fr._replace(counts=closed_counts)
        # Tail-pin dead rows (checker/prune.py): a row whose tail has passed
        # the smallest statically-pinned tail among its remaining ops can
        # never linearize that op.  A no-op under the neutral tables.
        pin_dead = closed.valid & (closed.tail > _row_tail_pin(tables, closed.counts))
        closed = closed._replace(valid=closed.valid & ~pin_dead)
        acc_row = _accept_rows(tables, closed.counts, closed.valid)
        # Fast path: a lone live row with a single-chain candidate window
        # and a single-successor op — the forced-step regime.
        live_idx = _first_true(closed.valid)
        base_row = closed.counts[live_idx]
        nxt1, cand1 = _next_and_cands(tables, base_row)
        chain1 = _first_true(cand1)
        op1 = nxt1[chain1]
        n_live = closed.valid.sum()
        fastable = (n_live == 1) & (cand1.sum() == 1) & ~tables.is_indef[op1]
        # The token arm's count rides the head's fetch, where it is kept.
        tok_sum = () if tok_n is None else (tok_n.sum(),)
        (
            accept_any,
            is_fast,
            live_idx_h,
            acc_idx_h,
            n_live_h,
            ac_sum,
            eager_sum,
            pin_sum,
            base_ops,
            op1_h,
            *tok_h,
        ) = _fetch(
            acc_row.any(),
            fastable,
            live_idx,
            _first_true(acc_row),
            n_live,
            ac_n.sum(),
            eager_n.sum(),
            pin_dead.sum(),
            base_row.sum(),
            op1,
            *tok_sum,
        )
        TOKEN_CLOSES[0] += sum(tok_h)
        pruned = overflow = False
        deep_row = None
        children_are_diag = False
        layer_log = None
        if accept_any:
            children, n_unique, exp_n, n_steps, children_live = closed, 0, 0, 1, n_live_h
        elif is_fast:
            rows = live_idx.reshape(1)
            fast_row, (alive_h, steps_h, ops_h), _ = _fast_multi(
                tables, closed, rows, fastable.reshape(1), [1 if log else max_layers - layers]
            )
            # The row stays marked valid even when it died: on STOP_EMPTY
            # the refusal diagnostics read the death-point configuration
            # from it.
            children = Frontier(*(x.index_put((rows,), y) for x, y in zip(closed, fast_row)), closed.valid)
            n_unique, n_steps = alive_h[0], steps_h[0]
            exp_n, children_live, children_are_diag = n_steps, n_live_h, True
            if log:
                # One op, one log row; the deepest row stays the pre-step
                # one, as the JAX engine's one-op fast layer keeps it.
                layer_log = tuple(np.full(n_unique, v, np.int64) for v in (live_idx_h, live_idx_h, 2 * op1_h))
            else:
                deep_row, row_ops = fast_row[0][0], ops_h[0]
        else:
            chunked = bool(chunk_rows) and chunk_rows < fr.capacity
            if graphs.ready(closed, chunked):
                # The replay overwrites the buffers that the head's row may
                # view (the last replay's children).
                base_row = base_row.clone()
            if chunked:
                children, overflow, n_unique_t, exp_t, layer_wlog = _expand_layer_chunked(
                    tables, closed, chunk_rows=chunk_rows
                )
                pruned_t = torch.zeros((), dtype=torch.bool, device=closed.valid.device)
                head = (pruned_t, n_unique_t, exp_t, children.valid.sum())
            else:
                closed, children, head, layer_wlog = graphs.expand(closed)
            pruned, n_unique, exp_n, children_live = _fetch(*head)
            pruned = bool(pruned)
            n_steps = 1
            if log:
                # The children are a dense prefix: keep an int32 copy of the
                # log's prefix (not a view, which would pin the whole layer).
                layer_log = tuple(x[:children_live].to(torch.int32) for x in layer_wlog)
        empty = not accept_any and n_unique == 0
        need_cap = (not allow_prune) and (pruned or overflow)
        if accept_any:
            stop = STOP_ACCEPT
        elif empty:
            stop = STOP_EMPTY
        elif need_cap:
            stop = STOP_CAPACITY
        # On accept/capacity the caller needs the pre-expansion frontier; on
        # extinction the deepest diagnosable one (the death point of a fast
        # stretch, else the pre-expansion rows).
        resume = accept_any or need_cap or (empty and not children_are_diag)
        fr = closed if resume else children
        live = n_live_h if resume else children_live
        # A capacity stop abandons this layer (the caller replays it), so
        # only committed layers count.
        if not need_cap:
            if log and not accept_any:
                wlog.append(layer_log)
            layers += n_steps
            max_live = max(max_live, children_live)
            expanded += exp_n
            if deep_row is None:
                deep_counts, deep_ops = base_row, base_ops
            else:
                deep_counts, deep_ops = deep_row, row_ops
        else:
            want = n_unique
        auto_closed += ac_sum
        eager_closed += eager_sum
        pin_killed += pin_sum
        pruned_ever = pruned_ever or pruned
        accept_idx = acc_idx_h
    return RunOut(
        frontier=fr,
        stop_code=stop,
        accept_idx=accept_idx,
        layers=layers,
        pruned_ever=pruned_ever,
        max_live=max_live,
        auto_closed=auto_closed,
        expanded=expanded,
        eager_closed=eager_closed,
        pin_killed=pin_killed,
        spec_layers=spec_layers,
        spec_accepts=spec_accepts,
        spec_rollbacks=spec_rollbacks,
        deep_counts=deep_counts,
        deep_ops=deep_ops,
        want=want,
        live=live,
        wlog=_fetch_log(wlog) if log else None,
    )


def _fetch_log(wlog: list) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The witness log of one :func:`run_search` call as host triples
    ``(rows, parents, opbrs)``: the device pieces come over in one transfer
    (one counted synchronisation, none when every layer was a forced
    step)."""
    dev = [x for entry in wlog if isinstance(entry[0], torch.Tensor) for x in entry]
    if dev:
        flat = _synced(torch.Tensor.cpu, torch.cat(dev)).numpy().astype(np.int64)
    out, at = [], 0
    for entry in wlog:
        if isinstance(entry[0], torch.Tensor):
            n = int(entry[0].shape[0])
            out.append((np.arange(n), flat[at:at + n], flat[at + n:at + 2 * n]))
            at += 2 * n
        else:
            out.append(entry)
    return out


# ---------------------------------------------------------------------------
# The lane-batched search
# ---------------------------------------------------------------------------

#: iterations of the lane-batched layer loop (see :func:`run_search_lanes`)
LANE_ITERS = [0]


def _stack_lanes(tables: list[SearchTables], frontiers: list[Frontier]) -> tuple[SearchTables, Frontier]:
    """One table set and one frontier for B shape-identical lanes: per-op
    columns concatenated along the op axis (the op indices in ``chain_ops``
    offset by ``l·N``, the record-hash rows in ``rh_row`` by ``l·R``, the
    chains in ``chain_of`` by ``l·C``), per-chain tables along the chain
    axis, ``rh`` into one ``[B·R, W]`` table, and the frontiers row after
    row (lane ``l`` holds rows ``l·F ..``)."""
    t0 = tables[0]
    dims = {(t.ops.op_type.shape, t.ops.rh.shape, t.ops.chain_ops.shape, t.opens_tab.shape) for t in tables}
    if len(dims) != 1 or len({f.capacity for f in frontiers}) != 1:
        raise ValueError("lanes must be shape-identical (encode them with encode_batch) and of one capacity")
    offset = {
        "chain_ops": t0.ops.op_type.shape[0],
        "rh_row": t0.ops.rh.shape[0],
        "chain_of": t0.ops.chain_len.shape[0],
    }

    def cat(xs, off=0):
        if off:
            xs = [torch.where(x >= 0, x + lane * off, x) for lane, x in enumerate(xs)]
        return torch.cat(xs)

    ops = DeviceOps(*(cat([getattr(t.ops, name) for t in tables], offset.get(name, 0))
                      for name in DeviceOps._fields))
    rest = {name: cat([getattr(t, name) for t in tables])
            for name in SearchTables._fields if name not in ("ops", "can_close", "tok_close")}
    # The lane loop does not count TOKEN_CLOSES.
    stacked = SearchTables(ops=ops, can_close=any(t.can_close for t in tables), tok_close=False, **rest)
    return stacked, Frontier(*(torch.cat(xs) for xs in zip(*frontiers)))


def run_search_lanes(tables: list[SearchTables], frontiers: list[Frontier], max_layers: int) -> list[RunOut]:
    """Run B lanes' searches for at most ``max_layers`` layers each in one
    layer loop (the JAX engine's ``jit(vmap(run_search))`` of
    ``checker/batched.py::_mega_launch``, with ``allow_prune=True`` and no
    other option): one :class:`RunOut` per lane, field for field the one
    :func:`run_search` gives that lane alone.

    The lanes must be shape-identical (:func:`..models.encode.encode_batch`)
    and of one capacity F.  Their tables are stacked (:func:`_stack_lanes`)
    and their rows kept in one frontier, lane ``l`` in rows ``l·F ..``; each
    row's chain lookups go through its lane's base (:func:`_chains`), and
    op indices are global, so the step kernel and the fold need nothing
    more.  An iteration runs one layer of every running lane: the
    auto-close sweep (repeated while a row of any lane moved), the tail pin
    and the accept test over all rows, one fetch of per-lane vectors, then
    one expansion (:func:`_expand_layer` over ``nl = B`` lanes) of the rows
    of the lanes that branch and one forced stretch (:func:`_fast_multi`)
    for the lanes that step alone, each with its own budget, the others
    masked out on the device.  A lane that stops (accept, extinction or its
    layer budget) latches: its result is kept and its rows are marked
    invalid, so that nothing of it moves again.  Nothing goes from the host
    to the device inside the loop.

    B copies of one lane cost the host syncs and fold launches of that
    lane alone.  Lanes that differ cost more an iteration than one lane
    costs a layer: the forced stretches step one op a sync until the
    longest of them ends while the expanding lanes wait, and the auto-close
    sweep repeats while a row of any lane moved (``PERF.md`` §6 has the
    counts of 16 headline-shape lanes).
    """
    b = len(tables)
    if b == 0:
        return []
    st, fr = _stack_lanes(tables, frontiers)
    f = frontiers[0].capacity
    c = fr.counts.shape[1]
    dev = fr.counts.device
    live0, ops0 = _fetch_lanes(fr.valid.view(b, f).sum(1), fr.counts.view(b, f, c)[:, 0].sum(1))
    lane = [
        dict(frontier=frontiers[i], stop_code=STOP_RUNNING, accept_idx=0, layers=0, pruned_ever=False,
             max_live=live0[i], auto_closed=0, expanded=0, eager_closed=0, pin_killed=0,
             deep_counts=frontiers[i].counts[0], deep_ops=ops0[i], live=live0[i])
        for i in range(b)
    ]
    run = list(range(b)) if max_layers > 0 else []
    cb_lane = torch.arange(b, device=dev) * c
    cb = cb_lane[:, None].expand(b, f).reshape(-1)
    starts = torch.arange(b, device=dev) * f
    while run:
        LANE_ITERS[0] += 1
        tl = st._replace(can_close=any(tables[i].can_close for i in run))
        closed_counts, ac_n, eager_n, _ = _auto_close(tl, fr, cb)
        closed = fr._replace(counts=closed_counts)
        pin_dead = closed.valid & (closed.tail > _row_tail_pin(tl, closed.counts, cb))
        closed = closed._replace(valid=closed.valid & ~pin_dead)
        acc_row = _accept_rows(tl, closed.counts, closed.valid, cb).view(b, f)
        valid = closed.valid.view(b, f)
        live_idx = _first_true(valid)
        base_rows = starts + live_idx
        base_row = closed.counts[base_rows]
        nxt1, cand1 = _next_and_cands(tl, base_row, cb_lane)
        op1 = nxt1.gather(1, _first_true(cand1)[:, None])[:, 0]
        n_live = valid.sum(1)
        accepts = acc_row.any(1)
        fastable = (n_live == 1) & (cand1.sum(1) == 1) & ~tl.is_indef[op1]
        (acc_any, is_fast, acc_idx_h, n_live_h, ac_h, eager_h, pin_h, base_ops) = _fetch_lanes(
            accepts, fastable, _first_true(acc_row), n_live,
            ac_n.view(b, f).sum(1), eager_n.view(b, f).sum(1), pin_dead.view(b, f).sum(1), base_row.sum(1),
        )
        fast = [p for p in run if is_fast[p] and not acc_any[p]]
        grow = [p for p in run if not is_fast[p] and not acc_any[p]]
        grown = ()
        if grow:
            # Only the branching lanes' rows expand (a stopped lane's rows
            # are invalid already).
            grow_rows = ~(accepts | fastable)[:, None].expand(b, f).reshape(-1)
            children, *grown, _ = _expand_layer(
                tl, closed._replace(valid=closed.valid & grow_rows), allow_prune=True, cbase=cb, nl=b
            )
            grown.append(children.valid.view(b, f).sum(1))
        if fast:
            # The expansion's vectors ride the first forced step's fetch.
            (fc, ft, fh, fk), (f_alive, f_steps, f_ops), grown = _fast_multi(
                tl, closed, base_rows, fastable & ~accepts,
                [max_layers - s["layers"] for s in lane], cb_lane, grown,
            )
        elif grow:
            grown = _fetch_lanes(*grown)
        if grow:
            g_pruned, g_uniq, g_exp, g_live = grown
        if len(grow) == len(run):
            nxt = children
        else:
            nxt = closed
            if fast:
                nxt = Frontier(*(x.index_put((base_rows,), y) for x, y in zip(nxt, (fc, ft, fh, fk))), nxt.valid)
            if grow:
                nxt = Frontier(*(torch.where(grow_rows.view((-1,) + (1,) * (x.dim() - 1)), y, x)
                                 for x, y in zip(nxt, children)))
        stopped = []
        for p in run:
            s = lane[p]
            pruned = diag = False
            deep = (base_row[p], base_ops[p])
            if acc_any[p]:
                n_unique, exp_n, n_steps, children_live = 0, 0, 1, n_live_h[p]
            elif is_fast[p]:
                n_unique, n_steps, children_live, diag = f_alive[p], f_steps[p], n_live_h[p], True
                exp_n = n_steps
                deep = (fc[p], f_ops[p])
            else:
                pruned, n_unique, exp_n, children_live = bool(g_pruned[p]), g_uniq[p], g_exp[p], g_live[p]
                n_steps = 1
            empty = not acc_any[p] and n_unique == 0
            resume = acc_any[p] or (empty and not diag)
            s["stop_code"] = STOP_ACCEPT if acc_any[p] else STOP_EMPTY if empty else STOP_RUNNING
            s["live"] = n_live_h[p] if resume else children_live
            s["layers"] += n_steps
            s["max_live"] = max(s["max_live"], children_live)
            s["expanded"] += exp_n
            s["deep_counts"], s["deep_ops"] = deep
            s["auto_closed"] += ac_h[p]
            s["eager_closed"] += eager_h[p]
            s["pin_killed"] += pin_h[p]
            s["pruned_ever"] = s["pruned_ever"] or pruned
            s["accept_idx"] = acc_idx_h[p]
            if s["stop_code"] != STOP_RUNNING or s["layers"] >= max_layers:
                src = closed if resume else nxt
                s["frontier"] = Frontier(*(x[p * f:(p + 1) * f] for x in src))
                stopped.append(p)
        if stopped:
            # Latch: the stopped lanes' rows leave the search (fills of
            # their blocks; the kept frontiers above are views of others).
            valid_next = nxt.valid.clone()
            for p in stopped:
                valid_next[p * f:(p + 1) * f] = False
            nxt = nxt._replace(valid=valid_next)
            run = [p for p in run if p not in stopped]
        fr = nxt
    return [
        RunOut(spec_layers=0, spec_accepts=0, spec_rollbacks=0, want=0, **s)
        for s in lane
    ]


# ---------------------------------------------------------------------------
# The sharded search: a frontier placed on a mesh
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ints_on(vals, dev) -> torch.Tensor:
    """Host ints as an int64 vector on ``dev``, written by fills: no
    host-to-device copy, which on a card would wait for its queue."""
    out = torch.empty(len(vals), dtype=torch.int64, device=dev)
    for i, v in enumerate(vals):
        out[i] = int(v)
    return out


def _tables_to(t: SearchTables, dev) -> SearchTables:
    rest = {k: getattr(t, k).to(dev) for k in SearchTables._fields if k not in ("ops", "can_close", "tok_close")}
    return SearchTables(ops=DeviceOps(*(x.to(dev) for x in t.ops)), can_close=t.can_close,
                        tok_close=t.tok_close, **rest)


def shard_tables(tables: SearchTables, mesh) -> tuple:
    """One table set per shard this process holds, copied once per
    distinct device (shards that share a device share the tables)."""
    by_dev: dict = {}
    for d in mesh.local_devices:
        if d not in by_dev:
            by_dev[d] = _tables_to(tables, d)
    return tuple(by_dev[d] for d in mesh.local_devices)


def _route(mesh, dests: list, make_rows, sizes=None):
    """The one routing helper of the sharded layer: send items between
    shards.

    ``dests[i]`` is the destination shard of each item of local shard
    ``i`` (``mesh.size``: not sent); ``make_rows(i, idx)`` builds the int64
    rows ``[len(idx), W]`` of local shard ``i``'s items ``idx``, called once
    for the items that go.  ``sizes[s][d]``, the items shard ``s`` sends to
    shard ``d``, is passed when the caller already knows it, else it is
    gathered (one counted fetch for all shards).  Returns ``(received,
    plan)``: ``received[j]`` the rows local shard ``j`` got, from shard 0
    first and each shard's in its own order, and the plan by which
    :func:`_reply` answers them."""
    n = mesh.size
    orders = [torch.sort(d, stable=True).indices for d in dests]
    if sizes is None:
        # A scatter-add, not ``bincount``, which sizes its output from a
        # fetch of the largest value on a card.
        counts = [torch.zeros(n + 1, dtype=torch.int64, device=d.device).scatter_add_(0, d, torch.ones_like(d))
                  for d in dests]
        sizes = _fetch_matrix(mesh.gather([x[:n] for x in counts]))
    pieces = []
    for i, order in enumerate(orders):
        row = sizes[mesh.first + i]
        pieces.append(list(make_rows(i, order[: sum(row)]).split(row)))
    got = mesh.exchange(pieces, sizes)
    return [torch.cat(g) for g in got], (orders, sizes)


def _reply(mesh, plan, replies: list) -> list:
    """Send ``replies[j]`` (rows aligned with :func:`_route`'s
    ``received[j]``) back to where the items came from.  Returns, per local
    shard, rows aligned with its items (zeros for the items not sent)."""
    orders, sizes = plan
    n, first = mesh.size, mesh.first
    back = [[sizes[s][d] for s in range(n)] for d in range(n)]
    got = mesh.exchange([list(r.split(back[first + j])) for j, r in enumerate(replies)], back)
    out = []
    for order, g in zip(orders, got):
        rows = torch.cat(g)
        full = torch.zeros((order.shape[0],) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
        out.append(full.index_copy_(0, order[: rows.shape[0]], rows))
    return out


def _close_pin_shards(tables: tuple, blocks: list, dev0) -> list:
    """Auto-close and tail-pin a process's shards, as :func:`_auto_close`
    and the pin of :func:`run_search` do one frontier: each row sweeps to
    its own fixpoint, so shards sweep together while a row of any of them
    moves, one fetch a sweep for all (counted in :data:`CLOSE_SWEEPS`).
    Returns per shard ``(closed, n_closed, n_eager, pin_dead)``."""
    counts = [b.counts for b in blocks]
    n_eager = [torch.zeros_like(b.tail) for b in blocks]
    while tables[0].can_close:
        steps = [_advance_now(t, cn, b) for t, cn, b in zip(tables, counts, blocks)]
        active = [b.valid & adv.any(-1) for b, (adv, _, _) in zip(blocks, steps)]
        CLOSE_SWEEPS[0] += 1
        if not _fetch(torch.stack([a.any().to(dev0) for a in active]).any())[0]:
            break
        for i, ((adv, eager, _), a) in enumerate(zip(steps, active)):
            counts[i] = counts[i] + (adv & a[:, None]).long()
            n_eager[i] = n_eager[i] + (eager & a[:, None]).sum(-1)
    out = []
    for t, b, cn, ne in zip(tables, blocks, counts, n_eager):
        pin = b.valid & (b.tail > _row_tail_pin(t, cn))
        out.append((b._replace(counts=cn, valid=b.valid & ~pin), (cn - b.counts).sum(-1), ne, pin))
    return out


def _probe_dedup_sharded(mesh, tables, blocks, kids, e2: int) -> list:
    """:func:`_probe_dedup` over the shards' children: the table of ``e2``
    global children is split into ``mesh.size`` slot ranges, and in each
    round every surviving child goes to the shard that owns its slot with
    its global index and identity; the owner runs the scatter-min and the
    exact compare against the slot's winner, and the verdicts go back.  The
    winners and the collisions kept are the unsharded table's."""
    n, first = mesh.size, mesh.first
    tsz = _probe_table_size(e2)
    hh, ident = [], []
    for t, b, k in zip(tables, blocks, kids):
        hh.append(_child_hashes(t, b, k["t2"], k["h2"], k["k2"], k["parent2"], k["chain2"], k["pk2"]))
        cnt = k["pk2"][:, None] if k["pk2"] is not None else _child_counts(b, k["parent2"], k["chain2"])
        ident.append(torch.cat([k["g"][:, None], torch.stack([k["t2"], k["h2"], k["k2"]], 1), cnt], 1))
    keep = [torch.zeros_like(k["valid2"]) for k in kids]
    surv = [k["valid2"] for k in kids]
    for r in range(3):
        slots = [(h1 + r * (h2 | 1)) & (tsz - 1) for h1, h2 in hh]
        dests = [torch.where(sv, sl * n // tsz, n) for sv, sl in zip(surv, slots)]
        recv, plan = _route(mesh, dests, lambda i, idx: torch.cat([slots[i][idx, None], ident[i][idx]], 1))
        flags = []
        for j, rows in enumerate(recv):
            lo = _cdiv((first + j) * tsz, n)
            size = _cdiv((first + j + 1) * tsz, n) - lo
            slot, g, rid = rows[:, 0] - lo, rows[:, 1], rows[:, 2:]
            win = torch.full((size,), e2, dtype=torch.int64, device=rows.device)
            win.scatter_reduce_(0, slot, g, "amin", include_self=True)
            is_win = g == win[slot]
            at = torch.zeros(size + 1, dtype=torch.int64, device=rows.device).scatter_(
                0, torch.where(is_win, slot, size), torch.arange(rows.shape[0], device=rows.device)
            )
            dup = ~is_win & (rid == rid[at[slot]]).all(1)
            flags.append((is_win.long() | (dup.long() << 1))[:, None])
        for i, fl in enumerate(_reply(mesh, plan, flags)):
            is_win = surv[i] & (fl[:, 0] & 1).bool()
            dup = surv[i] & (fl[:, 0] & 2).bool()
            keep[i] = keep[i] | is_win
            surv[i] = surv[i] & ~is_win & ~dup
    return [kp | sv for kp, sv in zip(keep, surv)]


def _sort_dedup_sharded(mesh, tables, blocks, kids) -> list:
    """Sort dedup (packed key) over the shards' children: each valid child
    goes to the shard a hash of its identity picks, which sorts what it
    got by :func:`_dedup_sort` in global-index order and keeps the head of
    each identity run — the smallest global index, as unsharded."""
    n = mesh.size
    dests, ident = [], []
    for t, b, k in zip(tables, blocks, kids):
        hh1, _ = _child_hashes(t, b, k["t2"], k["h2"], k["k2"], k["parent2"], k["chain2"], k["pk2"])
        dests.append(torch.where(k["valid2"], hh1 % n, n))
        ident.append(torch.stack([k["g"], k["pk2"], k["t2"], k["h2"], k["k2"]], 1))
    recv, plan = _route(mesh, dests, lambda i, idx: ident[i][idx])
    flags = []
    for rows in recv:
        keep = torch.zeros(rows.shape[0], 1, dtype=torch.int64, device=rows.device)
        if rows.shape[0]:
            by_g = torch.sort(rows[:, 0]).indices
            r = rows[by_g]
            head, _sid, sidx, _ = _dedup_sort(torch.zeros_like(r[:, 0], dtype=torch.bool), tuple(r[:, 1:].unbind(1)))
            keep.index_copy_(0, by_g[sidx], head.long()[:, None])
        flags.append(keep)
    return [fl[:, 0].bool() for fl in _reply(mesh, plan, flags)]


def _expand_layer_sharded(
    tables: tuple,
    blocks: list,
    mesh,
    *,
    allow_prune: bool,
    exact_pack: bool = False,
    sort_dedup: bool = False,
    log: bool = False,
):
    """:func:`_expand_layer` over a placed frontier, equal to it row for
    row.

    The per-row work runs on each shard's device: candidates, one fold
    call per shard, the step, the children's keys and hashes.  Each child
    carries its index in the unsharded layout (``branch·F·C + row·C +
    chain``), so a shard's children are two contiguous blocks of the global
    order.  The cross-row work goes through :func:`_route`: the dedup
    (:func:`_probe_dedup_sharded`, three fetches, or
    :func:`_sort_dedup_sharded`, one), then one fetch of every (branch,
    shard) block's priority-class histogram, from which the host works out
    the beam threshold, each block's kept rows and their global slots; each
    kept child then goes to the shard that owns its slot with its counts
    row, state, global parent and (with ``log``) ``op*2 + branch``.

    Returns ``(children, pruned, n_unique, expanded, live, wlog)``: the
    children's blocks, host ints, and with ``log`` each shard's
    ``(parent, opbr)``."""
    n, first = mesh.size, mesh.first
    fs, c = blocks[0].counts.shape
    f, e = fs * n, fs * c
    kids = []
    for i, (t, b) in enumerate(zip(tables, blocks)):
        t2, h2, k2, valid2, op2, parent2, chain2, cand = _expand_slice(t, b)
        loc = torch.arange(2 * e, device=valid2.device)
        kids.append(dict(
            t2=t2, h2=h2, k2=k2, valid2=valid2, op2=op2, parent2=parent2, chain2=chain2, cand=cand,
            g=loc + (first + i) * e + (loc >= e).long() * (f * c - e),
            pk2=(b.counts * t.pack).sum(1)[parent2] + t.pack[chain2] if exact_pack else None,
        ))
    if exact_pack and sort_dedup:
        keep = _sort_dedup_sharded(mesh, tables, blocks, kids)
    else:
        keep = _probe_dedup_sharded(mesh, tables, blocks, kids, 2 * f * c)
    opens = [_child_opens(t, b, k["parent2"], k["op2"]).view(2, -1) for t, b, k in zip(tables, blocks, kids)]
    hist = [
        torch.zeros(2, _OPENS_CAP, dtype=torch.int64, device=o.device).scatter_add_(1, o, kp.view(2, -1).long())
        for o, kp in zip(opens, keep)
    ]
    h = np.asarray(_fetch_matrix(mesh.gather([torch.cat([x.reshape(-1), k["cand"].sum().reshape(1)])
                                               for x, k in zip(hist, kids)])))
    # (branch, shard) blocks in the global child order: block b*n + s.
    cnt = h[:, :-1].reshape(n, 2, _OPENS_CAP).transpose(1, 0, 2).reshape(2 * n, _OPENS_CAP)
    n_unique = int(cnt.sum())
    kept = cnt.sum(1)
    vstar, thr = 0, None
    if allow_prune:
        cum = np.cumsum(cnt.sum(0))
        pruned = bool((cum > f).any())
        if pruned:
            # The threshold class's first f - below children in global
            # order: block b keeps those within its share of that budget.
            vstar = int(np.argmax(cum > f))
            below = int(cum[vstar - 1]) if vstar else 0
            inc = cnt[:, vstar]
            thr = f - below - (np.cumsum(inc) - inc)
            kept = cnt[:, :vstar].sum(1) + np.clip(thr, 0, inc)
    else:
        pruned = n_unique > f
    start = np.cumsum(kept) - kept
    sizes = [[0] * n for _ in range(n)]
    for blk in range(2 * n):
        a0, a1 = int(start[blk]), min(int(start[blk] + kept[blk]), f)
        for d in range(n):
            sizes[blk % n][d] += max(0, min(a1, (d + 1) * fs) - max(a0, d * fs))
    dests, slots = [], []
    for i, (kp, o) in enumerate(zip(keep, opens)):
        s = first + i
        pos = []
        for br, (kb, ob) in enumerate(zip(kp.view(2, -1), o)):
            blk = br * n + s
            if thr is not None:
                in_class = kb & (ob == vstar)
                kb = kb & ((ob < vstar) | (in_class & (in_class.long().cumsum(0) <= int(thr[blk]))))
            p = kb.long().cumsum(0) - 1 + int(start[blk])
            pos.append(torch.where(kb & (p < f), p, -1))
        pos = torch.cat(pos)
        dests.append(torch.where(pos >= 0, pos // fs, n))
        slots.append(pos % fs)

    def make_rows(i, idx):
        k, b = kids[i], blocks[i]
        p = k["parent2"][idx]
        cols = [slots[i][idx, None], _child_counts(b, p, k["chain2"][idx]),
                torch.stack([k["t2"][idx], k["h2"][idx], k["k2"][idx], p + (first + i) * fs], 1)]
        if log:
            cols.append((k["op2"][idx] * 2 + (idx >= e).long())[:, None])
        return torch.cat(cols, 1)

    recv, _plan = _route(mesh, dests, make_rows, sizes)
    children, wlog = [], []
    for rows in recv:
        dev, at = rows.device, rows[:, 0]

        def put(col):
            return torch.zeros(fs, dtype=torch.int64, device=dev).index_copy_(0, at, col)

        counts = torch.zeros(fs, c, dtype=torch.int64, device=dev).index_copy_(0, at, rows[:, 1 : 1 + c])
        valid = torch.zeros(fs, dtype=torch.bool, device=dev).index_fill_(0, at, True)
        children.append(Frontier(counts, put(rows[:, 1 + c]), put(rows[:, 2 + c]), put(rows[:, 3 + c]), valid))
        if log:
            wlog.append((put(rows[:, 4 + c]), put(rows[:, 5 + c])))
    live = min(int(kept.sum()), f)
    return children, pruned, n_unique, int(h[:, -1].sum()), live, (wlog if log else None)


def _spec_dive_sharded(tables, blocks, mesh, depth, width, exact_pack, sort_dedup):
    """:func:`_spec_dive` over a placed frontier: the order keys of every
    shard (``F`` integers) are gathered and stably sorted, the ``width``
    best rows go to shard 0, whose device dives them alone.  Returns
    ``(found, k, acc_blocks, counts)``: on an accept, ``acc_blocks`` is the
    entry frontier with every row invalid but global row 0, the accepting
    row, and ``counts`` its counts."""
    n, first = mesh.size, mesh.first
    fs, c = blocks[0].counts.shape
    dev0 = mesh.local_devices[0]
    entry = [x[0] for x in _close_pin_shards(tables, blocks, dev0)]
    keys = mesh.gather([_dive_keys(t, e) for t, e in zip(tables, entry)]).reshape(-1)
    order = torch.sort(keys, stable=True).indices[:width]
    rank = torch.full((n * fs,), -1, dtype=torch.int64, device=keys.device)
    rank.index_copy_(0, order, torch.arange(width, device=keys.device))
    ranks = [rank[s * fs : (s + 1) * fs].to(e.valid.device) for s, e in enumerate(entry, first)]

    def make_rows(i, idx):
        e = entry[i]
        return torch.cat([ranks[i][idx, None], e.counts[idx],
                          torch.stack([e.tail[idx], e.hash[idx], e.tok[idx], e.valid[idx].long()], 1)], 1)

    recv, _ = _route(mesh, [torch.where(r >= 0, 0, n) for r in ranks], make_rows)
    vecs = [torch.zeros(3 + c, dtype=torch.int64, device=b.valid.device) for b in blocks]
    acc_blocks = None
    if first == 0:
        rows, dev = recv[0], recv[0].device

        def put(col):
            return torch.zeros(width, dtype=torch.int64, device=dev).index_copy_(0, rows[:, 0], col)

        beam = Frontier(
            torch.zeros(width, c, dtype=torch.int64, device=dev).index_copy_(0, rows[:, 0], rows[:, 1 : 1 + c]),
            put(rows[:, 1 + c]), put(rows[:, 2 + c]), put(rows[:, 3 + c]), put(rows[:, 4 + c]).bool(),
        )
        found, k, beam, idx, ops = _dive(tables[0], beam, depth, exact_pack, sort_dedup)
        vecs[0] = torch.cat([_ints_on((found, k, ops), dev), beam.counts[idx]])
        if found:
            acc_blocks = [Frontier(*(x.clone() for x in b)) for b in blocks]
            for x, y in zip(acc_blocks[0], beam):
                x[0] = y[idx]
    found, k, _ops, *counts = _fetch_matrix(mesh.gather(vecs))[0]
    if found:
        if acc_blocks is None:
            acc_blocks = [Frontier(*(x.clone() for x in b)) for b in blocks]
        for i, b in enumerate(acc_blocks):
            b.valid.zero_()
            if first + i == 0:
                b.valid[0] = True
    return bool(found), k, acc_blocks, counts


def _run_search_sharded(
    tables, frontier: ShardedFrontier, max_layers: int, *, allow_prune: bool, exact_pack: bool,
    spec_depth: int, spec_width: int, sort_dedup: bool, log: bool,
) -> RunOut:
    """:func:`run_search` over a placed frontier: the same loop, with each
    layer's per-row work on the shards' devices and every fetch one for
    all shards (:meth:`FrontierMesh.gather`).  A layer fetches once for its
    head (accept, the lone-row test, the counters, the deepest row's
    counts), once per auto-close sweep, and, when it expands, once for the
    beam histogram plus the dedup's routes (three probe rounds, or one
    sort); a forced stretch runs on the shard that holds its row and shares
    its result in one more fetch.  Under a process group every process runs
    this loop over its own shards and reads only what every process holds.
    Returns a :class:`RunOut` whose ``frontier`` is placed on the same mesh
    and whose other fields are the unsharded search's."""
    mesh = frontier.mesh
    if log and mesh.world > 1:
        raise NotImplementedError(
            "log=True over a multi-process mesh: the witness log is read on one host; "
            "check_device runs in one process, as in the JAX package"
        )
    tables = shard_tables(tables, mesh) if isinstance(tables, SearchTables) else tuple(tables)
    n, first = mesh.size, mesh.first
    fs, c = frontier.blocks[0].counts.shape
    dev0 = mesh.local_devices[0]
    blocks = list(frontier.blocks)
    wlog: list = []
    stop = STOP_RUNNING
    layers = accept_idx = auto_closed = expanded = eager_closed = pin_killed = want = 0
    spec_layers = spec_accepts = spec_rollbacks = 0
    pruned_ever = False
    h0 = _fetch_matrix(mesh.gather([torch.cat([b.valid.sum().reshape(1), b.counts[0]]) for b in blocks]))
    max_live = live = sum(r[0] for r in h0)
    deep = h0[0][1:]
    if spec_depth > 0 and spec_width > 0:
        found, spec_layers, acc_blocks, dive_counts = _spec_dive_sharded(
            tables, blocks, mesh, spec_depth, min(spec_width, fs * n), exact_pack, sort_dedup
        )
        if found:
            blocks, stop, layers, live, spec_accepts, deep = acc_blocks, STOP_ACCEPT, spec_layers, 1, 1, dive_counts
        elif spec_layers > 0:
            spec_rollbacks = 1
    while stop == STOP_RUNNING and layers < max_layers:
        heads = _close_pin_shards(tables, blocks, dev0)
        closed = [x[0] for x in heads]
        vecs = []
        for t, (cl, ac_n, eager_n, pin_dead) in zip(tables, heads):
            acc = _accept_rows(t, cl.counts, cl.valid)
            li = _first_true(cl.valid)
            base = cl.counts[li]
            nxt1, cand1 = _next_and_cands(t, base)
            op1 = nxt1[_first_true(cand1)]
            head = (acc.any(), _first_true(acc), cl.valid.any(), li, cl.valid.sum(), ac_n.sum(), eager_n.sum(),
                    pin_dead.sum(), cand1.sum(), t.is_indef[op1], op1)
            vecs.append(torch.cat([torch.stack([x.long() for x in head]), base]))
        hv = _fetch_matrix(mesh.gather(vecs))
        acc_sh = next((s for s in range(n) if hv[s][0]), None)
        live_sh = next((s for s in range(n) if hv[s][2]), 0)
        hb = hv[live_sh]
        live_idx, op1_h, base_counts = live_sh * fs + hb[3], hb[10], hb[11:]
        n_live = sum(r[4] for r in hv)
        accept_any = acc_sh is not None
        fastable = n_live == 1 and hb[8] == 1 and not hb[9]
        pruned = False
        deep_row = None
        children_are_diag = False
        layer_log = None
        if accept_any:
            children, n_unique, exp_n, n_steps, children_live = closed, 0, 0, 1, n_live
        elif fastable:
            hs, li = divmod(live_idx, fs)
            children = list(closed)
            fast = [torch.zeros(3 + c, dtype=torch.int64, device=b.valid.device) for b in closed]
            if first <= hs < first + len(closed):
                i = hs - first
                cl, dev = closed[i], closed[i].valid.device
                rows = torch.full((1,), li, dtype=torch.int64, device=dev)
                fast_row, (alive_h, steps_h, ops_h), _ = _fast_multi(
                    tables[i], cl, rows, torch.ones(1, dtype=torch.bool, device=dev),
                    [1 if log else max_layers - layers],
                )
                children[i] = Frontier(*(x.index_put((rows,), y) for x, y in zip(cl, fast_row)), cl.valid)
                fast[i] = torch.cat([_ints_on((alive_h[0], steps_h[0], ops_h[0]), dev), fast_row[0][0]])
            n_unique, n_steps, _ops, *row = _fetch_matrix(mesh.gather(fast))[hs]
            exp_n, children_live, children_are_diag = n_steps, n_live, True
            if log:
                layer_log = tuple(np.full(n_unique, v, np.int64) for v in (live_idx, live_idx, 2 * op1_h))
            else:
                deep_row = row
        else:
            children, pruned, n_unique, exp_n, children_live, lw = _expand_layer_sharded(
                tables, closed, mesh, allow_prune=allow_prune, exact_pack=exact_pack, sort_dedup=sort_dedup, log=log
            )
            n_steps = 1
            if log:
                layer_log = tuple(
                    torch.cat([x[: max(0, min(fs, children_live - s * fs))].to(torch.int32).to(dev0)
                               for s, x in enumerate(xs)])
                    for xs in zip(*lw)
                )
        empty = not accept_any and n_unique == 0
        need_cap = (not allow_prune) and pruned
        if accept_any:
            stop = STOP_ACCEPT
        elif empty:
            stop = STOP_EMPTY
        elif need_cap:
            stop = STOP_CAPACITY
        resume = accept_any or need_cap or (empty and not children_are_diag)
        blocks = closed if resume else children
        live = n_live if resume else children_live
        if not need_cap:
            if log and not accept_any:
                wlog.append(layer_log)
            layers += n_steps
            max_live = max(max_live, children_live)
            expanded += exp_n
            deep = base_counts if deep_row is None else deep_row
        else:
            want = n_unique
        auto_closed += sum(r[5] for r in hv)
        eager_closed += sum(r[6] for r in hv)
        pin_killed += sum(r[7] for r in hv)
        pruned_ever = pruned_ever or pruned
        accept_idx = acc_sh * fs + hv[acc_sh][1] if accept_any else 0
    return RunOut(
        frontier=ShardedFrontier(tuple(blocks), mesh),
        stop_code=stop,
        accept_idx=accept_idx,
        layers=layers,
        pruned_ever=pruned_ever,
        max_live=max_live,
        auto_closed=auto_closed,
        expanded=expanded,
        eager_closed=eager_closed,
        pin_killed=pin_killed,
        spec_layers=spec_layers,
        spec_accepts=spec_accepts,
        spec_rollbacks=spec_rollbacks,
        deep_counts=_ints_on(deep, dev0),
        deep_ops=sum(deep),
        want=want,
        live=live,
        wlog=_fetch_log(wlog) if log else None,
    )


# ---------------------------------------------------------------------------
# Host side: the bucket-escalation loop
# ---------------------------------------------------------------------------


def _floor_pow2(n: int, lo: int) -> int:
    """Largest power of two ≤ n (but ≥ lo) — honors a caller's capacity cap."""
    v = lo
    while v * 2 <= n:
        v *= 2
    return v


def _compact_rows_device(fr: Frontier):
    """Compact valid rows to the frontier's leading slots, on device.
    Returns ``(counts, tail, hash, tok, n_valid)``."""
    f = fr.valid.shape[0]
    pos = fr.valid.long().cumsum(0) - 1
    dst = torch.where(fr.valid, pos, f)

    def g(x):
        out = torch.zeros((f + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        return out.index_copy_(0, dst, x)[:f]

    return g(fr.counts), g(fr.tail), g(fr.hash), g(fr.tok), fr.valid.sum()


def _accept_set_device(fr: Frontier, idx: int):
    """The accept configuration's candidate-state set, compacted into the
    leading rows on device."""
    same = fr.valid & (fr.counts == fr.counts[idx]).all(1)
    _, tail, h, tok, n = _compact_rows_device(fr._replace(valid=same))
    return tail, h, tok, n


def _states_of(enc: EncodedHistory, tail, h, tok, n) -> set[StreamState]:
    """The first ``n`` (a device scalar, one counted fetch) compacted rows'
    model states."""
    (m,) = _fetch(n)
    tail, h, tok = (x[:m].cpu().tolist() for x in (tail, h, tok))
    return {
        StreamState(
            tail=int(tail[i]),
            stream_hash=int(h[i]) & _M64,
            fencing_token=enc.token_of_id[int(tok[i])],
        )
        for i in range(m)
    }


def _final_states_device(enc: EncodedHistory, fr: Frontier, idx: int) -> list[StreamState]:
    """States of every valid row sharing the accept row's counts."""
    return sorted(_states_of(enc, *_accept_set_device(fr, idx)))


def _frontier_arrays(fr: Frontier) -> dict[str, np.ndarray]:
    """A frontier as host arrays in the JAX engine's field names and dtypes
    (counts i32, tail/hi/lo u32, tok i32, valid bool): the inverse of
    :func:`frontier_from_arrays`, and the layout of a checkpoint."""
    cols = (fr.counts, fr.tail, shr(fr.hash, 32), fr.hash & _M32, fr.tok, fr.valid)
    counts, tail, hi, lo, tok, valid = (x.cpu().numpy() for x in cols)
    return dict(
        counts=counts.astype(np.int32),
        tail=tail.astype(np.uint32),
        hi=hi.astype(np.uint32),
        lo=lo.astype(np.uint32),
        tok=tok.astype(np.int32),
        valid=valid,
    )


def _regrow_device(fr: Frontier, capacity: int) -> Frontier:
    """Re-bucket a frontier on device: pad up, or slice the dense prefix
    down (valid rows are always a prefix)."""
    f0, c = fr.counts.shape
    if capacity <= f0:
        return Frontier(*(x[:capacity] for x in fr))
    pad = capacity - f0

    def g(x):
        return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])

    return Frontier(*(g(x) for x in fr))


_STOP_NAMES = ("RUNNING", "ACCEPT", "EMPTY", "CAPACITY")

#: spill slab ranges cut ahead of the one on the device (see _spill_search)
_SPILL_AHEAD = 2

#: layer budget of one search segment while the witness log is on: the log
#: of a segment comes to the host in one transfer at its end
_WITNESS_CHUNK = 512

#: layer budget of one search segment while the frontier is above the
#: expansion bucket: short, so that :func:`check_device` can downsize soon
#: after the peak (it can only do so between segments)
_BIG_TIER_CHUNK = 8


# ---------------------------------------------------------------------------
# The host-RAM spill
# ---------------------------------------------------------------------------


def _snapshot_stats(stats: FrontierStats) -> dict:
    """The statistics a snapshot keeps: all but ``host_syncs``, which counts
    one process's synchronisations (the JAX engine's statistics have no
    such field)."""
    return {k: v for k, v in dataclasses.asdict(stats).items() if k != "host_syncs"}


def _rows_to_host(fr: Frontier) -> np.ndarray:
    """The valid rows of ``fr`` as the spill's host matrix ``[n, C+4]``
    int32 — counts, then tail, hash hi, hash lo and tok, u32 words as their
    int32 bit patterns: the JAX engine's layout.  Compacted on the device
    first, so only live rows cross; one counted fetch (the row count)."""
    counts, tail, h, tok, n = _compact_rows_device(fr)
    (n,) = _fetch(n)
    cols = torch.cat([counts[:n], torch.stack([tail[:n], shr(h[:n], 32), h[:n] & _M32, tok[:n]], 1)], 1)
    return torch.where(cols >= 1 << 31, cols - (1 << 32), cols).to(torch.int32).cpu().numpy()


def _rows_to_device(mat: np.ndarray, capacity: int, device) -> Frontier:
    """Host-matrix rows as a ``capacity``-row frontier on ``device``: the
    upload is a tight power-of-two bucket around the rows (at least 64,
    at most ``capacity``), regrown on the device."""
    n, c = mat.shape[0], mat.shape[1] - 4
    p2 = min(round_pow2(max(n, 1), 64), capacity)
    buf = np.zeros((p2, c + 4), np.int32)
    buf[:n] = mat
    m = torch.from_numpy(buf).to(device).long()
    u = m & _M32
    fr = Frontier(
        counts=m[:, :c].contiguous(),
        tail=u[:, c].contiguous(),
        hash=(u[:, c + 1] << 32) | u[:, c + 2],
        tok=m[:, c + 3].contiguous(),
        valid=torch.arange(p2, device=device) < n,
    )
    return _regrow_device(fr, capacity) if p2 < capacity else fr


def _dedup_rows(mat: np.ndarray, _key_bits: int = 64) -> np.ndarray:
    """Exact row dedup of the spill frontier (the JAX engine's
    ``_dedup_rows``, the same hashes and sort, so that both engines' host
    frontiers come out row for row alike).

    One u64-hash argsort puts equal rows side by side; an exact fix-up
    re-checks the rare rows whose hash run still holds more than one
    distinct row, so the result is ``np.unique``'s row set.  ``_key_bits``
    narrows the key in tests to force collisions through the fix-up.
    """
    n = len(mat)
    if n <= 1:
        return mat
    u = mat.view(np.uint32)
    # Two u32 FNV-style lane hashes, folded column by column in place.
    h1 = np.full(n, 0x811C9DC5, np.uint32)
    h2 = np.full(n, 0x9747B28C, np.uint32)
    tmp = np.empty(n, np.uint32)
    for j in range(mat.shape[1]):
        col = u[:, j]
        np.bitwise_xor(h1, col, out=h1)
        np.multiply(h1, np.uint32(0x01000193), out=h1)
        np.left_shift(col, np.uint32(1), out=tmp)
        np.bitwise_or(tmp, np.uint32(1), out=tmp)
        np.bitwise_xor(h2, tmp, out=h2)
        np.multiply(h2, np.uint32(0x7FEB352D), out=h2)
    key = (h1.astype(np.uint64) << np.uint64(32)) | h2
    if _key_bits < 64:
        key &= np.uint64((1 << _key_bits) - 1)
    order = np.argsort(key)  # unstable is fine: the fix-up is order-independent
    key_s = key[order]
    mat_s = mat[order]
    same_key = np.empty(n, bool)
    same_key[0] = False
    same_key[1:] = key_s[1:] == key_s[:-1]
    dup = np.zeros(n, bool)
    dup[1:] = same_key[1:] & (mat_s[1:] == mat_s[:-1]).all(axis=1)
    kept = ~dup
    # A key run holding two or more kept rows is a hash collision, or equal
    # rows a collision separated; such runs go whole through np.unique (equal
    # rows always share a run).  With 64-bit keys this almost never fires,
    # so probe cheaply first.
    if not np.count_nonzero(kept & same_key):
        return mat_s[kept]
    run_id = np.cumsum(~same_key) - 1
    kept_per_run = np.bincount(run_id[kept], minlength=int(run_id[-1]) + 1)
    ambiguous = kept & (kept_per_run[run_id] >= 2)
    plain = mat_s[kept & ~ambiguous]
    if not ambiguous.any():
        return plain
    return np.concatenate([plain, np.unique(mat_s[ambiguous], axis=0)])


def _accept_sweep_device(tables: SearchTables, fr: Frontier, accept_counts: torch.Tensor):
    """Auto-close every row, then compact the states of the rows whose
    closed counts equal the accept configuration's: one slab's share of the
    accept set (the accept test runs after auto-close, so the sweep applies
    the same closure before matching)."""
    closed = _auto_close(tables, fr)[0]
    match = fr.valid & (closed == accept_counts[None, :]).all(1)
    _, tail, h, tok, n = _compact_rows_device(fr._replace(valid=match))
    return tail, h, tok, n


def _spill_accept_states(
    enc: EncodedHistory, tables: SearchTables, host: np.ndarray, accept_counts, to_device, fill: int
) -> list[StreamState]:
    """The accept configuration's candidate states, unioned across every
    slab of the accept layer and not only the slab that accepted, so that a
    spill OK reports the in-core path's ``final_states``.  One upload-only
    sweep of the layer, in the same slabs (auto-close never grows one)."""
    acc = np.asarray(accept_counts, np.int64)
    out: set[StreamState] = set()
    for j in range(0, len(host), fill):
        slab = to_device(host[j : j + fill])
        if isinstance(slab, ShardedFrontier):
            # Each shard sweeps its own rows, with its device's tables.
            pairs = zip(shard_tables(tables, slab.mesh), slab.blocks)
        else:
            pairs = [(tables, slab)]
        for t, fr in pairs:
            out |= _states_of(enc, *_accept_sweep_device(t, fr, torch.as_tensor(acc, device=fr.valid.device)))
    return sorted(out)


def _spill_search(
    enc: EncodedHistory,
    tables: SearchTables,
    seed: Frontier | np.ndarray,
    stats: FrontierStats,
    f_cap: int,
    cap_layers: int,
    *,
    host_cap: int,
    deep_counts,
    checkpoint_path: str | None = None,
    fingerprint: str | None = None,
    history: History | None = None,
    witness: bool = False,
    exact_pack: bool = False,
    sort_dedup: bool = False,
    profile: bool = False,
    profile_t0: float | None = None,
    mesh=None,
) -> CheckResult:
    """Out-of-core exhaustive search (the JAX engine's ``_spill_search``):
    the frontier in host RAM as the ``[n, C+4]`` int32 matrix of
    :func:`_rows_to_host`, slabs on the device.

    Each layer streams the host frontier through ``run_search(max_layers=1,
    allow_prune=False)`` in slabs of ``f_cap // 4`` rows on a slab bucket of
    ``max(f_cap, 4C)`` rows (so one row's children always fit): auto-close,
    accept test, one expansion and the in-slab dedup run on the device; the
    exact cross-slab dedup runs on the host (:func:`_dedup_rows`) between
    layers.  A slab whose children overflow the bucket is retried in
    halves, and the layer-wide fill halves with it (the fill resets each
    layer).  Whenever the deduped frontier fits half the bucket, whole
    layers run in core again (a hybrid segment) until it overflows — the
    streaming is paid only at the peak layers.

    Nothing is pruned, so OK and ILLEGAL stay conclusive; UNKNOWN (with
    ``stats.pruned``) only when the host frontier exceeds ``host_cap``
    rows, or a layer's raw children ``2 * host_cap``.  On OK the reported
    ``final_states`` are the accept configuration's states unioned across
    every slab of the accept layer (:func:`_spill_accept_states`), and with
    ``witness`` a linearization is recovered from the accept counts.

    One slab is on the device at a time: :func:`run_search` returns only
    after fetching its scalars, so a second slab in flight would overlap
    nothing.  A slab that runs the device out of memory
    (``torch.cuda.OutOfMemoryError``) is freed and requeued at half the
    fill, which is re-raised at a fill of one row: the slab stays on the
    same device, smaller — never a move to another device.  With ``mesh``
    every slab is placed on it (:func:`place_frontier`) and searched
    sharded, with the tables of ``shard_tables``.

    With ``checkpoint_path`` the host matrix is written to
    ``<path>.spill.npz`` before every streamed layer and hybrid segment (the
    JAX engine's file, plus a ``stats`` member that the JAX engine does not
    read: the statistics so far, so that a resumed run reports the whole
    search's), and removed on a conclusive verdict.
    """
    c = enc.num_chains
    dev = tables.is_indef.device
    if profile_t0 is None:
        profile_t0 = time.monotonic()

    def profile_entry(frontier_rows: int, states: int, stop: str) -> None:
        if profile:
            stats.timeline.append(
                {
                    "layer": stats.layers,
                    "frontier": frontier_rows,
                    "states": states,
                    "auto_closed": stats.auto_closed,
                    "elapsed_s": round(time.monotonic() - profile_t0, 6),
                    "stop": stop,
                    "spill": True,
                }
            )

    f_cap = max(f_cap, round_pow2(4 * max(c, 1), 2))
    spill_ck = f"{checkpoint_path}.spill.npz" if checkpoint_path else None

    run_tables = tables if mesh is None else shard_tables(tables, mesh)

    def to_device(mat: np.ndarray) -> Frontier | ShardedFrontier:
        fr = _rows_to_device(mat, f_cap, dev)
        return fr if mesh is None else place_frontier(fr, mesh)

    def run(mat: np.ndarray, max_layers: int) -> RunOut:
        return run_search(
            run_tables, to_device(mat), max_layers, allow_prune=False, exact_pack=exact_pack,
            sort_dedup=sort_dedup,
        )

    def unknown() -> CheckResult:
        stats.pruned = True
        return CheckResult(CheckOutcome.UNKNOWN)

    def conclude(res: CheckResult) -> CheckResult:
        """A conclusive verdict spends the spill snapshot."""
        if spill_ck is not None:
            with contextlib.suppress(FileNotFoundError):
                os.remove(spill_ck)
        return res

    def witness_of(counts) -> list[int] | None:
        return _recover_witness_bounded(enc, history, counts) if witness and history is not None else None

    # A Frontier seed just overflowed the same bucket in check_device, so an
    # in-core retry would fail again at once; a resumed host matrix carries
    # no such knowledge.
    try_incore = isinstance(seed, np.ndarray)
    host = seed if isinstance(seed, np.ndarray) else _rows_to_host(seed)
    deep = None if deep_counts is None else np.asarray(deep_counts).astype(np.int32)
    deep_sum = -1 if deep is None else int(deep.sum())
    log.debug("spilling to host: %d rows, slab bucket %d", len(host), f_cap)

    while stats.layers < cap_layers:
        if spill_ck is not None:
            tmp = spill_ck + ".tmp.npz"
            np.savez_compressed(
                tmp,
                fingerprint=np.array(fingerprint or ""),
                host=host,
                layers=np.int64(stats.layers),
                deep=deep if deep is not None else np.zeros(0, np.int32),
                stats=np.frombuffer(json.dumps(_snapshot_stats(stats)).encode(), np.uint8),
            )
            os.replace(tmp, spill_ck)
        if try_incore and len(host) <= f_cap // 2:
            # Hybrid segment: the frontier fits the bucket with expansion
            # headroom, so whole layers run in core until it outgrows it.
            out = run(host, cap_layers - stats.layers)
            stats.layers += out.layers
            stats.max_frontier = max(stats.max_frontier, out.max_live)
            stats.auto_closed += out.auto_closed
            stats.expanded += out.expanded
            profile_entry(out.max_live, out.max_live, _STOP_NAMES[out.stop_code])
            log.debug("spill in-core segment: stop=%s +%d layers", _STOP_NAMES[out.stop_code], out.layers)
            if out.deep_ops > deep_sum:
                deep_sum, deep = out.deep_ops, out.deep_counts.cpu().numpy().astype(np.int32)
            if out.stop_code == STOP_ACCEPT:
                whole = gather_frontier(out.frontier)
                counts = whole.counts[out.accept_idx].cpu().numpy()
                return conclude(
                    CheckResult(
                        CheckOutcome.OK,
                        linearization=witness_of(counts),
                        final_states=_final_states_device(enc, whole, out.accept_idx),
                    )
                )
            if out.stop_code == STOP_EMPTY:
                return conclude(
                    CheckResult(
                        CheckOutcome.ILLEGAL,
                        deepest=_deepest_ops(enc, deep),
                        refusals=_device_refusals(enc, history, gather_frontier(out.frontier)),
                    )
                )
            # A capacity stop (or the layer cap): back to streaming from the
            # returned pre-expansion frontier, which just proved it cannot
            # expand in core; the next streamed layer's dedup re-arms the
            # hybrid.
            host = _rows_to_host(gather_frontier(out.frontier))
            try_incore = False
            continue
        children: list[np.ndarray] = []
        children_rows = 0
        fill = max(1, f_cap // 4)
        # Independent (start, length) row ranges.  A range is cut at the
        # fill when it is queued for the device, one range ahead of the slab
        # running: the JAX engine's cut with two slabs in flight, so that
        # both engines run the same slabs in the same order.
        work = deque((j, min(fill, len(host) - j)) for j in range(0, len(host), fill))
        ahead: deque = deque()
        while work or ahead:
            while work and len(ahead) < _SPILL_AHEAD:
                s0, t0 = work.popleft()
                if t0 > fill:
                    work.appendleft((s0 + fill, t0 - fill))
                    t0 = fill
                ahead.append((s0, t0))
            s0, t0 = ahead.popleft()
            out = None
            with contextlib.suppress(torch.cuda.OutOfMemoryError):
                out = run(host[s0 : s0 + t0], 1)
            if out is None:
                # Out of device memory: the slab's tensors went with the
                # exception; requeue it and the range cut after it, and
                # retry at half the fill.
                if fill == 1:
                    raise torch.cuda.OutOfMemoryError(
                        "a one-row spill slab does not fit the device's memory"
                    )
                fill = max(1, fill // 2)
                log.warning("spill slab ran the device out of memory; halving fill -> %d", fill)
                work.extendleft(reversed([(s0, t0), *ahead]))
                ahead.clear()
                continue
            if out.stop_code == STOP_CAPACITY:
                if t0 == 1:
                    # Unreachable: the bucket fits one row's children.
                    return unknown()
                half = t0 // 2
                fill = max(1, min(fill, half))
                log.debug("slab overflow: retrying %d rows in halves, fill -> %d", t0, fill)
                work.appendleft((s0 + half, t0 - half))
                work.appendleft((s0, half))
                continue
            stats.auto_closed += out.auto_closed
            stats.expanded += out.expanded
            if out.stop_code == STOP_ACCEPT:
                stats.layers += 1
                counts = gather_frontier(out.frontier).counts[out.accept_idx].cpu().numpy()
                return conclude(
                    CheckResult(
                        CheckOutcome.OK,
                        linearization=witness_of(counts),
                        final_states=_spill_accept_states(enc, tables, host, counts, to_device, fill),
                    )
                )
            if out.deep_ops > deep_sum:
                deep_sum, deep = out.deep_ops, out.deep_counts.cpu().numpy().astype(np.int32)
            if out.stop_code != STOP_EMPTY:
                ch = _rows_to_host(gather_frontier(out.frontier))
                children.append(ch)
                children_rows += len(ch)
                if children_rows > 2 * host_cap:
                    # Bound the transient host memory too: a layer's raw
                    # children can exceed the cap many times before dedup.
                    log.warning(
                        "spill children %d exceed 2x spill_host_cap %d; UNKNOWN", children_rows, host_cap
                    )
                    return unknown()
            del out
        stats.layers += 1
        if not children:
            return conclude(
                CheckResult(
                    CheckOutcome.ILLEGAL,
                    deepest=_deepest_ops(enc, deep),
                    refusals=_host_row_refusals(enc, history, host),
                )
            )
        host = _dedup_rows(np.concatenate(children))
        del children
        try_incore = True
        stats.max_frontier = max(stats.max_frontier, len(host))
        profile_entry(len(host), len(host), "STREAMED")
        log.debug("spill layer %d: %d host rows", stats.layers, len(host))
        if len(host) > host_cap:
            log.warning("host frontier %d exceeds spill_host_cap %d; UNKNOWN", len(host), host_cap)
            return unknown()
    return unknown()


class _Spans:
    """Where one :func:`check_device` call records its spans (all
    ``cat="search"``): a tracer and its track."""

    __slots__ = ("tracer", "tid")

    def __init__(self, tracer, tid: int) -> None:
        self.tracer, self.tid = tracer, tid

    def add(self, name: str, t0: float, **args) -> None:
        """Record ``name`` from ``t0`` (``time.monotonic()``) to now."""
        self.tracer.add_span(name, t0, time.monotonic(), tid=self.tid, cat="search", args=args or None)


def _search_spans(collect_stats: bool) -> _Spans | None:
    """The job context's tracer, on the job's track, where it is enabled
    (verifyd's worker, the supervised child); else, when the caller
    collects statistics, :data:`..obs.trace.SEARCH_TRACER`; else None
    (nothing is recorded)."""
    ctx = get_job_context()
    if getattr(ctx.tracer, "enabled", False):
        return _Spans(ctx.tracer, ctx.job)
    return _Spans(SEARCH_TRACER, 0) if collect_stats else None


def check_device(
    history: History,
    *,
    max_frontier: int = 65536,
    state_slots: int | None = None,
    beam: bool = True,
    start_frontier: int = _START_FRONTIER,
    mesh=None,
    collect_stats: bool = False,
    profile: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 512,
    witness: bool = True,
    witness_max_frontier: int = 0,
    spill: bool = False,
    spill_host_cap: int = 1 << 26,
    exact_pack: bool | None = None,
    sort_dedup: bool | None = None,
    device_rows_cap: int = 0,
    pallas_fold: bool | None = None,
    progress=None,
    prune: bool = False,
    speculate_depth: int = 0,
    speculate_width: int = 64,
    device=None,
) -> CheckResult:
    """Decide linearizability on the GPU (``device=None``) or on the device
    given.  Verdict semantics match the JAX engine: OK and un-pruned ILLEGAL
    are conclusive; a dead end after beam pruning is UNKNOWN.  The keywords
    are the JAX engine's, plus ``device``.

    The search starts in a ``start_frontier``-row bucket and escalates on
    capacity stops, resuming from the returned pre-expansion frontier.  At
    ``max_frontier`` a beam run prunes and continues.  An exhaustive run
    with the packed key and ``device_rows_cap > max_frontier`` keeps its
    frontier on the device up to ``device_rows_cap`` rows, expanded in
    ``max_frontier``-row chunks (:func:`_expand_layer_chunked`) in segments
    of at most :data:`_BIG_TIER_CHUNK` layers, and drops back to a smaller
    bucket between segments once the live rows fit a quarter of it.  Past
    that cap an exhaustive run is UNKNOWN (``stats.pruned``), or with
    ``spill=True`` hands the frontier to the host-RAM spill
    (:func:`_spill_search`), conclusive up to ``spill_host_cap`` host rows.

    ``checkpoint_path``: snapshot the frontier to this file (the JAX
    engine's format, :mod:`.checkpoint`) every ``checkpoint_every`` layers
    — the segment budget, so with ``speculate_depth`` the dive follows the
    same cadence — and at each escalation; the spill writes
    ``<path>.spill.npz`` instead.  A matching spill snapshot is resumed
    first (it needs ``beam=False, spill=True``), else a matching frontier
    snapshot; a snapshot of another history, of a beam search for an
    exhaustive one or the reverse, or an unreadable one raises
    :class:`.checkpoint.CheckpointError`.  A conclusive verdict removes the
    snapshot.

    ``witness=True``: an OK carries a witness linearization, by default
    from the counts-bounded host re-search (:func:`_recover_witness_bounded`)
    run once at the accept; ``witness=False`` skips it
    (``linearization=None``).  ``witness_max_frontier > 0`` keeps the JAX
    engine's per-layer witness log instead while the frontier bucket is at
    most that many rows: a forced step takes one op a layer, segments are
    at most :data:`_WITNESS_CHUNK` layers, the dive stands down, and an OK
    walks the log back from the accept row (:func:`_witness_linearization`).
    Each segment's log comes to the host in one transfer and is kept there
    sparse, one ``(rows, parents, opbrs)`` triple a layer; on the device a
    segment holds a copy of each layer's live rows (8 bytes a row), not the
    JAX engine's ``[512, F]`` pair.  A bucket past the cap, or a resumed
    checkpoint, drops the log and the re-search takes over.  Rows dedup on the
    exact packed counts key whenever :func:`can_exact_pack` holds, else on
    the Zobrist key; ``exact_pack`` forces it on or off (``True`` on a
    history that cannot pack raises ``ValueError``).  ``sort_dedup=True``
    dedups by a lexicographic sort (:func:`_dedup_sort`) in place of the
    probe table, and needs the packed key (``ValueError`` otherwise).

    ``mesh`` (a :class:`..parallel.distributed.FrontierMesh` of one
    process) shards the frontier over the mesh's shards, searched by the
    sharded :func:`run_search`: the same frontiers and statistics as
    unsharded, plus ``stats.shards`` (per-shard peak and summed live rows,
    segments, fetch wall and skew, as in the JAX engine) and, in each
    profile entry, the segment's live rows per shard (``shards``) and the
    wall of their fetch (``sync_s``).  The smallest bucket is one row per
    shard, and the device-resident tier is off: the aggregate memory comes
    from the mesh.  The search runs on the mesh's devices; ``device``, if
    given, must name their type.

    Accepted with no effect: ``state_slots`` (as in the JAX engine);
    ``pallas_fold``: the fold is always ``csrc/fold_lanes.cu`` on the card and its plain version on the
    CPU, never the plain version on the card.

    ``prune=True`` activates the verdict-exact commutativity prunes
    (:mod:`.prune`): the append rank gate, eager commit of inert and
    passing-filter candidates, and tail-pin dead-row elimination.  They
    never change a verdict and never set ``stats.pruned``.

    ``speculate_depth > 0`` runs one speculative dive per search segment
    (:func:`_spec_dive`): the best ``speculate_width`` rows expand up to
    ``speculate_depth`` layers, accepting conclusively if a dive row
    accepts and rolling back wholesale otherwise.  It stands down while the
    witness log is on, as in the JAX engine.

    ``profile=True`` (implies ``collect_stats``) appends one entry per
    search segment to ``stats.timeline``: cumulative layers, the segment's
    peak live rows, the rows it ends with, ops auto-closed, elapsed wall
    seconds, the stop and the bucket.  ``progress`` (a
    :class:`.progress.ProgressSink`) is offered one update per segment,
    from scalars the search already fetched.

    Spans (:func:`_search_spans`: the job context's tracer, or with
    ``collect_stats`` :data:`..obs.trace.SEARCH_TRACER`): the call is one
    ``check.beam`` or ``check.exhaustive`` span, holding ``check.encode``
    (encoding and tables), one ``check.segment`` per :func:`run_search`
    call (with its syncs and their fetch time, :data:`FETCH_NS`, its
    auto-close sweeps, :data:`CLOSE_SWEEPS`, the ops the token arm
    passed, :data:`TOKEN_CLOSES`, and the layer-expansion graphs captured
    and the layers replayed from them, :data:`GRAPH_CAPTURES` and
    :data:`GRAPH_REPLAYS`, as ``captures`` and ``graph_layers``),
    ``check.escalate`` per re-bucketing, ``check.spill``,
    ``check.witness`` (with the host folds it made natively,
    ``native_folds``), ``check.final_states`` and ``check.diagnose``.
    Their ``args`` hold only host values the search already has, so a span
    adds no device work and no synchronisation.
    """
    del state_slots, pallas_fold
    if mesh is not None:
        if mesh.world > 1:
            raise NotImplementedError(
                "check_device over a multi-process mesh: check_device materializes whole frontiers "
                "on one host; run run_search SPMD, as in the JAX package"
            )
        if device is not None and torch.device(device).type != mesh.devices[0].type:
            raise ValueError(f"device={device!r} is not the mesh's ({mesh.devices[0]})")
        device = mesh.devices[0]
    dev = resolve_device(device)
    collect_stats = collect_stats or profile
    sp = _search_spans(collect_stats)
    phase = "check.beam" if beam else "check.exhaustive"
    syncs0 = SYNCS[0]
    t_run0 = time.monotonic()
    enc = encode_history(history)
    if exact_pack and not can_exact_pack(enc):
        # Zeroed strides would alias every counts vector to key 0.
        raise ValueError(
            "exact_pack=True requires prod(chain_len+1) <= 2^64 "
            "(can_exact_pack); this history's counts space overflows u64"
        )
    stats = FrontierStats()
    if enc.total_remaining == 0:
        res = CheckResult(
            CheckOutcome.OK,
            linearization=list(enc.forced_prefix),
            final_states=sorted(enc.init_states),
        )
        if collect_stats:
            res.stats = stats  # type: ignore[attr-defined]
        if sp is not None:
            sp.add("check.encode", t_run0, ops=enc.num_ops, chains=enc.num_chains,
                   tokens=len(enc.token_of_id) - 1)
            sp.add(phase, t_run0, outcome=res.outcome.value, layers=0, bucket=0)
        return res
    tables = build_tables(enc, dev, prune=prune)
    if sp is not None:
        sp.add("check.encode", t_run0, ops=enc.num_ops, chains=enc.num_chains,
               tokens=len(enc.token_of_id) - 1)
    run_tables = tables if mesh is None else shard_tables(tables, mesh)
    xp = can_exact_pack(enc) if exact_pack is None else bool(exact_pack)
    if sort_dedup and not xp:
        raise ValueError(
            "sort_dedup=True requires the exact packed counts key "
            "(can_exact_pack / exact_pack); this history cannot pack"
        )
    sd = bool(sort_dedup)
    cap_layers = int(enc.total_remaining) + 2
    f_cap = _floor_pow2(max_frontier, 2)
    # The device-resident tier: exhaustive, packed key only (a beam run
    # prunes at the bucket instead).  Not under a mesh: the shards already
    # divide the frontier, and the aggregate memory comes from the mesh.
    big_cap = (
        _floor_pow2(device_rows_cap, 2) if device_rows_cap > f_cap and not beam and xp and mesh is None else f_cap
    )
    f = round_pow2(max(min(start_frontier, f_cap), len(enc.init_states)), 2)
    if mesh is not None:
        # Even sharding needs the frontier axis divisible by the shard
        # count; the smallest bucket under a mesh is one row per shard.
        f = max(f, round_pow2(mesh.size, 2))
    frontier = res = None
    fingerprint = None
    # Whether the witness log is on; dropped for good past its cap or on a
    # resume, after which an OK falls back to the re-search.
    log_on = witness
    wlogs: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def spill_from(seed, deep_counts) -> CheckResult:
        t0, layers0 = time.monotonic(), stats.layers
        out = _spill_search(
            enc, tables, seed, stats, f_cap, cap_layers, host_cap=spill_host_cap,
            deep_counts=deep_counts, checkpoint_path=checkpoint_path, fingerprint=fingerprint,
            history=history, witness=witness, exact_pack=xp, sort_dedup=sd, profile=profile,
            profile_t0=t_run0, mesh=mesh,
        )
        if sp is not None:
            sp.add("check.spill", t0, layers=stats.layers - layers0)
        return out

    def regrow(fr: Frontier | ShardedFrontier, to: int) -> Frontier | ShardedFrontier:
        t0, was = time.monotonic(), fr.capacity
        out = place(_regrow_device(gather_frontier(fr), to))
        if sp is not None:
            sp.add("check.escalate", t0, **{"from": was, "to": to})
        return out

    def place(fr: Frontier) -> Frontier | ShardedFrontier:
        return fr if mesh is None else place_frontier(fr, mesh)

    if checkpoint_path is not None:
        fingerprint = history_fingerprint(enc)
        spill_snapshot = f"{checkpoint_path}.spill.npz"
        if os.path.exists(spill_snapshot):
            try:
                with np.load(spill_snapshot, allow_pickle=False) as z:
                    saved_fp, host, layers, deep0 = str(z["fingerprint"]), z["host"], int(z["layers"]), z["deep"]
                    # A snapshot of the JAX engine's has no statistics.
                    saved_stats = json.loads(bytes(z["stats"]).decode()) if "stats" in z else {}
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                raise CheckpointError(f"cannot read spill checkpoint {spill_snapshot}: {e}") from e
            if saved_fp != fingerprint:
                raise CheckpointError(
                    f"spill checkpoint {spill_snapshot} " + fingerprint_mismatch_reason(saved_fp, fingerprint)
                )
            if beam or not spill:
                raise CheckpointError(
                    f"spill checkpoint {spill_snapshot} requires an exhaustive spill-enabled run to resume"
                )
            for k, v in saved_stats.items():
                setattr(stats, k, v)
            stats.layers = layers
            res = spill_from(host, deep0 if len(deep0) else None)
        elif os.path.exists(checkpoint_path):
            ck = load_checkpoint(checkpoint_path)
            if ck.fingerprint != fingerprint:
                raise CheckpointError(
                    f"checkpoint {checkpoint_path} " + fingerprint_mismatch_reason(ck.fingerprint, fingerprint)
                )
            if ck.beam != beam:
                # A pruned beam frontier must never seed an exhaustive pass
                # (its dead ends would be inconclusive forever), nor the
                # reverse.
                raise CheckpointError(
                    f"checkpoint {checkpoint_path} was written by a "
                    f"{'beam' if ck.beam else 'exhaustive'} search and cannot "
                    f"resume a {'beam' if beam else 'exhaustive'} one"
                )
            f = ck.f
            for k, v in ck.stats.items():
                setattr(stats, k, v)
            stats.layers = ck.layers_done
            # The log of the layers before the snapshot is not in it.
            log_on = log_on and stats.layers == 0
            frontier = frontier_from_arrays(vars(ck), dev)
            if mesh is not None and f < mesh.size:
                # Resumed onto a wider mesh than the snapshot's bucket:
                # grow to one row per shard so that it shards evenly.
                f = round_pow2(mesh.size, 2)
                frontier = _regrow_device(frontier, f)

    def snapshot(fr: Frontier | ShardedFrontier) -> None:
        save_checkpoint(
            checkpoint_path,
            Checkpoint(fingerprint=fingerprint, **_frontier_arrays(gather_frontier(fr)), f=f, beam=beam,
                       layers_done=stats.layers, stats=_snapshot_stats(stats)),
        )

    if frontier is None and res is None:
        frontier = init_frontier(enc, f, dev)
    if frontier is not None:
        frontier = place(frontier)
    log.debug(
        "device search: %d ops over %d chains, frontier=%d (cap %d, device rows %d), %s, %s",
        enc.num_ops,
        enc.num_chains,
        f,
        f_cap,
        big_cap,
        "beam" if beam else "exhaustive",
        dev,
    )
    while res is None:
        allow_prune = beam and f >= f_cap
        if log_on and f > witness_max_frontier:
            if witness_max_frontier > 0:
                log.debug("witness log dropped: frontier %d exceeds witness cap %d", f, witness_max_frontier)
            log_on = False
            wlogs = []
        layers_budget = cap_layers - stats.layers
        if checkpoint_path is not None and checkpoint_every > 0:
            layers_budget = min(layers_budget, checkpoint_every)
        if log_on:
            layers_budget = min(layers_budget, _WITNESS_CHUNK)
        if f > f_cap:
            layers_budget = min(layers_budget, _BIG_TIER_CHUNK)
        chunk_rows = f_cap if big_cap > f_cap and f > f_cap else 0
        t_seg, syncs_seg, fetch_seg = time.monotonic(), SYNCS[0], FETCH_NS[0]
        sweeps_seg, tok_seg = CLOSE_SWEEPS[0], TOKEN_CLOSES[0]
        captures_seg, replays_seg = GRAPH_CAPTURES[0], GRAPH_REPLAYS[0]
        out = run_search(
            run_tables,
            frontier,
            layers_budget,
            allow_prune=allow_prune,
            exact_pack=xp,
            spec_depth=0 if log_on else int(speculate_depth),
            spec_width=int(speculate_width) if speculate_depth else 0,
            sort_dedup=sd,
            chunk_rows=chunk_rows,
            log=log_on,
        )
        code = out.stop_code
        if sp is not None:
            sp.add(
                "check.segment", t_seg, stop=_STOP_NAMES[code], layers=out.layers, bucket=f,
                chunked=chunk_rows > 0, syncs=SYNCS[0] - syncs_seg,
                fetch_ms=(FETCH_NS[0] - fetch_seg) / 1e6, sweeps=CLOSE_SWEEPS[0] - sweeps_seg,
                token_closes=TOKEN_CLOSES[0] - tok_seg, captures=GRAPH_CAPTURES[0] - captures_seg,
                graph_layers=GRAPH_REPLAYS[0] - replays_seg,
            )
        log.debug(
            "segment done: stop=%s layers=%d/%d live=%d expanded=%d",
            _STOP_NAMES[code],
            stats.layers + out.layers,
            cap_layers,
            out.live,
            stats.expanded + out.expanded,
        )
        stats.layers += out.layers
        stats.max_frontier = max(stats.max_frontier, out.max_live)
        stats.auto_closed += out.auto_closed
        stats.expanded += out.expanded
        stats.prune_commits += out.eager_closed
        stats.prune_dead += out.pin_killed
        stats.spec_layers += out.spec_layers
        stats.spec_accepts += out.spec_accepts
        stats.spec_rollbacks += out.spec_rollbacks
        if speculate_depth and not log_on:
            stats.spec_launches += 1
        if log_on:
            wlogs.extend(out.wlog)
        seg_shards = None
        if mesh is not None and collect_stats:
            seg_shards, sync_s = _shard_occupancy(out.frontier, mesh)
            _note_shard_stats(stats, mesh, seg_shards, sync_s)
        if profile:
            entry = {
                "layer": stats.layers,
                "frontier": out.max_live,
                "states": out.live,
                "auto_closed": out.auto_closed,
                "elapsed_s": round(time.monotonic() - t_run0, 6),
                "stop": _STOP_NAMES[code],
                "bucket": f,
            }
            if seg_shards is not None:
                entry["shards"] = [int(x) for x in seg_shards]
                entry["sync_s"] = round(sync_s, 6)
            stats.timeline.append(entry)
        if progress is not None:
            progress.update(
                ops_committed=out.deep_ops,
                total_ops=enc.num_ops,
                frontier_width=out.live,
                states_expanded=stats.expanded,
                layer=stats.layers,
                engine="device",
            )
        if allow_prune:
            stats.pruned = stats.pruned or out.pruned_ever
        if code == STOP_ACCEPT:
            whole = gather_frontier(out.frontier)
            t0, lin, source = time.monotonic(), None, None
            folds0 = NATIVE_FOLDS[0]
            if log_on:
                pt = analyze_encoded(enc) if prune else None
                lin, source = _witness_linearization(enc, wlogs, out.accept_idx, pt=pt), "log"
            if lin is None and witness:
                # No log (off, dropped or inconsistent): re-search below the
                # accept counts.
                lin = _recover_witness_bounded(enc, history, whole.counts[out.accept_idx].cpu().numpy())
                source = "research"
            if sp is not None and source is not None:
                sp.add("check.witness", t0, source=source, found=lin is not None,
                       native_folds=NATIVE_FOLDS[0] - folds0)
            t0 = time.monotonic()
            final_states = _final_states_device(enc, whole, out.accept_idx)
            if sp is not None:
                sp.add("check.final_states", t0)
            res = CheckResult(CheckOutcome.OK, linearization=lin, final_states=final_states)
            break
        if code == STOP_EMPTY:
            outcome = CheckOutcome.UNKNOWN if stats.pruned else CheckOutcome.ILLEGAL
            t0 = time.monotonic()
            deepest = _deepest_ops(enc, out.deep_counts.cpu().numpy())
            refusals = _device_refusals(enc, history, gather_frontier(out.frontier))
            if sp is not None:
                sp.add("check.diagnose", t0, refusals=len(refusals))
            res = CheckResult(outcome, deepest=deepest, refusals=refusals)
            break
        if code == STOP_CAPACITY:
            if f < big_cap:
                # Jump straight to a bucket that fits the aborted layer's
                # children (x2 headroom), resuming from the returned
                # pre-expansion frontier (no information was lost); past
                # f_cap the frontier grows on the device, chunked.
                f = min(round_pow2(max(out.want * 2, f * 4), 2), big_cap)
                log.debug("capacity stop: escalating frontier to %d and resuming", f)
                frontier = regrow(out.frontier, f)
                if checkpoint_path is not None:
                    snapshot(frontier)
                continue
            if not beam and spill:
                # Out-of-core hand-off: the pre-expansion frontier goes to
                # host RAM, compacted on the device first.
                res = spill_from(gather_frontier(out.frontier), out.deep_counts.cpu().numpy())
                break
            stats.pruned = True
            res = CheckResult(CheckOutcome.UNKNOWN)
            break
        if code == STOP_RUNNING and stats.layers < cap_layers:
            # Segment boundary: go on from the post-expansion frontier.
            frontier = out.frontier
            if f > f_cap and out.live * 4 <= f:
                # Past the peak: drop to a bucket the live prefix fits with
                # headroom (never below the expansion bucket), so later
                # layers stop paying full-width chunked sorts.
                f = max(round_pow2(max(out.live, 1) * 4, 2), f_cap)
                log.debug("post-peak downsize: frontier bucket -> %d", f)
                frontier = regrow(frontier, f)
            if checkpoint_path is not None:
                snapshot(frontier)
            continue
        # Layer cap hit without a verdict: should be impossible (each layer
        # linearizes at least one op); treat as inconclusive.
        res = CheckResult(CheckOutcome.UNKNOWN)
        break
    if checkpoint_path is not None and res.outcome != CheckOutcome.UNKNOWN:
        with contextlib.suppress(FileNotFoundError):
            os.remove(checkpoint_path)
    stats.host_syncs = SYNCS[0] - syncs0
    if collect_stats:
        res.stats = stats  # type: ignore[attr-defined]
    if sp is not None:
        sp.add(phase, t_run0, outcome=res.outcome.value, layers=stats.layers, bucket=f)
    return res


def default_device_rows_cap(device: torch.device, spill: bool) -> int:
    """:func:`check_device_auto`'s ``device_rows_cap`` when none is given,
    the JAX engine's rule: 2^23 rows on an accelerator, whose host
    round-trips are the expensive resource; on the CPU 0 (straight to the
    spill) when ``spill`` is set, else 2^23 (the tier is then the last
    conclusive rung)."""
    return 0 if device.type == "cpu" and spill else 1 << 23


def check_device_auto(
    history: History,
    *,
    beam_width: int = 65536,
    exhaustive_cap: int = 1 << 20,
    state_slots: int | None = None,
    mesh=None,
    collect_stats: bool = False,
    profile: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 512,
    witness: bool = True,
    witness_max_frontier: int = 0,
    spill: bool = True,
    spill_host_cap: int = 1 << 26,
    device_rows_cap: int | None = None,
    progress=None,
    prune: bool = False,
    speculate_depth: int = 0,
    speculate_width: int = 64,
    device=None,
) -> CheckResult:
    """Beam-first device check with exhaustive escalation (the JAX engine's
    ``check_device_auto``, same keywords plus ``device``): a beam phase of
    ``beam_width`` rows, then, if it conceded UNKNOWN, an exhaustive phase
    with an ``exhaustive_cap``-row bucket that keeps growing on the device
    up to ``device_rows_cap`` rows (:func:`default_device_rows_cap` when
    None), chunked, and past that goes on in the host-RAM spill
    (``spill=True``, the default).  ``device_rows_cap``, ``spill`` and
    ``spill_host_cap`` go to the exhaustive phase only; the other options
    to both phases.

    With ``checkpoint_path`` the beam phase snapshots to ``<path>.beam``
    and the exhaustive phase to ``<path>`` (a beam snapshot must never seed
    an exhaustive pass); a conceded beam phase leaves the marker
    ``<path>.beam.conceded`` holding the history's fingerprint, so that a
    preempted exhaustive phase does not replay the beam search on restart.
    A conclusive verdict removes the marker; an UNKNOWN keeps it beside the
    exhaustive snapshot."""
    del state_slots
    if mesh is not None:
        device = mesh.devices[0] if device is None else device
    dev = resolve_device(device)
    if device_rows_cap is None:
        device_rows_cap = default_device_rows_cap(dev, spill)
    if 0 < device_rows_cap <= exhaustive_cap:
        log.warning(
            "device_rows_cap %d <= exhaustive bucket %d: the HBM-resident "
            "tier is disabled (use 0 to disable it explicitly)",
            device_rows_cap,
            exhaustive_cap,
        )
    kw = dict(
        collect_stats=collect_stats,
        profile=profile,
        checkpoint_every=checkpoint_every,
        witness=witness,
        witness_max_frontier=witness_max_frontier,
        progress=progress,
        prune=prune,
        speculate_depth=speculate_depth,
        speculate_width=speculate_width,
        device=dev,
        mesh=mesh,
    )
    marker = f"{checkpoint_path}.beam.conceded" if checkpoint_path else None
    beam_conceded = False
    if marker is not None:
        fingerprint = history_fingerprint(encode_history(history))
        if os.path.exists(marker):
            try:
                with open(marker, encoding="utf-8") as fh:
                    beam_conceded = fh.read().strip() == fingerprint
            except OSError:
                beam_conceded = False
            if not beam_conceded:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(marker)
    if not beam_conceded:
        res = check_device(
            history,
            max_frontier=beam_width,
            beam=True,
            checkpoint_path=None if checkpoint_path is None else f"{checkpoint_path}.beam",
            **kw,
        )
        if res.outcome != CheckOutcome.UNKNOWN:
            if marker is not None:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(marker)
            return res
        if marker is not None:
            # The conceded beam phase's snapshot must not linger (it would
            # clash with the next history under this path).
            with contextlib.suppress(FileNotFoundError):
                os.remove(f"{checkpoint_path}.beam")
            with open(marker, "w", encoding="utf-8") as fh:
                fh.write(fingerprint)
    res = check_device(
        history,
        max_frontier=exhaustive_cap,
        beam=False,
        checkpoint_path=checkpoint_path,
        spill=spill,
        spill_host_cap=spill_host_cap,
        device_rows_cap=device_rows_cap,
        **kw,
    )
    if marker is not None and res.outcome != CheckOutcome.UNKNOWN:
        with contextlib.suppress(FileNotFoundError):
            os.remove(marker)
    return res


# ---------------------------------------------------------------------------
# Host-side witness recovery and diagnostics
# ---------------------------------------------------------------------------


def _host_next_cands(enc: EncodedHistory, counts):
    """Host mirror of :func:`_next_and_cands` for one counts vector."""
    c = enc.num_chains
    nxt = np.zeros(c, np.int64)
    has_next = counts < enc.chain_len
    m = INF_TIME
    for ci in range(c):
        if has_next[ci]:
            nxt[ci] = enc.chain_ops[ci, counts[ci]]
            m = min(m, int(enc.ret[nxt[ci]]))
    cand = has_next & (enc.call[nxt] < m)
    return nxt, cand


def _accept_remaining(enc: EncodedHistory, counts) -> list[int] | None:
    """The accept configuration's remaining ops in call order.  They are
    all indefinite appends (that is what accept means), and linearizing
    them in call order respects both chain order and real time; returns
    None if a remainder is not an indefinite append (never expected)."""
    is_indef = op_class_masks(enc)["is_indef"]
    remaining = [
        int(enc.chain_ops[c, k])
        for c in range(enc.num_chains)
        for k in range(int(counts[c]), int(enc.chain_len[c]))
    ]
    if not all(is_indef[j] for j in remaining):
        log.warning("witness accept state has non-indefinite remainders")
        return None
    remaining.sort(key=lambda j: int(enc.call[j]))
    return remaining


def _recover_witness_bounded(
    enc: EncodedHistory,
    history: History,
    accept_counts,
    node_budget: int = 500_000,
) -> list[int] | None:
    """Recover a linearization from the accept configuration's counts.

    A witness only needs a valid order of the ops *below* the accept
    counts, so a host Wing–Gong DFS with (counts, state) memoization over
    the sub-lattice ``counts <= accept_counts`` finds one (for the
    adversarial family: the orderings of the applied subset); the
    remaining (all-indefinite-append) ops complete the order.  Returns None
    (witness omitted) if the node budget is exhausted.
    """
    ki = enc.keep_index()
    n_chains = enc.num_chains
    target = np.asarray(accept_counts, np.int64)
    counts0 = np.asarray(enc.chain_start, np.int64)
    chain_len = np.asarray(enc.chain_len, np.int64)
    if (target < counts0).any() or (target > chain_len).any():
        log.warning("witness recovery: accept counts out of range; omitting")
        return None

    prefix_ops = [
        int(enc.chain_ops[c, k])
        for c in range(n_chains)
        for k in range(int(counts0[c]), int(target[c]))
    ]
    remaining = _accept_remaining(enc, target)
    if remaining is None:
        return None
    # Completion soundness: appending the remaining ops after the whole
    # prefix respects real time iff no remaining op returned before a
    # prefix op's call.  Reachability of the accept row guarantees it.
    if prefix_ops and remaining:
        if min(int(enc.ret[j]) for j in remaining) < max(
            int(enc.call[j]) for j in prefix_ops
        ):
            log.warning(
                "witness recovery: completion would violate real-time "
                "order; omitting"
            )
            return None

    def skey(s):
        return (s.tail, s.stream_hash, s.fencing_token)

    tt = tuple(int(x) for x in target)
    start = tuple(int(x) for x in counts0)
    parent: dict = {}
    stack = []
    for s in enc.init_states:
        key = (start, skey(s))
        if key not in parent:
            parent[key] = None
            stack.append((start, s))
    budget = node_budget
    goal_key = None
    while stack:
        counts_t, state = stack.pop()
        if counts_t == tt:
            goal_key = (counts_t, skey(state))
            break
        counts = np.asarray(counts_t, np.int64)
        nxt, cand = _host_next_cands(enc, counts)
        for c in range(n_chains):
            if not cand[c] or counts_t[c] >= tt[c]:
                continue
            j = int(nxt[c])
            op = history.ops[ki[j]]
            nct = counts_t[:c] + (counts_t[c] + 1,) + counts_t[c + 1 :]
            for ns in step_set([state], op.inp, op.out):
                key = (nct, skey(ns))
                if key in parent:
                    continue
                budget -= 1
                if budget <= 0:
                    log.warning(
                        "witness recovery exhausted its %d-node budget; "
                        "omitting witness",
                        node_budget,
                    )
                    return None
                parent[key] = ((counts_t, skey(state)), j)
                stack.append((nct, ns))
    if goal_key is None:
        log.warning(
            "witness recovery found no path to the accept configuration; "
            "omitting witness"
        )
        return None

    order: list[int] = []
    node = goal_key
    while parent[node] is not None:
        node, j = parent[node]
        order.append(j)
    order.reverse()
    order.extend(remaining)
    return list(enc.forced_prefix) + [ki[j] for j in order]


def _deepest_ops(enc: EncodedHistory, deep_counts) -> list[int]:
    """History op indices of the deepest committed row's linearized set."""
    if deep_counts is None:
        return list(enc.forced_prefix)
    out = list(enc.forced_prefix)
    keep_index = enc.keep_index()
    for c in range(enc.chain_ops.shape[0]):
        for k in range(int(deep_counts[c])):
            j = int(enc.chain_ops[c, k])
            if j >= 0:
                out.append(keep_index[j])
    return out


def _refusal_diagnostics(
    enc: EncodedHistory,
    history: History,
    rows,
    max_signatures: int = 8,
) -> list[tuple[list[int], list[int]]]:
    """Per distinct counts signature among ``rows`` (post-auto-close host
    values ``(counts, tail, hash, tok)``): the linearized prefix and the
    window-open candidate ops whose outputs that row's state refuses."""
    ki = enc.keep_index()
    reports: list[tuple[list[int], list[int]]] = []
    seen: set[tuple[int, ...]] = set()
    for counts, tail, h, tok in rows:
        counts64 = np.asarray(counts, np.int64)
        sig = tuple(int(x) for x in counts64)
        if sig in seen:
            continue
        seen.add(sig)
        state = StreamState(
            tail=int(tail) & 0xFFFFFFFF,
            stream_hash=int(h) & _M64,
            fencing_token=enc.token_of_id[int(tok)],
        )
        nxt, cand = _host_next_cands(enc, counts64)
        refused = []
        for c in np.flatnonzero(cand):
            j = int(nxt[c])
            op = history.ops[ki[j]]
            if not step_set([state], op.inp, op.out):
                refused.append(ki[j])
        prefix = _deepest_ops(enc, counts64)
        reports.append((sorted(prefix), sorted(refused)))
        if len(reports) >= max_signatures:
            break
    return reports


def _device_refusals(
    enc: EncodedHistory,
    history: History | None,
    frontier: Frontier,
    sample: int = 256,
    max_signatures: int = 8,
) -> list[tuple[list[int], list[int]]]:
    """Refusal reports from a pre-extinction frontier: compact on device,
    fetch a small row sample, diagnose host-side."""
    if history is None:
        return []
    counts_m, tail_m, h_m, tok_m, n = _compact_rows_device(frontier)
    (n,) = _fetch(n)
    m = min(n, sample)
    if m == 0:
        return []
    cm, tm, hm, km = (x[:m].cpu().numpy() for x in (counts_m, tail_m, h_m, tok_m))
    rows = [(cm[i], tm[i], hm[i], km[i]) for i in range(m)]
    return _refusal_diagnostics(enc, history, rows, max_signatures)


def _host_close(enc: EncodedHistory, counts, tail: int, tok: int, h: int | None = None, pt=None) -> list[int]:
    """Host mirror of :func:`_auto_close` for one row: advance ``counts``
    past every dead candidate (all at once per sweep) until a fixpoint, and
    return the encoded ops closed, in the order closed.

    ``pt`` (a :class:`.prune.PruneTables`) mirrors the eager commit of a
    pruned search: inert candidates close, and successful filters close
    where they pass the row's ``tail`` and, when ``h`` (the 64-bit stream
    hash) is given, its hash.  The witness replay of a ``prune=True``
    search needs it: its logged path leaves the eagerly committed ops
    out."""
    is_indef = op_class_masks(enc)["is_indef"]
    settable = {int(enc.set_token[j]) for j in range(enc.num_ops) if enc.has_set_token[j]}
    closed: list[int] = []
    while True:
        nxt, cand = _host_next_cands(enc, counts)
        dead = []
        for c in np.flatnonzero(cand):
            j = nxt[c]
            if pt is not None:
                if pt.inert[j]:
                    dead.append(c)
                    continue
                if (
                    pt.filter_succ[j]
                    and (tail & _M32) == int(enc.out_tail[j])
                    and (
                        not enc.out_has_hash[j]
                        or (
                            h is not None
                            and (h & _M64) == (int(enc.out_hash_hi[j]) << 32) | int(enc.out_hash_lo[j])
                        )
                    )
                ):
                    dead.append(c)
                    continue
            if not is_indef[j]:
                continue
            if enc.has_match[j] and tail > int(enc.match_seq[j]):
                dead.append(c)
            elif (
                enc.has_batch_token[j]
                and int(enc.batch_token[j]) not in settable
                and tok != int(enc.batch_token[j])
            ):
                dead.append(c)
        if not dead:
            return closed
        for c in dead:
            closed.append(int(nxt[c]))
        for c in dead:
            counts[c] += 1


def _witness_linearization(enc: EncodedHistory, wlogs, accept_idx: int, pt=None) -> list[int] | None:
    """A linearization from the witness log (the JAX engine's
    ``_witness_linearization``).

    Walk the per-layer ``(rows, parents, opbrs)`` log back from the accept
    row to an initial row, then replay forwards, re-running the host
    auto-close (:func:`_host_close`, with the prune tables ``pt`` of a
    pruned search) between the logged steps so that closed ops land where
    the search closed them, and finish with the accept configuration's
    remaining ops in call order (:func:`_accept_remaining`).  Returns
    ``History.ops`` indices, or None (with a warning; the caller then
    re-searches) if the log does not hold together.
    """
    path: list[int] = []  # opbr per logged layer, first to last
    r = accept_idx
    for rows, parents, opbrs in reversed(wlogs):
        i = np.searchsorted(rows, r)
        if i >= len(rows) or rows[i] != r:
            log.warning("witness log inconsistent at row %d; omitting witness", r)
            return None
        path.append(int(opbrs[i]))
        r = int(parents[i])
    path.reverse()

    states = sorted(intern_state(enc, s) for s in enc.init_states)
    if r >= len(states):
        log.warning("witness walk ended at invalid init row %d", r)
        return None
    tail, hi, lo, tok = states[r]
    h = (hi << 32) | lo
    counts = np.array(enc.chain_start, np.int64)
    order: list[int] = []

    def apply_effect(j: int) -> None:
        nonlocal tail, h, tok
        if enc.op_type[j] == 0 and not (enc.out_failure[j] and enc.out_definite[j]):
            row, ln = int(enc.rh_row[j]), int(enc.rh_len[j])
            h = fold_record_hashes(h, [(int(enc.rh_hi[row, i]) << 32) | int(enc.rh_lo[row, i]) for i in range(ln)])
            tail = (tail + int(enc.num_records[j])) & _M32
            if enc.has_set_token[j]:
                tok = int(enc.set_token[j])

    for opbr in path:
        j, br = opbr // 2, opbr % 2
        order.extend(_host_close(enc, counts, tail, tok, h=h, pt=pt))
        nxt, cand = _host_next_cands(enc, counts)
        c = int(enc.chain_of[j])
        if not cand[c] or int(nxt[c]) != j:
            log.warning("witness replay diverged at op %d; omitting witness", j)
            return None
        counts[c] += 1
        order.append(j)
        if br == 0:
            apply_effect(j)
    order.extend(_host_close(enc, counts, tail, tok, h=h, pt=pt))
    remaining = _accept_remaining(enc, counts)
    if remaining is None:
        return None
    ki = enc.keep_index()
    return list(enc.forced_prefix) + [ki[j] for j in order + remaining]


def _host_row_refusals(
    enc: EncodedHistory,
    history: History | None,
    host: np.ndarray,
    max_signatures: int = 8,
) -> list[tuple[list[int], list[int]]]:
    """Refusal reports from the spill's host frontier (the last streamed
    layer's input rows, which all died).  The rows are pre-auto-close, so
    the closure is applied before the diagnosis, as the device engine sees
    them."""
    if history is None:
        return []
    c = enc.num_chains
    rows = []
    for i in range(min(len(host), 2048)):
        counts = host[i, :c].astype(np.int64)
        tail = int(host[i, c]) & _M32
        tok = int(host[i, c + 3])
        _host_close(enc, counts, tail, tok)
        h = ((int(host[i, c + 1]) & _M32) << 32) | (int(host[i, c + 2]) & _M32)
        rows.append((counts, tail, h, tok))
    return _refusal_diagnostics(enc, history, rows, max_signatures)
