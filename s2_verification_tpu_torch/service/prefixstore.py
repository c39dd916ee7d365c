"""Durable chain-hash-keyed prefix store: resume searches instead of re-running.

The port's copy of the JAX package's ``service/prefixstore.py``: the same
keys, entries and segment log, so a ``<state_dir>/prefix`` either
package's daemon wrote is read and continued by the other's.

The verdict cache (service/cache.py) only helps on byte-identical
histories; this store memoizes the *search itself* at prefix-closed op
boundaries (checker/prefix.py) so window N+1 of a live stream resumes
from window N's decided frontier.  The same chain-hash fold that names
full histories names prefixes: the key of cut K is the fingerprint fold's
intermediate accumulator after K ops::

    p{version}:{acc:016x}:{K}

``acc`` commits to every op of the prefix (canon, order, real-time
window), so two histories share a key exactly when they prepare to the
same first K ops — extensions of a stream probe with their own fold's
intermediates and hit whatever some earlier job snapshotted.  Keys from
``follow`` windows are computed with each window's ops re-based to
absolute event indices (the window's offset is carried in the entry), so
a follow lineage's keys coincide with the keys a one-shot submit of the
concatenated history would compute — warm state is shared across both
paths, across jobs, and (the store being node-local) across boots.

Persistence mirrors the verdict cache: an in-memory LRU spilled to a
CRC-checked segment log (utils/seglog.py) under ``<state_dir>/prefix/``,
replayed at boot (torn tails and corrupt segments recover to a valid
prefix — a lost snapshot costs a cold search, never a wrong verdict),
disk bounded by segment rotation so old prefixes age out with their
segment.

Soundness: an entry is only ever written from a completed snapshot cut of
an OK search (checker/frontier.py refuses cuts touched by pruning;
checker/prefix.py refuses boundaries crossed by in-flight ops), and
:meth:`PrefixStore.put` re-validates the shape.  Resuming from an entry
is then verdict-equivalent to the cold search (``tests/test_torch_prefix.py``
holds warm against cold).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

from ..checker.entries import History
from ..checker.prefix import (
    PrefixCarry,
    boundary_counts,
    choose_cuts,
    closed_boundaries,
    has_open_ops,
)
from ..utils.hashing import chain_hash
from ..utils.seglog import Recovery, SegmentLog
from .cache import _FP_VERSION, _op_digest

__all__ = [
    "PrefixPlan",
    "PrefixStore",
    "affinity_key",
    "parse_prefix_key",
    "plan_for_submit",
    "plan_for_window",
    "prefix_accumulators",
    "prefix_key",
    "read_cold",
]

log = logging.getLogger("s2_verification_tpu_torch.verifyd")

#: subdirectory of ``--state-dir`` holding the segment log
PREFIX_SUBDIR = "prefix"


def prefix_key(acc: int, ops: int) -> str:
    """Wire/store key of the cut after ``ops`` cumulative ops.

    The ``p`` prefix keeps the namespace disjoint from verdict-cache
    fingerprints (``v2:...``) — a window job's "fingerprint" is its cut
    key, and it must never collide with a real full-history fingerprint.
    """
    return f"p{_FP_VERSION}:{acc & 0xFFFFFFFFFFFFFFFF:016x}:{ops}"


def parse_prefix_key(key: str) -> tuple[int, int]:
    """(accumulator, cumulative ops) of a store key; raises ValueError."""
    ver, acc, ops = key.split(":")
    if ver != f"p{_FP_VERSION}":
        raise ValueError(f"prefix key version mismatch: {key!r}")
    return int(acc, 16), int(ops)


def prefix_accumulators(
    hist: History,
    cuts: Sequence[int] | None = None,
    *,
    acc: int = 0,
    ops_base: int = 0,
    event_offset: int = 0,
) -> dict[int, str]:
    """Fold the fingerprint canon over ``hist.ops``; return ``{local cut K
    -> store key}`` for each requested cut (default: every closed
    boundary).

    ``acc``/``ops_base``/``event_offset`` continue a follow lineage: the
    fold starts from the previous window's accumulator and each op's
    call/ret are re-based to absolute event indices, so the resulting keys
    equal the ones a cold fold over the concatenated history would
    produce.
    """
    want = set(cuts) if cuts is not None else set(closed_boundaries(hist))
    out: dict[int, str] = {}
    if not want:
        return out
    top = max(want)
    for i, op in enumerate(hist.ops):
        if i >= top:
            break
        if event_offset:
            op = dataclasses.replace(
                op, call=op.call + event_offset, ret=op.ret + event_offset
            )
        acc = chain_hash(acc, _op_digest(op))
        k = i + 1
        if k in want:
            out[k] = prefix_key(acc, ops_base + k)
    return out


def affinity_key(hist: History, fingerprint: str) -> str:
    """Ring placement key for a prepared history.

    The verdict fingerprint changes whenever a single op is appended, so
    fingerprint-keyed placement scatters a growing stream's
    resubmissions across the fleet — every extension lands cold, away
    from the node holding its prefix snapshots.  Keying the ring by the
    chain-hash accumulator at the history's *first* closed boundary is
    stable under extension (appended ops only deepen the suffix), so the
    whole lineage — and its ``follow`` windows, which reuse the same
    chain-hash namespace — homes on one node.  Identical texts still
    collide (same first boundary), preserving verdict-cache affinity.
    Histories with no closed boundary short of the end fall back to the
    fingerprint.

    This is the fleet router's placement function; anything predicting a
    job's home node must use it too, never the raw fingerprint.
    """
    bounds = closed_boundaries(hist)
    cuts = [k for k in bounds if k < len(hist.ops)]
    if not cuts:
        return fingerprint
    keys = prefix_accumulators(hist, [cuts[0]])
    return keys.get(cuts[0], fingerprint)


def make_entry(
    carry: PrefixCarry,
    *,
    events: int,
    stream: str | None = None,
    window: int | None = None,
) -> dict:
    """Store-entry payload for one snapshot cut.

    ``events`` is the absolute event horizon of the cut — the offset the
    next follow window folds from.  ``stream``/``window`` label follow
    lineages for doctor post-mortems; submit-lineage entries omit them.
    """
    entry = dict(carry.to_payload())
    entry["e"] = int(events)
    if stream is not None:
        entry["stream"] = stream
    if window is not None:
        entry["w"] = int(window)
    return entry


@dataclass
class PrefixPlan:
    """Everything the scheduler needs to run one prefix-aware search.

    ``kind`` is ``"extend"`` (a full history that probed the store; the
    search covers all of ``hist.ops`` and may resume at ``carry.ops``) or
    ``"window"`` (a follow delta; the search history is the standalone
    suffix, counts start at zero, and the verdict is window-scoped — it
    must never enter the verdict cache or the router edge cache).
    """

    kind: str
    carry: PrefixCarry | None = None
    #: per-chain counts at the resume cut, within the search history
    #: (``"extend"`` only; window searches start every chain at zero)
    resume_counts: tuple[int, ...] | None = None
    #: local cut K (within the search history) -> store key to write on OK
    snap_keys: dict[int, str] = field(default_factory=dict)
    #: cumulative ops committed before this search's op 0 (window lineage)
    base_ops: int = 0
    #: absolute event horizon before this search's event 0
    base_events: int = 0
    #: events in this search's own history (set at admission; the horizon
    #: of the final cut, where ``ops[K].call`` does not exist)
    total_events: int = 0
    stream: str | None = None
    window: int | None = None
    #: closed boundaries probed (diagnostics for the prefix_{hit,miss} events)
    probed: int = 0
    #: why snapshotting was refused, when it was (e.g. ``"open_ops"``)
    refused: str | None = None

    @property
    def resume_ops(self) -> int:
        return self.carry.ops if self.carry is not None else 0


def plan_for_submit(
    store: "PrefixStore | None",
    hist: History,
    *,
    max_cuts: int = 8,
    min_ops: int = 4,
) -> PrefixPlan | None:
    """Probe the store for the longest cached prefix of a full history and
    pick the cuts worth snapshotting past it.  Returns ``None`` when the
    history is too small to bother (the plan itself routes the job onto
    the host frontier path, so tiny histories stay on the native engine).
    """
    if store is None or len(hist.ops) < min_ops:
        return None
    keys = prefix_accumulators(hist)
    if not keys:
        return None
    open_ops = has_open_ops(hist)
    if open_ops:
        # The K = num_ops boundary is only *geometrically* closed when ops
        # are pending; their outcome is undecided and must not be carried.
        keys.pop(len(hist.ops), None)
        if not keys:
            return None
    plan = PrefixPlan(kind="extend", probed=len(keys))
    hit_k = 0
    by_depth = sorted(keys, reverse=True)
    entry = store.probe([keys[k] for k in by_depth])
    if entry is not None:
        key, payload = entry
        try:
            carry = PrefixCarry.from_payload(payload)
        except (ValueError, KeyError, TypeError):
            carry = None  # foreign/corrupt entry: treat as a miss
        if carry is not None and keys.get(carry.ops) == key:
            hit_k = carry.ops
            plan.carry = carry
            plan.resume_counts = boundary_counts(hist, hit_k)
    snap_cuts = [k for k in choose_cuts(hist, max_cuts) if k > hit_k and k in keys]
    plan.snap_keys = {k: keys[k] for k in snap_cuts}
    if open_ops:
        plan.refused = "open_ops"
    return plan


def plan_for_window(
    hist: History,
    *,
    token: str | None,
    entry: dict | None,
    stream: str,
) -> PrefixPlan:
    """Build the plan for one follow window (the standalone suffix).

    ``token``/``entry`` are the previous window's store key and payload
    (both ``None`` for the first window).  The only snapshot cut is the
    window's end; it is refused when the window has in-flight ops — the
    client must resend those events once their finishes arrive.
    """
    acc, base_ops, base_events, window = 0, 0, 0, 0
    carry = None
    if token is not None:
        acc, base_ops = parse_prefix_key(token)
        assert entry is not None
        carry = PrefixCarry.from_payload(entry)
        if carry.ops != base_ops:
            raise ValueError("frontier token does not match its entry")
        base_events = int(entry.get("e", 0))
        window = int(entry.get("w", -1)) + 1
    plan = PrefixPlan(
        kind="window",
        carry=carry,
        base_ops=base_ops,
        base_events=base_events,
        stream=stream,
        window=window,
    )
    n = len(hist.ops)
    if has_open_ops(hist):
        plan.refused = "open_ops"
    elif n > 0:
        keys = prefix_accumulators(
            hist, [n], acc=acc, ops_base=base_ops, event_offset=base_events
        )
        plan.snap_keys = {n: keys[n]}
    else:
        # An all-trivial window: nothing to search, but the event horizon
        # still advances — re-key the carry at the same cut.
        plan.snap_keys = {0: token} if token is not None else {}
    return plan


class PrefixStore:
    """Thread-safe LRU of cut key → carried frontier state, spilled to a
    segment log so restarts resume from the last durable snapshot."""

    def __init__(
        self,
        capacity: int = 2048,
        persist_dir: str | None = None,
        *,
        fsync: bool = False,
        max_segments: int = 8,
        writer=None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"prefix capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.writer = writer
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, dict] = OrderedDict()
        self._sizes: dict[str, int] = {}
        self._bytes = 0
        self._log: SegmentLog | None = None
        self.hits = 0
        self.misses = 0
        self.loaded = 0  #: entries replayed from disk at construction
        self.recovery: Recovery | None = None
        if persist_dir is not None:
            self._log = SegmentLog(
                persist_dir, fsync=fsync, max_segments=max_segments
            )
            for payload in self._log.replay():
                try:
                    rec = json.loads(payload)
                    key, value = rec["k"], rec["p"]
                except (ValueError, KeyError, TypeError):
                    continue  # CRC-intact but foreign: skip, never crash
                if isinstance(key, str) and isinstance(value, dict):
                    self._set(key, value, len(payload))
            while len(self._entries) > self.capacity:
                self._evict_oldest()
            self.loaded = len(self._entries)
            self.recovery = self._log.recovery

    def _set(self, key: str, value: dict, size: int) -> None:
        self._bytes -= self._sizes.get(key, 0)
        self._entries[key] = value
        self._entries.move_to_end(key)
        self._sizes[key] = size
        self._bytes += size

    def _evict_oldest(self) -> None:
        key, _ = self._entries.popitem(last=False)
        self._bytes -= self._sizes.pop(key, 0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, key: str) -> dict | None:
        """One entry, LRU-touched and hit/miss-counted."""
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                return None
            self.hits += 1
            self._entries.move_to_end(key)
            return dict(value)

    def probe(self, keys: Sequence[str]) -> tuple[str, dict] | None:
        """First hit among ``keys`` (callers order deepest-first); counted
        as a single hit or miss regardless of how many cuts were probed."""
        with self._lock:
            for key in keys:
                value = self._entries.get(key)
                if value is not None:
                    self.hits += 1
                    self._entries.move_to_end(key)
                    return key, dict(value)
            self.misses += 1
            return None

    def put(self, key: str, entry: dict) -> None:
        """Record one snapshot cut; validates the carried shape first."""
        if not entry.get("s") or int(entry.get("n", 0)) < 0:
            raise ValueError(f"refusing malformed prefix entry for {key!r}")
        record = json.dumps({"k": key, "p": entry}, separators=(",", ":")).encode(
            "utf-8"
        )
        with self._lock:
            self._set(key, dict(entry), len(record))
            while len(self._entries) > self.capacity:
                self._evict_oldest()
            if self._log is not None:
                if self.writer is not None:
                    try:
                        self.writer.run(lambda: self._log.append(record))
                    except ValueError:
                        log.exception("prefix-store spill failed; disabling")
                        self._log = None
                    return
                try:
                    self._log.append(record)
                except (OSError, ValueError):
                    # Spill is best-effort: a full disk must not fail jobs.
                    log.exception("prefix-store spill failed; disabling")
                    self._log = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "loaded": self.loaded,
            }

    def close(self) -> None:
        if self._log is not None:
            self._log.close()


def read_cold(state_dir: str) -> dict | None:
    """Post-mortem view of a dead daemon's prefix store (doctor).

    Replays the segment log without opening it for writing; returns
    ``None`` when the directory has no prefix log at all.
    """
    directory = os.path.join(state_dir, PREFIX_SUBDIR)
    if not os.path.isdir(directory):
        return None
    slog = SegmentLog(directory)
    entries: dict[str, dict] = {}
    sizes: dict[str, int] = {}
    for payload in slog.replay():
        try:
            rec = json.loads(payload)
            key, value = rec["k"], rec["p"]
        except (ValueError, KeyError, TypeError):
            continue
        if isinstance(key, str) and isinstance(value, dict):
            entries[key] = value
            sizes[key] = len(payload)
    total = sum(sizes.values())
    streams: dict[str, dict] = {}
    deepest = 0
    for value in entries.values():
        deepest = max(deepest, int(value.get("n", 0)))
        stream = value.get("stream")
        if isinstance(stream, str):
            cur = streams.get(stream)
            if cur is None or int(value.get("n", 0)) >= cur["ops"]:
                streams[stream] = {
                    "ops": int(value.get("n", 0)),
                    "window": value.get("w"),
                    "events": int(value.get("e", 0)),
                }
    rec = slog.recovery
    return {
        "entries": len(entries),
        "bytes": total,
        "deepest_ops": deepest,
        "streams": streams,
        "recovery": {
            "records": rec.records,
            "segments": rec.segments,
            "torn_tail_bytes": rec.torn_tail_bytes,
            "bad_segments": rec.bad_segments,
        },
    }
