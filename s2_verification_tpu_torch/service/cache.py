"""Verdict cache: resubmitted histories are answered in O(1).

The key is the canonical chain-hash fingerprint of the *prepared* history
(``utils/hashing.py`` over ``checker/entries.prepare`` output): each
search-relevant op is serialized to a canonical byte string and folded
through the same ``chain_hash`` protocol the stream model itself uses, so
byte-identical resubmissions — and re-collections that prepare to the
same op sequence — share a key.  Trivial (elided) ops are deliberately
excluded: they cannot change a verdict (entries.py docstring), so two
histories differing only in definite failures share the cached answer.

The cached value is the full reply payload (verdict, outcome, backend,
artifact path), so a hit costs one dict lookup — no backend, no build,
no search.

With ``persist_dir`` set, every put also appends one record to a
CRC-checked segment log (``utils/seglog.py``): a restarted daemon replays the
segments at startup and answers previously decided fingerprints without
invoking a checker.  Torn final records and corrupted segments recover
to a valid prefix (a lost verdict costs a re-search, never a wrong
answer).  Disk is bounded by segment rotation (oldest verdicts age out
with their segment — it is a cache on disk too).  Cached artifact paths
may dangle after a restart; the verdict fields are what durability is
for.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
from collections import OrderedDict

from ..checker.entries import History, Op
from ..utils.hashing import chain_hash, record_hash
from ..utils.seglog import Recovery, SegmentLog

__all__ = ["history_fingerprint", "VerdictCache"]

log = logging.getLogger("s2_verification_tpu_torch.verifyd")

#: v1 folded f-string reprs of the op dataclasses (~0.4 ms per
#: collector-sized history — measurable at batched-admission rates); v2
#: packs the same fields with ``struct`` for an ~8x cheaper canon.  The
#: version prefix keys persisted verdict segments, so bumping it simply
#: cold-starts the durable cache — no migration, no wrong answers.
_FP_VERSION = "v2"

#: Fixed-width op head: client_id, call, ret, flags, input_type,
#: match_seq_num, num_records, tail, stream_hash, len(record_hashes).
#: Optional ints encode as 0 with a presence bit in ``flags`` so 0 and
#: absent stay distinct.
_OP_HEAD = struct.Struct("<QqqBBqqqQI")


def _op_canon(op: Op) -> bytes:
    inp, out = op.inp, op.out
    flags = (
        (1 if op.pending else 0)
        | (2 if out.failure else 0)
        | (4 if out.definite_failure else 0)
        | (8 if inp.match_seq_num is not None else 0)
        | (16 if inp.num_records is not None else 0)
        | (32 if out.tail is not None else 0)
        | (64 if out.stream_hash is not None else 0)
    )
    head = _OP_HEAD.pack(
        op.client_id,
        op.call,
        op.ret,
        flags,
        inp.input_type,
        inp.match_seq_num or 0,
        inp.num_records or 0,
        out.tail or 0,
        out.stream_hash or 0,
        len(inp.record_hashes),
    )
    if inp.record_hashes:
        hashes = struct.pack(f"<{len(inp.record_hashes)}Q", *inp.record_hashes)
    else:
        hashes = b""
    toks = []
    for tok in (inp.set_fencing_token, inp.batch_fencing_token):
        if tok is None:
            toks.append(b"\xff")  # distinct from any length prefix (b"\x00")
        else:
            tb = tok.encode("utf-8")
            toks.append(b"\x00" + struct.pack("<I", len(tb)) + tb)
    return b"".join((head, hashes, *toks))


def _op_digest(op: Op) -> int:
    """xxh3 of one op's canonical serialization (with the repr fallback).

    Shared by the full-history fold below and the per-cut prefix
    accumulators in service/prefixstore.py, which must fold the exact same
    per-op digests so a prefix key computed incrementally matches one
    computed from the full history.
    """
    try:
        canon = _op_canon(op)
    except struct.error:
        # client_id past u64 or a similarly absurd-but-decodable value:
        # fall back to the deterministic repr canon for this op.
        canon = (
            f"{op.client_id}|{op.call}|{op.ret}|{op.pending}|"
            f"{op.inp!r}|{op.out!r}"
        ).encode("utf-8")
    return record_hash(canon)


def history_fingerprint(hist: History) -> str:
    """Canonical chain-hash fingerprint of a prepared history.

    Folds the xxh3 of each op's canonical serialization (chain identity,
    real-time window, input, output, pending-completion flag) through
    ``chain_hash`` in op order — the same left-fold discipline as the
    stream-hash protocol.  Everything the verdict depends on is covered:
    op semantics via ``inp``/``out``, real-time order via ``call``/``ret``,
    chain structure via ``client_id``.  The encoding is injective: the op
    head is fixed-width, the record-hash block's length is in the head,
    and fencing tokens are length-prefixed with a distinct None marker.
    """
    acc = 0
    for op in hist.ops:
        acc = chain_hash(acc, _op_digest(op))
    return f"{_FP_VERSION}:{acc:016x}:{len(hist.ops)}"


class VerdictCache:
    """Thread-safe LRU of fingerprint → reply payload, optionally spilled
    to an append-only segment log so restarts answer duplicates warm."""

    def __init__(
        self,
        capacity: int = 4096,
        persist_dir: str | None = None,
        *,
        fsync: bool = False,
        max_segments: int = 8,
        writer=None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        #: optional overload.DegradedWriter: spill failures then degrade to
        #: memory-only with counters and re-arm when the disk recovers,
        #: instead of the legacy permanently-disable-on-first-error policy.
        self.writer = writer
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, dict] = OrderedDict()
        self._log: SegmentLog | None = None
        self.loaded = 0  #: entries replayed from disk at construction
        self.recovery: Recovery | None = None
        if persist_dir is not None:
            self._log = SegmentLog(
                persist_dir, fsync=fsync, max_segments=max_segments
            )
            for payload in self._log.replay():
                try:
                    rec = json.loads(payload)
                    fp, value = rec["fp"], rec["p"]
                except (ValueError, KeyError, TypeError):
                    continue  # CRC-intact but foreign: skip, never crash
                if isinstance(fp, str) and isinstance(value, dict):
                    self._entries[fp] = value
                    self._entries.move_to_end(fp)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            self.loaded = len(self._entries)
            self.recovery = self._log.recovery

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, fingerprint: str) -> dict | None:
        with self._lock:
            payload = self._entries.get(fingerprint)
            if payload is not None:
                self._entries.move_to_end(fingerprint)
                return dict(payload)
            return None

    def put(self, fingerprint: str, payload: dict) -> None:
        with self._lock:
            self._entries[fingerprint] = dict(payload)
            self._entries.move_to_end(fingerprint)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            if self._log is not None:
                record = json.dumps(
                    {"fp": fingerprint, "p": payload}, separators=(",", ":")
                ).encode("utf-8")
                if self.writer is not None:
                    # Spill is best-effort: ENOSPC degrades to memory-only
                    # (counted + evented) and recovery re-arms the log.
                    try:
                        self.writer.run(lambda: self._log.append(record))
                    except ValueError:
                        log.exception("verdict-cache spill failed; disabling")
                        self._log = None
                    return
                try:
                    self._log.append(record)
                except (OSError, ValueError):
                    # Spill is best-effort: a full disk must not fail jobs.
                    log.exception("verdict-cache spill failed; disabling")
                    self._log = None

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
