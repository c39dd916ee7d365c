"""CRC-checked append-only segment log: verifyd's durable-state primitive.

Both pieces of daemon state that must survive a crash — the verdict cache
(``service/cache.py``) and the admission journal (``service/journal.py``)
— are streams of small records with identical failure semantics, so they
share one storage discipline.  A log is a directory of numbered segment
files (``seg-00000001.log`` ...); each record is

    <u32 payload length> <u32 crc32(payload)> <payload bytes>

appended and flushed immediately (a flush survives SIGKILL of the
process; ``fsync=True`` additionally survives the machine).

Recovery mirrors the definite/indefinite taxonomy the collector applies
to the network (collect-history.rs:70-94): a record either replays
**definitely intact** (length and CRC agree) or it — and everything after
it in that segment, which is unframed garbage once one header is wrong —
is dropped and *counted*:

- **torn write**: the process died mid-append, so the final segment ends
  in a partial record.  Replay keeps the valid prefix and reports the
  dropped tail bytes.
- **corrupted segment**: a CRC mismatch mid-file (bit rot, concurrent
  writer).  Replay keeps that segment's valid prefix, skips its remainder,
  and continues with the *next* segment — one bad segment never poisons
  the others.

A writer never appends to a damaged segment (appending after garbage
would be unreadable forever): it rotates to a fresh one and leaves the
damaged file for replay's prefix recovery.  One process per log
(single-writer; the daemon holds it for its lifetime).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import struct
import threading
import zlib
from typing import Iterable, Iterator

__all__ = ["Recovery", "SegmentLog"]

_HDR = struct.Struct("<II")  # payload length, crc32(payload)
_SEG_RE = re.compile(r"^seg-(\d{8})\.log$")
_MAX_RECORD = 64 << 20  # a length field past this is corruption, not data


@dataclasses.dataclass
class Recovery:
    """What the last :meth:`SegmentLog.replay` found on disk."""

    records: int = 0  #: intact records yielded
    segments: int = 0  #: segment files scanned
    torn_tail_bytes: int = 0  #: bytes dropped after the final segment's last intact record
    bad_segments: int = 0  #: segments with a mid-file CRC/header failure
    dropped_records_possible: bool = False  #: any bytes at all were skipped


def _seg_name(index: int) -> str:
    return f"seg-{index:08d}.log"


def _scan(path: str) -> tuple[list[bytes], int, int]:
    """Read one segment: (intact payloads, valid-prefix end offset, file size)."""
    payloads: list[bytes] = []
    offset = 0
    with open(path, "rb") as f:
        data = f.read()
    size = len(data)
    while offset + _HDR.size <= size:
        length, crc = _HDR.unpack_from(data, offset)
        if length > _MAX_RECORD or offset + _HDR.size + length > size:
            break  # torn header/payload (or a corrupt length field)
        payload = data[offset + _HDR.size : offset + _HDR.size + length]
        if zlib.crc32(payload) != crc:
            break  # corruption: everything after is unframed
        payloads.append(payload)
        offset += _HDR.size + length
    return payloads, offset, size


class SegmentLog:
    def __init__(
        self,
        directory: str,
        *,
        max_segment_bytes: int = 4 << 20,
        max_segments: int | None = None,
        fsync: bool = False,
    ) -> None:
        self.dir = directory
        self.max_segment_bytes = max_segment_bytes
        #: cap on retained segments (oldest dropped on rotation) — bounded
        #: disk for cache-like logs; ``None`` keeps everything (journals
        #: compact explicitly instead).
        self.max_segments = max_segments
        self.fsync = fsync
        self.recovery = Recovery()
        self._lock = threading.Lock()
        self._fh = None  # type: ignore[assignment]
        self._fh_index = 0
        self._fh_size = 0
        os.makedirs(directory, exist_ok=True)

    # -- reading ------------------------------------------------------------

    def _segment_indices(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _SEG_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def replay(self) -> Iterator[bytes]:
        """Yield every intact payload in write order; sets :attr:`recovery`."""
        rec = Recovery()
        indices = self._segment_indices()
        rec.segments = len(indices)
        for pos, idx in enumerate(indices):
            payloads, valid_end, size = _scan(os.path.join(self.dir, _seg_name(idx)))
            rec.records += len(payloads)
            if valid_end < size:
                rec.dropped_records_possible = True
                if pos == len(indices) - 1:
                    rec.torn_tail_bytes += size - valid_end
                else:
                    rec.bad_segments += 1
            yield from payloads
        self.recovery = rec

    def replay_all(self) -> list[bytes]:
        return list(self.replay())

    # -- writing ------------------------------------------------------------

    def _open_tail(self) -> None:
        """Position the writer: append to the last segment when it is
        intact and under the size cap, otherwise rotate to a fresh one."""
        indices = self._segment_indices()
        last = indices[-1] if indices else 0
        if last:
            path = os.path.join(self.dir, _seg_name(last))
            _, valid_end, size = _scan(path)
            if valid_end == size and size < self.max_segment_bytes:
                self._fh = open(path, "ab")
                self._fh_index, self._fh_size = last, size
                return
        self._start_segment(last + 1)

    def _start_segment(self, index: int) -> None:
        self._fh = open(os.path.join(self.dir, _seg_name(index)), "ab")
        self._fh_index, self._fh_size = index, 0
        if self.max_segments is not None:
            for idx in self._segment_indices()[: -self.max_segments]:
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(self.dir, _seg_name(idx)))

    def append(self, payload: bytes) -> None:
        with self._lock:
            if self._fh is None:
                self._open_tail()
            elif self._fh_size >= self.max_segment_bytes:
                self._fh.close()
                self._start_segment(self._fh_index + 1)
            blob = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
            self._fh.write(blob)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._fh_size += len(blob)

    def rewrite(self, payloads: Iterable[bytes]) -> None:
        """Compact: replace every segment with one fresh segment holding
        ``payloads``.  Crash-ordered — the new segment is fsynced and
        renamed into place before the old ones are removed, so an
        interrupted compaction leaves duplicates (at-least-once), never a
        hole."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            old = self._segment_indices()
            new_index = (old[-1] if old else 0) + 1
            final = os.path.join(self.dir, _seg_name(new_index))
            tmp = f"{final}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                for payload in payloads:
                    f.write(_HDR.pack(len(payload), zlib.crc32(payload)) + payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            for idx in old:
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(self.dir, _seg_name(idx)))

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
