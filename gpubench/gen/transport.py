"""Transport seam between the workload clients and a concrete S2 stream.

A frozen copy of the port's ``collector/transport.py``, kept for the
benchmark's generators.

The reference's collector drives a network S2 SDK client configured from
``S2_ACCESS_TOKEN`` + optional endpoint env vars with an explicit retry
policy (rust/s2-verification/src/bin/collect-history.rs:70-94); to
collect without a network, the shipped implementation is the
in-process fault-injecting :class:`~.fake_s2.FakeS2Stream`.  The workloads
and the collector are typed against this protocol alone — a network-backed
transport (real S2 endpoint, auth, retries) slots in beside the fake as a
transport swap, no workload surgery.

The protocol is exactly the call surface the reference's op wrappers use
(history.rs:530-612 append, :409-494 read_session, :497-526 check_tail,
:618-644 pre-run scan), plus the virtual-clock attachment point the
deterministic-replay harness needs.

The client-visible **error taxonomy** lives here too, because it IS the
contract: the collector classifies failures into definite (guaranteed
side-effect-free) vs indefinite (may or may not have applied) from these
exception types (history.rs:575-592), and any transport must raise them
accordingly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

__all__ = [
    "AppendAck",
    "AppendConditionFailed",
    "CheckTailError",
    "DefiniteServerError",
    "IndefiniteServerError",
    "ReadError",
    "S2StreamTransport",
]


class AppendConditionFailed(Exception):
    """match_seq_num or fencing-token precondition failed (definite)."""


class DefiniteServerError(Exception):
    """Server error with a no-side-effect error code (definite)."""


class IndefiniteServerError(Exception):
    """Ambiguous error: the append may or may not have applied."""


class ReadError(Exception):
    pass


class CheckTailError(Exception):
    pass


@dataclass
class AppendAck:
    #: Sequence number one past the last appended record (ack.end.seq_num).
    tail: int


@runtime_checkable
class S2StreamTransport(Protocol):
    """The five stream calls the collector layer makes."""

    #: virtual clock for deterministic interleaving (attached by the
    #: collector); None = real time
    clock: object | None

    async def append(
        self,
        bodies: list[bytes],
        *,
        match_seq_num: int | None = None,
        fencing_token: str | None = None,
        set_fencing_token: str | None = None,
    ) -> AppendAck:
        """Atomically append a batch; raise per the error taxonomy above."""
        ...

    async def read_all(self) -> list[bytes]:
        """Read every record body from seq 0 through the tail
        (``read_session`` + full fold, history.rs:409-494)."""
        ...

    async def check_tail(self) -> int:
        """Report the tail only (history.rs:497-526)."""
        ...

    def snapshot_bodies(self) -> list[bytes]:
        """Fault-free full scan for setup paths (the reference retries its
        pre-run scan up to 1024 times, collect-history.rs:72-75)."""
        ...
