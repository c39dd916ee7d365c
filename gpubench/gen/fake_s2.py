"""An in-process, fault-injecting S2-compatible stream service.

A frozen copy of the port's ``collector/fake_s2.py``, kept for the
benchmark's generators.

The reference collects histories against the live S2 service (or s2-lite),
with fault injection supplied externally by Antithesis/turmoil
(README.md:5,151-176).  To collect without a network, the framework
ships a deterministic in-process stand-in: the same append/read/check_tail
surface with ``match_seq_num`` + fencing-token semantics
(rust/s2-verification/src/history.rs:530-612 describes the client-visible
error taxonomy), plus seeded fault injection that produces exactly the error
classes the collector distinguishes:

- **definite failures** — condition failures (seq-num/token mismatch) and
  injected "rate_limited"-style errors; guaranteed side-effect-free;
- **indefinite failures** — injected ambiguous errors where the append may or
  may not have become durable (the coin is flipped internally and never
  revealed to the client).

All randomness flows through one seeded ``random.Random``, and latency
sleeps go through the collector's :class:`~.clock.VirtualClock` when one is
attached, so runs are *byte-replayable* — the interleaving is a function of
the seeds alone, mirroring the reference's AntithesisRng + turmoil DST
discipline (history.rs:58,140; README.md:5).
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field

from .hashing import record_hash
from .clock import vsleep

# The client-visible contract types live in the transport seam
# (re-exported here for compatibility): any transport implementation
# raises the same taxonomy the collector classifies on.
from .transport import (
    AppendAck,
    AppendConditionFailed,
    CheckTailError,
    DefiniteServerError,
    IndefiniteServerError,
    ReadError,
)

log = logging.getLogger("gpubench.gen.fake_s2")

__all__ = [
    "AppendConditionFailed",
    "DefiniteServerError",
    "IndefiniteServerError",
    "ReadError",
    "CheckTailError",
    "FaultPlan",
    "AppendAck",
    "FakeS2Stream",
]


@dataclass
class FaultPlan:
    """Injection probabilities and latency envelope (seconds)."""

    p_append_definite: float = 0.0
    p_append_indefinite: float = 0.0
    #: Given an indefinite failure, probability the append secretly applied.
    p_indefinite_applied: float = 0.5
    p_read_fail: float = 0.0
    p_check_tail_fail: float = 0.0
    min_latency: float = 0.0
    max_latency: float = 0.0

    @classmethod
    def chaos(cls, intensity: float = 0.2, max_latency: float = 0.002) -> "FaultPlan":
        return cls(
            p_append_definite=intensity * 0.5,
            p_append_indefinite=intensity,
            p_read_fail=intensity * 0.5,
            p_check_tail_fail=intensity * 0.5,
            max_latency=max_latency,
        )


@dataclass
class _Record:
    body: bytes


@dataclass
class FakeS2Stream:
    """One stream's authoritative state plus the fault-injection harness."""

    rng: random.Random = field(default_factory=lambda: random.Random(0))
    faults: FaultPlan = field(default_factory=FaultPlan)
    records: list[_Record] = field(default_factory=list)
    fencing_token: str | None = None
    #: virtual clock for deterministic interleaving (set by the collector);
    #: None falls back to real asyncio.sleep
    clock: object | None = None

    async def _latency(self) -> None:
        lo, hi = self.faults.min_latency, self.faults.max_latency
        if hi > 0:
            await vsleep(self.clock, self.rng.uniform(lo, hi))

    @property
    def tail(self) -> int:
        return len(self.records)

    # -- operations ---------------------------------------------------------

    async def append(
        self,
        bodies: list[bytes],
        *,
        match_seq_num: int | None = None,
        fencing_token: str | None = None,
        set_fencing_token: str | None = None,
    ) -> AppendAck:
        """Atomically append a batch; raises per the collector's error taxonomy.

        ``set_fencing_token`` models the fence command record: its single
        record's body is the token bytes, and applying it replaces the
        stream's token.
        """
        await self._latency()
        # Fault injection is decided at the serialization point so that the
        # secret applied/not-applied coin is part of the atomic step.
        r = self.rng.random()
        if r < self.faults.p_append_definite:
            log.debug("inject: definite append failure (rate_limited)")
            await self._latency()
            raise DefiniteServerError("rate_limited")
        if r < self.faults.p_append_definite + self.faults.p_append_indefinite:
            applied = (
                self._preconditions_hold(match_seq_num, fencing_token)
                and self.rng.random() < self.faults.p_indefinite_applied
            )
            if applied:
                self._apply(bodies, set_fencing_token)
            log.debug(
                "inject: indefinite append failure (secretly applied=%s)", applied
            )
            await self._latency()
            raise IndefiniteServerError("deadline_exceeded")
        if not self._preconditions_hold(match_seq_num, fencing_token):
            await self._latency()
            raise AppendConditionFailed(
                f"match_seq_num={match_seq_num} token={fencing_token!r} "
                f"vs tail={self.tail} stream_token={self.fencing_token!r}"
            )
        ack = AppendAck(tail=self._apply(bodies, set_fencing_token))
        await self._latency()
        return ack

    def _preconditions_hold(
        self, match_seq_num: int | None, fencing_token: str | None
    ) -> bool:
        if match_seq_num is not None and match_seq_num != self.tail:
            return False
        if fencing_token is not None and fencing_token != self.fencing_token:
            return False
        return True

    def _apply(self, bodies: list[bytes], set_fencing_token: str | None) -> int:
        self.records.extend(_Record(b) for b in bodies)
        if set_fencing_token is not None:
            self.fencing_token = set_fencing_token
        return self.tail

    async def read_all(self) -> list[bytes]:
        """Read every record body from the head (seq 0) through the tail."""
        await self._latency()
        if self.rng.random() < self.faults.p_read_fail:
            log.debug("inject: read failure")
            raise ReadError("stream reset")
        bodies = [r.body for r in self.records]
        await self._latency()
        return bodies

    async def check_tail(self) -> int:
        await self._latency()
        if self.rng.random() < self.faults.p_check_tail_fail:
            log.debug("inject: check_tail failure")
            raise CheckTailError("unavailable")
        t = self.tail
        await self._latency()
        return t

    def snapshot_bodies(self) -> list[bytes]:
        """Fault-free read of every record body, for setup paths.

        The reference's setup client retries up to 1024 times so its pre-run
        full-stream scan effectively always succeeds (collect-history.rs:72-75);
        this is the equivalent shortcut.
        """
        return [r.body for r in self.records]

    # -- introspection for tests -------------------------------------------

    def true_stream_hashes(self) -> list[int]:
        return [record_hash(r.body) for r in self.records]
