"""Workload clients: concurrent op generators that record the history.

A frozen copy of the port's ``collector/workloads.py``, kept for the
benchmark's generators.

Re-expresses the reference collector's three workflows
(rust/s2-verification/src/history.rs):

- ``regular`` (history.rs:356-406): unguarded appends + reads + check-tails.
- ``match-seq-num`` (history.rs:289-347): every append guarded by
  ``match_seq_num`` from the client's latest observed tail, so races surface
  as definite failures.
- ``fencing`` (history.rs:181-280): a per-client unique token; every 100th op
  (including the 0th) fences the stream via a guarded command append; other
  appends carry the token.

Shared mechanics, faithful to the reference:

- the Start event is emitted *before* the call, the Finish after
  (history.rs:556-560);
- indefinite append failures withhold the Finish event (the op stays open)
  and rotate to a fresh client id after a backoff, capped at
  ``max_client_ids`` total ids (history.rs:148-168, 27, 32);
- record batches are random, ≤1024 metered bytes with 8 bytes per-record
  overhead, at most the requested number of records (history.rs:47-82);
- any successful op's tail updates ``expected_next_seq_num``
  (history.rs:337-344).

One deliberate difference from the JAX collector: a read does not refold
the stream from its head.  The run's :class:`ReadHashes` keeps the bodies
read so far and the stream hash of each of their prefixes, so a read
hashes only the bodies past the longest prefix it shares with them.
The emitted ``ReadSuccess(tail, stream_hash)`` values are unchanged.
"""

from __future__ import annotations

import asyncio
import logging
import random
import string
from dataclasses import dataclass, field

from . import events as ev
from .hashing import chain_hash, record_hash
from .clock import vsleep
from .transport import (
    AppendConditionFailed,
    CheckTailError,
    DefiniteServerError,
    IndefiniteServerError,
    ReadError,
    S2StreamTransport,
)

__all__ = ["WorkloadConfig", "Ids", "HistorySink", "ReadHashes", "run_client", "WORKFLOWS"]

#: Narrates every op at DEBUG (kind, guards, outcome) the way the
#: reference's RUST_LOG=trace spans do (history.rs:408-439,509,570);
#: enable via S2VTPU_LOG=DEBUG on the CLI.
log = logging.getLogger("gpubench.gen.collector")

MAX_BATCH_BYTES = 1024
PER_RECORD_OVERHEAD = 8
MAX_CLIENT_IDS = 20
ATTEMPT_TO_SET_FENCE_TOKEN_EVERY = 100


@dataclass
class WorkloadConfig:
    num_ops: int
    workflow: str = "regular"
    max_client_ids: int = MAX_CLIENT_IDS
    #: reference value is 1s (history.rs:27); tests shrink it
    indefinite_failure_backoff_s: float = 1.0


class ReadHashes:
    """The stream hash of a read's bodies, folded incrementally.

    A read returns every body from the head, and its ``ReadSuccess`` holds
    the chain hash of all of them.  This keeps the bodies of the reads so
    far and ``prefix[i]``, the stream hash of their first ``i``; a read
    shares a prefix with them (C-level list equality finds it) and hashes
    only the bodies past it, so a read costs O(records appended since), not
    O(stream).  A read that is a prefix of them (a stale read) hashes
    nothing; one that differs inside them (a record rewritten in place)
    drops them from the first difference on.
    One instance, in the run's :class:`Ids`, is shared by its clients.
    """

    def __init__(self) -> None:
        self.bodies: list[bytes] = []
        self.prefix: list[int] = [0]

    def of(self, bodies: list[bytes]) -> int:
        kept = self.bodies
        k = min(len(bodies), len(kept))
        if bodies[:k] != kept[:k]:
            k = next(i for i, (a, b) in enumerate(zip(bodies, kept)) if a != b)
        if k < len(bodies):
            del kept[k:], self.prefix[k + 1 :]
            prefix = self.prefix
            for body in bodies[k:]:
                prefix.append(chain_hash(prefix[-1], record_hash(body)))
            kept.extend(bodies[k:])
        return self.prefix[len(bodies)]


@dataclass
class Ids:
    """Shared atomic counters for client ids and the global op order, and
    the run's :class:`ReadHashes`."""

    next_client_id: int = 1
    next_op_id: int = 0
    reads: ReadHashes = field(default_factory=ReadHashes)

    def take_client_id(self) -> int:
        cid = self.next_client_id
        self.next_client_id += 1
        return cid

    def take_op_id(self) -> int:
        oid = self.next_op_id
        self.next_op_id += 1
        return oid


class HistorySink:
    """Single-writer event log (the reference's mpsc writer task).

    Without a ``writer`` every event is buffered in ``self.events`` (the
    in-memory path).  With a ``writer`` (any ``.write(str)`` text sink)
    each event is encoded and written the moment it is sent — the process
    holds O(window) state instead of O(history), which is what lets a soak
    run collect unbounded histories.  The encode path is shared with
    :func:`~..utils.events.write_history`, so the streamed bytes are
    identical to a buffered collect-then-write.

    ``observer`` (if given) sees every event in final log order on either
    path; campaign streams use it to watch for violation confirmation
    without retaining the history.
    """

    def __init__(self, writer=None, observer=None) -> None:
        self.events: list[ev.LabeledEvent] = []
        self.count = 0
        self._writer = writer
        self._observer = observer

    def send(self, le: ev.LabeledEvent) -> None:
        self.count += 1
        if self._observer is not None:
            self._observer(le)
        if self._writer is not None:
            self._writer.write(ev.encode_event(le))
            self._writer.write("\n")
        else:
            self.events.append(le)


def generate_records(rng: random.Random, num_records: int) -> tuple[list[bytes], list[int]]:
    """Random batch ≤1024 metered bytes; returns bodies and their hashes."""
    bodies: list[bytes] = []
    hashes: list[int] = []
    batch_bytes = 0
    while len(bodies) < num_records and batch_bytes + PER_RECORD_OVERHEAD < MAX_BATCH_BYTES:
        budget = MAX_BATCH_BYTES - batch_bytes - PER_RECORD_OVERHEAD
        size = rng.randint(1, budget)
        body = rng.randbytes(size)
        bodies.append(body)
        hashes.append(record_hash(body))
        batch_bytes += PER_RECORD_OVERHEAD + size
    return bodies, hashes


def _random_op(rng: random.Random) -> str:
    return ("append", "read", "check_tail")[rng.randrange(3)]


def _generate_token(rng: random.Random, n: int = 6) -> str:
    alphabet = string.ascii_letters + string.digits
    return "".join(rng.choice(alphabet) for _ in range(n))


@dataclass
class _ClientCtx:
    stream: S2StreamTransport
    sink: HistorySink
    ids: Ids
    rng: random.Random
    cfg: WorkloadConfig
    clock: object | None = None
    deferred: list[ev.LabeledEvent] = field(default_factory=list)


async def _append(
    ctx: _ClientCtx,
    client_id: int,
    op_id: int,
    bodies: list[bytes],
    hashes: list[int],
    *,
    match_seq_num: int | None = None,
    fencing_token: str | None = None,
    set_fencing_token: str | None = None,
) -> ev.Finish:
    """One append op: Start event, call, error classification, Finish event.

    Mirrors history.rs:530-612 — indefinite-failure Finish events are
    deferred (the op stays open in the live log until the run's end).
    """
    ctx.sink.send(
        ev.LabeledEvent(
            ev.AppendStart(
                num_records=len(bodies),
                record_hashes=tuple(hashes),
                set_fencing_token=set_fencing_token,
                fencing_token=fencing_token,
                match_seq_num=match_seq_num,
            ),
            client_id,
            op_id,
        )
    )
    finish: ev.Finish
    try:
        ack = await ctx.stream.append(
            bodies,
            match_seq_num=match_seq_num,
            fencing_token=fencing_token,
            set_fencing_token=set_fencing_token,
        )
        finish = ev.AppendSuccess(tail=ack.tail)
    except (AppendConditionFailed, DefiniteServerError):
        finish = ev.AppendDefiniteFailure()
    except IndefiniteServerError:
        finish = ev.AppendIndefiniteFailure()
    if isinstance(finish, ev.AppendIndefiniteFailure):
        ctx.deferred.append(ev.LabeledEvent(finish, client_id, op_id))
    else:
        ctx.sink.send(ev.LabeledEvent(finish, client_id, op_id))
    log.debug(
        "client=%d op=%d append records=%d match_seq_num=%s token=%s set_token=%s -> %s%s",
        client_id,
        op_id,
        len(bodies),
        match_seq_num,
        fencing_token,
        set_fencing_token,
        type(finish).__name__,
        " (finish deferred; op stays open)"
        if isinstance(finish, ev.AppendIndefiniteFailure)
        else "",
    )
    return finish


async def _read(ctx: _ClientCtx, client_id: int, op_id: int) -> ev.Finish:
    ctx.sink.send(ev.LabeledEvent(ev.ReadStart(), client_id, op_id))
    finish: ev.Finish
    try:
        bodies = await ctx.stream.read_all()
        finish = ev.ReadSuccess(tail=len(bodies), stream_hash=ctx.ids.reads.of(bodies))
    except ReadError:
        finish = ev.ReadFailure()
    ctx.sink.send(ev.LabeledEvent(finish, client_id, op_id))
    log.debug("client=%d op=%d read -> %s", client_id, op_id, finish)
    return finish


async def _check_tail(ctx: _ClientCtx, client_id: int, op_id: int) -> ev.Finish:
    ctx.sink.send(ev.LabeledEvent(ev.CheckTailStart(), client_id, op_id))
    finish: ev.Finish
    try:
        tail = await ctx.stream.check_tail()
        finish = ev.CheckTailSuccess(tail=tail)
    except CheckTailError:
        finish = ev.CheckTailFailure()
    ctx.sink.send(ev.LabeledEvent(finish, client_id, op_id))
    log.debug("client=%d op=%d check_tail -> %s", client_id, op_id, finish)
    return finish


async def _rotate_client_id(ctx: _ClientCtx) -> int | None:
    """After an indefinite failure: back off, take a fresh identity.

    Returns the new client id, or None when the id budget is exhausted
    (the caller stops early, history.rs:152-168).
    """
    if ctx.cfg.indefinite_failure_backoff_s > 0:
        await vsleep(ctx.clock, ctx.cfg.indefinite_failure_backoff_s)
    candidate = ctx.ids.take_client_id()
    if candidate < ctx.cfg.max_client_ids:
        log.debug("rotated to fresh client id %d after indefinite failure", candidate)
        return candidate
    log.debug(
        "client id budget exhausted (max_client_ids=%d); stopping this client",
        ctx.cfg.max_client_ids,
    )
    return None


async def run_client(
    stream: S2StreamTransport,
    sink: HistorySink,
    ids: Ids,
    rng: random.Random,
    cfg: WorkloadConfig,
    clock=None,
) -> list[ev.LabeledEvent]:
    """Run one workload client; returns its deferred (withheld) events."""
    ctx = _ClientCtx(stream=stream, sink=sink, ids=ids, rng=rng, cfg=cfg, clock=clock)
    client_id = ids.take_client_id()
    fencing = cfg.workflow == "fencing"
    match_seq = cfg.workflow == "match-seq-num"
    my_token = _generate_token(rng) if fencing else None
    expected_next_seq_num = 0

    for sample in range(cfg.num_ops):
        op_id = ids.take_op_id()
        finish: ev.Finish
        if fencing and sample % ATTEMPT_TO_SET_FENCE_TOKEN_EVERY == 0:
            # Fence: a single command record whose body is the token bytes,
            # guarded by match_seq_num to avoid last-write-wins.
            body = my_token.encode()
            finish = await _append(
                ctx,
                client_id,
                op_id,
                [body],
                [record_hash(body)],
                match_seq_num=expected_next_seq_num,
                set_fencing_token=my_token,
            )
        else:
            op = _random_op(rng)
            if op == "append":
                bodies, hashes = generate_records(rng, rng.randint(1, 999))
                finish = await _append(
                    ctx,
                    client_id,
                    op_id,
                    bodies,
                    hashes,
                    match_seq_num=expected_next_seq_num if match_seq else None,
                    fencing_token=my_token if fencing else None,
                )
            elif op == "read":
                finish = await _read(ctx, client_id, op_id)
            else:
                finish = await _check_tail(ctx, client_id, op_id)
        if isinstance(finish, ev.AppendIndefiniteFailure):
            new_id = await _rotate_client_id(ctx)
            if new_id is None:
                break
            client_id = new_id
        if isinstance(finish, (ev.AppendSuccess, ev.ReadSuccess, ev.CheckTailSuccess)):
            expected_next_seq_num = finish.tail
    return ctx.deferred


WORKFLOWS = ("regular", "match-seq-num", "fencing")
