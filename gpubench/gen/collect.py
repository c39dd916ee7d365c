"""History collection orchestration: the ``collect-history`` equivalent.

A frozen copy of the port's ``collector/collect.py`` (without its file
output), with :func:`make`, the benchmark's generator entry.

Runs N concurrent workload clients against a stream (the in-process fake S2
by default, so collection needs no network), records every call start and
finish as JSONL, and flushes deferred indefinite-failure finishes after all
clients stop.  Mirrors the reference binary's lifecycle
(rust/s2-verification/src/bin/collect-history.rs:55-201):

1. create/open the stream (idempotent);
2. if the stream is non-empty, emit a rectifying append (client 0) carrying
   every existing record's hash so the model can start from tail 0
   (history.rs:650-679);
3. spawn clients, single-writer event log;
4. append deferred indefinite-failure finishes, asserting their kind
   (collect-history.rs:185-193).
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import random
from dataclasses import dataclass

from . import events as ev
from .hashing import chain_hash, record_hash
from .clock import VirtualClock
from .fake_s2 import FakeS2Stream, FaultPlan
from .transport import S2StreamTransport
from .workloads import Ids, HistorySink, WorkloadConfig, run_client

__all__ = ["CollectConfig", "collect_history", "default_stream", "make"]

log = logging.getLogger("gpubench.gen.collector")


@dataclass
class CollectConfig:
    num_concurrent_clients: int = 5
    num_ops_per_client: int = 100
    workflow: str = "regular"
    seed: int = 0
    faults: FaultPlan | None = None
    indefinite_failure_backoff_s: float = 0.001
    max_client_ids: int = 20


def initialize_tail(sink: HistorySink, op_id: int, tail: int, hashes: list[int]) -> None:
    """Spoof a successful append 0→tail for a non-empty starting stream."""
    if len(hashes) != tail:
        raise ValueError("rectifying append must cover every record from the head")
    sink.send(
        ev.LabeledEvent(
            ev.AppendStart(num_records=tail, record_hashes=tuple(hashes)),
            client_id=0,
            op_id=op_id,
        )
    )
    sink.send(ev.LabeledEvent(ev.AppendSuccess(tail=tail), client_id=0, op_id=op_id))


async def _run(cfg: CollectConfig, stream: S2StreamTransport, sink: HistorySink) -> None:
    ids = Ids()

    # Deterministic virtual time: client tasks only yield at sleep points,
    # and the clock wakes exactly one sleeper at a time in (deadline, seq)
    # order — so the interleaving, and therefore the history bytes, are a
    # pure function of the seeds (the reference gets this from turmoil /
    # Antithesis DST, README.md:5).
    clock = VirtualClock()
    # Attach this run's clock unconditionally: a stream reused across runs
    # (the rectifying-append scenario) would otherwise keep the previous
    # run's clock, parking this run's tasks on a scheduler that can never
    # advance (its registered-task count is already drained) — a deadlock.
    prev_clock = stream.clock
    stream.clock = clock

    # Rectify a non-empty starting stream (collect-history.rs:107-118).
    # Uses the fault-free setup path, like the reference's retrying setup
    # client.
    existing = [record_hash(b) for b in stream.snapshot_bodies()]
    if existing:
        log.debug(
            "stream starts non-empty (tail=%d); emitting rectifying append",
            len(existing),
        )
        initialize_tail(sink, ids.take_op_id(), len(existing), existing)

    wcfg = WorkloadConfig(
        num_ops=cfg.num_ops_per_client,
        workflow=cfg.workflow,
        max_client_ids=cfg.max_client_ids,
        indefinite_failure_backoff_s=cfg.indefinite_failure_backoff_s,
    )

    async def client(i: int) -> list[ev.LabeledEvent]:
        try:
            return await run_client(
                stream,
                sink,
                ids,
                random.Random((cfg.seed << 16) ^ (i + 1)),
                wcfg,
                clock=clock,
            )
        finally:
            clock.unregister()

    for _ in range(cfg.num_concurrent_clients):
        clock.register()
    try:
        deferred_lists = await asyncio.gather(
            *(client(i) for i in range(cfg.num_concurrent_clients))
        )
    finally:
        stream.clock = prev_clock
    n_deferred = sum(len(d) for d in deferred_lists)
    log.debug(
        "all clients done: %d events collected, flushing %d deferred "
        "indefinite-failure finishes",
        sink.count,
        n_deferred,
    )
    for deferred in deferred_lists:
        for le in deferred:
            assert isinstance(le.event, ev.AppendIndefiniteFailure)
            sink.send(le)


def default_stream(cfg: CollectConfig) -> FakeS2Stream:
    """The canonical fault-injecting stream for a config — ONE derivation
    of the server-side seed, shared by the in-process path and the
    loopback-socket server so both transports see identical fault
    sequences for the same --seed."""
    return FakeS2Stream(
        rng=random.Random(cfg.seed ^ 0x5EED),
        faults=cfg.faults if cfg.faults is not None else FaultPlan.chaos(),
    )


def collect_history(
    cfg: CollectConfig, stream: S2StreamTransport | None = None
) -> list[ev.LabeledEvent]:
    """Collect a history in-memory; returns the full event list."""
    if stream is None:
        stream = default_stream(cfg)
    sink = HistorySink()
    asyncio.run(_run(cfg, stream, sink))
    return sink.events


def _rehash(events: list[ev.LabeledEvent], stream: FakeS2Stream, mask: int) -> list[ev.LabeledEvent]:
    """The same history with every record hash xored with ``mask`` and each
    read's stream hash folded anew over the stream's first ``tail``
    records (a read sees a prefix of what the stream holds at the end)."""
    prefix = [0]
    for h in stream.true_stream_hashes():
        prefix.append(chain_hash(prefix[-1], h ^ mask))
    out = []
    for le in events:
        e = le.event
        if isinstance(e, ev.AppendStart):
            e = dataclasses.replace(e, record_hashes=tuple(h ^ mask for h in e.record_hashes))
        elif isinstance(e, ev.ReadSuccess):
            e = dataclasses.replace(e, stream_hash=prefix[e.tail])
        out.append(ev.LabeledEvent(e, le.client_id, le.op_id))
    return out


def make(params: dict, seed: int, index=None) -> str:
    """One history as JSONL, collected against the fake S2 stream with the
    ``workflow``, ``num_concurrent_clients``, ``num_ops_per_client``,
    ``max_client_ids`` and ``faults`` (:class:`FaultPlan`'s fields) of
    ``params``.

    The history's structure (the clients' operations and their
    interleaving, the faults, the record counts) is collected from a seed
    derived from ``params["structure_seed"]`` and ``index`` alone, so that
    every run makes the same work, and ``seed`` draws the data: every
    record hash is xored with a 64-bit mask drawn from it, and each read's
    stream hash is folded anew."""
    key = f"{params['structure_seed']}/{index}".encode()
    cfg = CollectConfig(
        num_concurrent_clients=params["num_concurrent_clients"],
        num_ops_per_client=params["num_ops_per_client"],
        workflow=params["workflow"],
        seed=int.from_bytes(hashlib.sha256(key).digest()[:8], "little"),
        faults=FaultPlan(**params["faults"]),
        max_client_ids=params["max_client_ids"],
    )
    stream = default_stream(cfg)
    events = _rehash(collect_history(cfg, stream), stream, random.Random(seed).getrandbits(64))
    return "".join(ev.encode_event(le) + "\n" for le in events)
