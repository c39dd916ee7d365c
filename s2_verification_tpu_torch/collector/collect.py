"""History collection orchestration: the ``collect-history`` equivalent.

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
   (collect-history.rs:185-193);
5. write ``./data/records.<epoch>.jsonl`` and print the path.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from dataclasses import dataclass

from ..utils import events as ev
from ..utils.hashing import record_hash
from .clock import VirtualClock
from .fake_s2 import FakeS2Stream, FaultPlan
from .transport import S2StreamTransport
from .workloads import Ids, HistorySink, WorkloadConfig, run_client

__all__ = ["CollectConfig", "collect_history", "collect_to_file", "default_stream"]

log = logging.getLogger("s2_verification_tpu_torch.collector")


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


def _make_sink(stream: S2StreamTransport, writer=None) -> HistorySink:
    """Campaign streams expose an ``observe`` hook (violation confirmation
    rides on log order); plain streams don't — wire it when present."""
    return HistorySink(writer=writer, observer=getattr(stream, "observe", None))


def _client_stream(stream: S2StreamTransport, slot: int) -> S2StreamTransport:
    """Per-client view of the stream.  Campaign streams hand each spawned
    client a slot-tagged facade (partitions and violations are per-client);
    plain streams are shared as-is."""
    for_client = getattr(stream, "for_client", None)
    return for_client(slot) if for_client is not None else stream


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
                _client_stream(stream, i),
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
    sink = _make_sink(stream)
    asyncio.run(_run(cfg, stream, sink))
    return sink.events


def collect_to_file(
    cfg: CollectConfig,
    stream: S2StreamTransport | None = None,
    out_dir: str = "./data",
) -> str:
    """Collect, streaming straight into ``<out_dir>/records.<epoch>.jsonl``;
    returns the path.

    Events hit the file the moment they are recorded (the sink writes
    through), so an arbitrarily long soak collection holds O(window)
    memory, not O(history)."""
    if stream is None:
        stream = default_stream(cfg)
    os.makedirs(out_dir, exist_ok=True)
    epoch = int(time.time())
    path = os.path.join(out_dir, f"records.{epoch}.jsonl")
    suffix = 0
    while True:
        try:
            # Exclusive create: two collections in the same second must not
            # concatenate into one corrupt history.
            f = open(path, "x", encoding="utf-8")
            break
        except FileExistsError:
            suffix += 1
            path = os.path.join(out_dir, f"records.{epoch}.{suffix}.jsonl")
    try:
        with f:
            asyncio.run(_run(cfg, stream, _make_sink(stream, writer=f)))
    except BaseException:
        # Never leave a truncated history behind masquerading as complete.
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    return path
