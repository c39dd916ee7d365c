"""Adversarial history generator: the search-hardness stress family.

A frozen copy of the port's ``collector/adversarial.py``, with
:func:`make`, the benchmark's generator entry.

Collector-produced histories are easy for every engine — reads resolve each
ambiguous append almost immediately (BASELINE.md measured table).  The
regime BASELINE.json's north star actually targets ("CPU Porcupine cannot
solve it in 30 min") needs histories whose ambiguity is *global*:

- ``k`` clients each make one **ambiguous append** (indefinite failure,
  finish deferred to the end of the log, reference history.rs:152-168 /
  collect-history.rs:185-193), all calls overlapping, each carrying a
  ``batch``-sized load of random record hashes;
- one **pinning read** then reports the tail and cumulative chain hash of a
  *secret ordered subset* of those appends.

Deciding linearizability means finding which appends took effect, **in which
order** — the chain hash commits to the order, so the state space is the set
of ordered subsets of ``k`` (sum over m of k!/(k-m)!), ~10^5 at k=8 and
~10^8 at k=11.  Every engine pays it: the Wing–Gong DFS visits each
(bitset, state-set) once; the frontier engine holds one configuration per
reachable (counts, state-set).  What differs is *throughput*: the CPU walks
states one at a time, each visit folding ``batch`` chained hashes; the
device folds the whole frontier's hashes in lockstep (one ``lax.scan``
shared across thousands of configurations per compiled layer).

``unsatisfiable=True`` corrupts the pinned hash, producing an ILLEGAL
instance that cannot be shortcut: the verdict requires exhausting the space.
"""

from __future__ import annotations

import random

from . import events as ev
from .hashing import fold_record_hashes

__all__ = ["adversarial_events", "make"]


def adversarial_events(
    k: int,
    *,
    batch: int = 100,
    applied: int | None = None,
    seed: int = 0,
    unsatisfiable: bool = False,
) -> list[ev.LabeledEvent]:
    """Build the k-way ambiguous-append + pinning-read history.

    ``applied``: size of the secret subset (default k//2); the subset and
    its order are drawn from ``seed``.  All appends stay open (indefinite
    failures flushed at the end), so each may linearize before or after the
    read — only the hash decides.
    """
    rng = random.Random(seed)
    if applied is None:
        applied = k // 2
    if not 0 <= applied <= k:
        raise ValueError(f"applied={applied} out of range for k={k}")

    hashes = [
        tuple(rng.getrandbits(64) for _ in range(batch)) for _ in range(k)
    ]
    secret = rng.sample(range(k), applied)  # ordered subset

    events: list[ev.LabeledEvent] = []
    # All append calls first: every window overlaps every other.
    for i in range(k):
        events.append(
            ev.LabeledEvent(
                ev.AppendStart(num_records=batch, record_hashes=hashes[i]),
                client_id=i + 1,
                op_id=i,
            )
        )
    # The pinning read (its own client), called while everything is open.
    stream_hash = 0
    for i in secret:
        stream_hash = fold_record_hashes(stream_hash, hashes[i])
    if unsatisfiable:
        stream_hash ^= 1
    events.append(ev.LabeledEvent(ev.ReadStart(), client_id=k + 1, op_id=k))
    events.append(
        ev.LabeledEvent(
            ev.ReadSuccess(tail=applied * batch, stream_hash=stream_hash),
            client_id=k + 1,
            op_id=k,
        )
    )
    # Deferred indefinite-failure finishes, flushed after everything like
    # the reference collector (collect-history.rs:185-193).
    for i in range(k):
        events.append(
            ev.LabeledEvent(
                ev.AppendIndefiniteFailure(), client_id=i + 1, op_id=i
            )
        )
    return events


def make(params: dict, seed: int, index=None) -> str:
    """One history as JSONL: ``adversarial_events`` with ``k``, ``batch``,
    ``applied`` (absent: ``k // 2``) and ``unsatisfiable`` from ``params``.
    Every seed makes the same work (``k`` open appends of ``batch``
    records, ``applied`` of them pinned) in other data; ``index`` is not
    used."""
    events = adversarial_events(
        params["k"],
        batch=params["batch"],
        applied=params.get("applied"),
        seed=seed,
        unsatisfiable=params.get("unsatisfiable", False),
    )
    return "".join(ev.encode_event(le) + "\n" for le in events)
