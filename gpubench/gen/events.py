"""History events and their JSONL encoding: the encoding half of the port's
``utils/events.py``, frozen for the benchmark's generators.  The wire
format is upstream ``collect-history``'s serde encoding
(rust/s2-verification/src/history.rs:84-137).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Union

__all__ = [
    "AppendStart",
    "ReadStart",
    "CheckTailStart",
    "AppendSuccess",
    "AppendDefiniteFailure",
    "AppendIndefiniteFailure",
    "ReadSuccess",
    "ReadFailure",
    "CheckTailSuccess",
    "CheckTailFailure",
    "Start",
    "Finish",
    "LabeledEvent",
    "encode_event",
    "event_to_obj",
]


# --------------------------------------------------------------------------
# Call-start variants
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AppendStart:
    num_records: int
    #: xxh3 of each record body in the batch, in order; the model folds these
    #: onto its cumulative stream hash.
    record_hashes: tuple[int, ...] = ()
    set_fencing_token: str | None = None
    fencing_token: str | None = None
    match_seq_num: int | None = None

    def __post_init__(self) -> None:
        if len(self.record_hashes) != self.num_records:
            raise ValueError(
                f"append has {len(self.record_hashes)} record_hashes "
                f"but {self.num_records} records"
            )


@dataclass(frozen=True)
class ReadStart:
    pass


@dataclass(frozen=True)
class CheckTailStart:
    pass


Start = Union[AppendStart, ReadStart, CheckTailStart]


# --------------------------------------------------------------------------
# Call-finish variants
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class AppendSuccess:
    tail: int


@dataclass(frozen=True)
class AppendDefiniteFailure:
    pass


@dataclass(frozen=True)
class AppendIndefiniteFailure:
    pass


@dataclass(frozen=True)
class ReadSuccess:
    tail: int
    #: Cumulative chain hash over every record body from the head of the
    #: stream through the tail.
    stream_hash: int


@dataclass(frozen=True)
class ReadFailure:
    pass


@dataclass(frozen=True)
class CheckTailSuccess:
    tail: int


@dataclass(frozen=True)
class CheckTailFailure:
    pass


Finish = Union[
    AppendSuccess,
    AppendDefiniteFailure,
    AppendIndefiniteFailure,
    ReadSuccess,
    ReadFailure,
    CheckTailSuccess,
    CheckTailFailure,
]

_START_TYPES = (AppendStart, ReadStart, CheckTailStart)


@dataclass(frozen=True)
class LabeledEvent:
    """One history record: a call start or finish, tagged with identity.

    ``client_id`` scopes real-time ordering (ops within a client are
    sequential); ``op_id`` pairs a start with its finish.
    """

    event: Start | Finish
    client_id: int
    op_id: int

    @property
    def is_start(self) -> bool:
        return isinstance(self.event, _START_TYPES)


# --------------------------------------------------------------------------
# Encoding
# --------------------------------------------------------------------------

_UNIT_VARIANTS: dict[type, str] = {
    ReadStart: "Read",
    CheckTailStart: "CheckTail",
    AppendDefiniteFailure: "AppendDefiniteFailure",
    AppendIndefiniteFailure: "AppendIndefiniteFailure",
    ReadFailure: "ReadFailure",
    CheckTailFailure: "CheckTailFailure",
}


def _payload_to_obj(ev: Start | Finish) -> object:
    name = _UNIT_VARIANTS.get(type(ev))
    if name is not None:
        return name
    if isinstance(ev, AppendStart):
        return {
            "Append": {
                "num_records": ev.num_records,
                "record_hashes": list(ev.record_hashes),
                "set_fencing_token": ev.set_fencing_token,
                "fencing_token": ev.fencing_token,
                "match_seq_num": ev.match_seq_num,
            }
        }
    if isinstance(ev, AppendSuccess):
        return {"AppendSuccess": {"tail": ev.tail}}
    if isinstance(ev, ReadSuccess):
        return {"ReadSuccess": {"tail": ev.tail, "stream_hash": ev.stream_hash}}
    if isinstance(ev, CheckTailSuccess):
        return {"CheckTailSuccess": {"tail": ev.tail}}
    raise TypeError(f"unknown event payload: {ev!r}")


def event_to_obj(le: LabeledEvent) -> dict:
    side = "Start" if le.is_start else "Finish"
    return {
        "event": {side: _payload_to_obj(le.event)},
        "client_id": le.client_id,
        "op_id": le.op_id,
    }


def encode_event(le: LabeledEvent) -> str:
    """One JSONL line (no trailing newline)."""
    return json.dumps(event_to_obj(le), separators=(",", ":"))
