"""A history's JSONL, read into operations.

The wire format is upstream ``collect-history``'s serde encoding: one
object a line with ``event`` (``{"Start": ...}`` or ``{"Finish": ...}``),
``client_id`` and ``op_id``.  A start and a finish of one ``op_id`` make
one operation, whose ``call`` and ``ret`` are the lines' positions.  An
operation with no finish is pending: an append may or may not have taken
effect (an indefinite failure), a read or check-tail had no effect (a
definite failure), and it returns after every recorded line.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

__all__ = ["APPEND", "READ", "CHECK_TAIL", "Op", "parse", "trivial"]

APPEND, READ, CHECK_TAIL = 0, 1, 2


@dataclass(frozen=True)
class Op:
    op_id: int
    client_id: int
    call: int
    ret: int
    kind: int
    #: append inputs
    record_hashes: tuple = ()
    num_records: int = 0
    set_token: str | None = None
    batch_token: str | None = None
    match_seq_num: int | None = None
    #: outputs: ``failure`` and, for a failure, whether it is definite
    failure: bool = False
    definite: bool = False
    tail: int | None = None
    stream_hash: int | None = None


def _start(body) -> dict:
    if body == "Read":
        return {"kind": READ}
    if body == "CheckTail":
        return {"kind": CHECK_TAIL}
    a = body["Append"]
    hashes = tuple(a.get("record_hashes") or ())
    if len(hashes) != a["num_records"]:
        raise ValueError("an append's record_hashes and num_records disagree")
    return {
        "kind": APPEND,
        "record_hashes": hashes,
        "num_records": a["num_records"],
        "set_token": a.get("set_fencing_token"),
        "batch_token": a.get("fencing_token"),
        "match_seq_num": a.get("match_seq_num"),
    }


def _finish(body) -> dict:
    if body in ("AppendDefiniteFailure", "ReadFailure", "CheckTailFailure"):
        return {"failure": True, "definite": True}
    if body == "AppendIndefiniteFailure":
        return {"failure": True, "definite": False}
    (name, fields), = body.items()
    if name == "ReadSuccess":
        return {"tail": fields["tail"], "stream_hash": fields["stream_hash"]}
    if name in ("AppendSuccess", "CheckTailSuccess"):
        return {"tail": fields["tail"]}
    raise ValueError(f"unknown finish {name!r}")


def parse(text: str) -> list[Op]:
    """Every operation of the history, in the order of their calls."""
    open_calls: dict[int, tuple[int, int, dict]] = {}
    ops: list[Op] = []
    lines = [ln for ln in text.splitlines() if ln.strip()]
    for i, line in enumerate(lines):
        rec = json.loads(line)
        event, op_id, client = rec["event"], rec["op_id"], rec["client_id"]
        if "Start" in event:
            if op_id in open_calls:
                raise ValueError(f"op {op_id} called twice")
            open_calls[op_id] = (i, client, _start(event["Start"]))
        else:
            call, c, start = open_calls.pop(op_id)
            if c != client:
                raise ValueError(f"op {op_id} finished by another client")
            ops.append(Op(op_id=op_id, client_id=client, call=call, ret=i, **start, **_finish(event["Finish"])))
    horizon = len(lines)
    for op_id, (call, client, start) in sorted(open_calls.items(), key=lambda kv: kv[1][0]):
        definite = start["kind"] != APPEND
        ops.append(Op(op_id=op_id, client_id=client, call=call, ret=horizon, **start, failure=True, definite=definite))
        horizon += 1
    ops.sort(key=lambda o: o.call)
    return ops


def trivial(op: Op) -> bool:
    """A definite failure leaves every state as it is."""
    return op.failure and op.definite
