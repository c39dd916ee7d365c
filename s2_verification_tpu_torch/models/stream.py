"""The S2 stream semantic model: a nondeterministic state machine.

State is constant-size regardless of stream length: ``(tail, cumulative
chain hash, fencing token)``.  ``step`` maps one state through one observed
operation to the *set* of states consistent with that observation — the
nondeterminism encodes ambiguity about whether an indefinitely-failed append
became durable.

Semantics parity with the reference model (golang/s2-porcupine/main.go:253-361):

Append (input_type 0), with ``optimistic`` = state after the append applies
(tail + num_records, hash folded over the batch, token replaced iff
set_fencing_token):
  - definite failure                  → {state}
  - indefinite failure: if a supplied batch token mismatches, or a supplied
    match_seq_num mismatches the tail  → {state}  (cannot have applied)
    else                               → {optimistic, state}  (can't say)
  - success: token mismatch, match_seq_num mismatch, or reported tail ≠
    optimistic tail                    → {}  (illegal observation)
    else                               → {optimistic}

Read (1) / CheckTail (2):
  - an observed stream hash must equal the state's hash, else {}
  - a failure (always definite: reads have no side effects) → {state}
  - success must report exactly the state's tail → {state}, else {}

Tail arithmetic is mod 2^32 (the reference state uses uint32 tails,
main.go:196-204).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

from ..utils import events as ev
from ..utils.hashing import fold_record_hashes

__all__ = [
    "StreamState",
    "StreamInput",
    "StreamOutput",
    "APPEND",
    "READ",
    "CHECK_TAIL",
    "INIT_STATE",
    "step",
    "step_set",
    "input_from_start",
    "output_from_finish",
    "describe_state",
    "describe_operation",
]

APPEND = 0
READ = 1
CHECK_TAIL = 2

_U32 = 0xFFFFFFFF


class StreamState(NamedTuple):
    tail: int
    stream_hash: int
    #: None means "no fencing token set"; distinct from the empty string.
    fencing_token: str | None

    def __lt__(self, other) -> bool:  # type: ignore[override]
        # Total order even when a tail/hash tie mixes None and str tokens
        # (plain tuple comparison would raise TypeError on None < str).
        if not isinstance(other, StreamState):
            return NotImplemented
        return (
            self.tail,
            self.stream_hash,
            self.fencing_token is not None,
            self.fencing_token or "",
        ) < (
            other.tail,
            other.stream_hash,
            other.fencing_token is not None,
            other.fencing_token or "",
        )


INIT_STATE = StreamState(tail=0, stream_hash=0, fencing_token=None)


@dataclass(frozen=True)
class StreamInput:
    input_type: int  # APPEND | READ | CHECK_TAIL
    set_fencing_token: str | None = None
    batch_fencing_token: str | None = None
    match_seq_num: int | None = None
    num_records: int | None = None
    record_hashes: tuple[int, ...] = ()


@dataclass(frozen=True)
class StreamOutput:
    #: Failures may or may not have had side effects.
    failure: bool = False
    #: Definite failures are guaranteed to have had no side effect.
    definite_failure: bool = False
    tail: int | None = None
    #: Cumulative stream hash observed by a read from the head.
    stream_hash: int | None = None


def step(state: StreamState, inp: StreamInput, out: StreamOutput) -> list[StreamState]:
    """All states consistent with observing (inp, out) from ``state``.

    Truth table: golang/s2-porcupine/main.go:264-335, mirrored exactly —
    including the reference's open TODO (main.go:271): a set-fencing-token
    append is NOT constrained to a single-record batch here either, so the
    two models accept identical histories.
    """
    if inp.input_type == APPEND:
        optimistic = StreamState(
            tail=(state.tail + (inp.num_records or 0)) & _U32,
            stream_hash=fold_record_hashes(state.stream_hash, inp.record_hashes),
            fencing_token=(
                inp.set_fencing_token
                if inp.set_fencing_token is not None
                else state.fencing_token
            ),
        )
        if out.failure and out.definite_failure:
            return [state]
        if out.failure:
            if inp.batch_fencing_token is not None and (
                state.fencing_token is None
                or inp.batch_fencing_token != state.fencing_token
            ):
                return [state]
            if inp.match_seq_num is not None and (inp.match_seq_num & _U32) != state.tail:
                return [state]
            return [optimistic, state]
        # Success.
        if inp.batch_fencing_token is not None and (
            state.fencing_token is None or state.fencing_token != inp.batch_fencing_token
        ):
            return []
        if inp.match_seq_num is not None and (inp.match_seq_num & _U32) != state.tail:
            return []
        if (out.tail & _U32) != optimistic.tail:
            return []
        return [optimistic]

    if inp.input_type in (READ, CHECK_TAIL):
        if out.stream_hash is not None and state.stream_hash != out.stream_hash:
            return []
        if out.failure or state.tail == (out.tail & _U32):
            return [state]
        return []

    raise ValueError(f"unknown input type {inp.input_type}")


def step_set(
    states: list[StreamState], inp: StreamInput, out: StreamOutput
) -> list[StreamState]:
    """Powerset lifting: union of ``step`` over a candidate state set, deduped.

    Mirrors ``NondeterministicModel.ToModel()`` in the reference dependency:
    an op is linearizable at a position iff the resulting set is non-empty.
    """
    seen: set[StreamState] = set()
    result: list[StreamState] = []
    for s in states:
        for ns in step(s, inp, out):
            if ns not in seen:
                seen.add(ns)
                result.append(ns)
    return result


# --------------------------------------------------------------------------
# Bridging from the wire event vocabulary
# --------------------------------------------------------------------------


def input_from_start(start: ev.Start) -> StreamInput:
    if isinstance(start, ev.AppendStart):
        return StreamInput(
            input_type=APPEND,
            set_fencing_token=start.set_fencing_token,
            batch_fencing_token=start.fencing_token,
            match_seq_num=start.match_seq_num,
            num_records=start.num_records,
            record_hashes=start.record_hashes,
        )
    if isinstance(start, ev.ReadStart):
        return StreamInput(input_type=READ)
    if isinstance(start, ev.CheckTailStart):
        return StreamInput(input_type=CHECK_TAIL)
    raise TypeError(f"not a start event: {start!r}")


def output_from_finish(finish: ev.Finish) -> StreamOutput:
    """Map a finish event to a model output (main.go:466-523).

    Read/check-tail failures are definite: those ops have no side effects.
    """
    if isinstance(finish, ev.AppendSuccess):
        return StreamOutput(tail=finish.tail)
    if isinstance(finish, ev.AppendDefiniteFailure):
        return StreamOutput(failure=True, definite_failure=True)
    if isinstance(finish, ev.AppendIndefiniteFailure):
        return StreamOutput(failure=True, definite_failure=False)
    if isinstance(finish, ev.ReadSuccess):
        return StreamOutput(tail=finish.tail, stream_hash=finish.stream_hash)
    if isinstance(finish, ev.ReadFailure):
        return StreamOutput(failure=True, definite_failure=True)
    if isinstance(finish, ev.CheckTailSuccess):
        return StreamOutput(tail=finish.tail)
    if isinstance(finish, ev.CheckTailFailure):
        return StreamOutput(failure=True, definite_failure=True)
    raise TypeError(f"not a finish event: {finish!r}")


# --------------------------------------------------------------------------
# Human-readable descriptions (for the HTML visualization)
# --------------------------------------------------------------------------


def describe_state(state: StreamState) -> str:
    if state.fencing_token is None:
        return f"tail[{state.tail}],hash[{state.stream_hash}]"
    return f"tail[{state.tail}],hash[{state.stream_hash}],token[{state.fencing_token}]"


def describe_operation(inp: StreamInput, out: StreamOutput) -> str:
    if inp.input_type == APPEND:
        parts = [f"len[{inp.num_records}]"]
        if inp.set_fencing_token is not None:
            parts.append(f"set_token[{inp.set_fencing_token}]")
        if inp.batch_fencing_token is not None:
            parts.append(f"batch_token[{inp.batch_fencing_token}]")
        if inp.match_seq_num is not None:
            parts.append(f"match_seq_num[{inp.match_seq_num}]")
        if inp.record_hashes:
            parts.append(f"rh_last[{inp.record_hashes[-1]}]")
        call = f"append({', '.join(parts)})"
        if out.failure:
            status = "definite" if out.definite_failure else "indefinite"
            return f"{call} -> FAILED[{status}]"
        return f"{call} -> tail[{out.tail}]"
    name = "read" if inp.input_type == READ else "check_tail"
    if out.failure:
        return f"{name}() -> failed"
    if out.stream_hash is not None:
        return f"{name}() -> tail[{out.tail}], hash[{out.stream_hash}]"
    return f"{name}() -> tail[{out.tail}]"
