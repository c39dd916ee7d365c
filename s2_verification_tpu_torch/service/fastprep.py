"""Fused fast-path admission: text → (History, fingerprint, shape) in one pass.

The measured admission cost of the layered slow path — ``iter_history``'s
per-record ``raw_decode`` + event-dataclass construction, ``prepare``'s
re-walk, then a third walk for the fingerprint canon — is ~3 ms per
collector-sized history, which caps a one-CPU daemon near 330 jobs/s
before any search runs.  This module does the same work in a single pass
over a batch-parsed record array: one ``json.loads`` of the whole history,
one walk that pairs calls with finishes, validates every field the slow
decoder validates, builds the prepared :class:`~..checker.entries.History`
directly, and leaves the fingerprint to the shared packed-canon fold
(:func:`..service.cache.history_fingerprint`).

**Fallback, not fork.**  The fast path never produces its own error: on
*any* anomaly — malformed JSON, an out-of-range field, a duplicate op_id, a
record spanning lines — it raises :class:`FastPrepFallback` and the caller
re-runs the layered slow path, which either succeeds (fast path was merely
too conservative) or raises the canonical ``DecodeError``/``HistoryError``
with the exact message clients and tests already depend on.  Differential
tests pin fast-path output (ops, chains, fingerprint, shape) to the slow
path on every collected history.

The decoded-event list most jobs never look at (viz is off on the serving
path; supervised escalation is rare) is materialized lazily via
:class:`LazyEvents`.
"""

from __future__ import annotations

import json

from ..checker.entries import History, Op
from ..models.stream import (
    APPEND,
    CHECK_TAIL,
    READ,
    StreamInput,
    StreamOutput,
)
from ..utils import events as ev

__all__ = ["FastPrepFallback", "FastPrepared", "LazyEvents", "fast_prepare"]

_U64_MAX = (1 << 64) - 1
_U32_MAX = (1 << 32) - 1

_READ_INPUT = StreamInput(input_type=READ)
_CHECK_TAIL_INPUT = StreamInput(input_type=CHECK_TAIL)
_OUT_DEFINITE = StreamOutput(failure=True, definite_failure=True)
_OUT_INDEFINITE = StreamOutput(failure=True, definite_failure=False)

#: AppendSuccess/CheckTailSuccess outputs keyed by tail: collector tails are
#: small and dense, so this interning removes most StreamOutput constructions
#: from the hot loop.  Bounded so adversarial tails can't grow it without end.
_TAIL_OUT: dict[int, StreamOutput] = {}
_TAIL_OUT_CAP = 8192


class FastPrepFallback(Exception):
    """The fast path declines this input; re-run the layered slow path."""


class LazyEvents(list):
    """A ``Job.events`` list that decodes on first access.

    The serving path (no_viz) never touches it; the artifact writer and
    supervised escalation force it through any iteration/len/index.
    """

    def __init__(self, records: list) -> None:
        super().__init__()
        self._records: list | None = records

    def _force(self) -> None:
        if self._records is not None:
            records, self._records = self._records, None
            self.extend(ev.decode_obj(obj) for obj in records)

    def __iter__(self):
        self._force()
        return super().__iter__()

    def __len__(self) -> int:
        self._force()
        return super().__len__()

    def __getitem__(self, i):
        self._force()
        return super().__getitem__(i)

    def __bool__(self) -> bool:
        self._force()
        return super().__len__() > 0


class FastPrepared:
    """Output of :func:`fast_prepare`: everything admission needs."""

    __slots__ = ("hist", "records", "events", "_text")

    def __init__(self, hist: History, records: list, text: str | None) -> None:
        self.hist = hist
        self.records = records
        self.events = LazyEvents(records)
        self._text = text

    def wire_text(self) -> str:
        """The history as JSONL text (journal / archive form).  Free when
        the submission arrived as text; re-serialized for ``records``
        submissions."""
        if self._text is None:
            self._text = "\n".join(
                json.dumps(r, separators=(",", ":")) for r in self.records
            )
        return self._text


def _u_int(v, bound: int) -> bool:
    return type(v) is int and 0 <= v <= bound


def _tail_out(tail: int) -> StreamOutput:
    out = _TAIL_OUT.get(tail)
    if out is None:
        if len(_TAIL_OUT) >= _TAIL_OUT_CAP:
            _TAIL_OUT.clear()
        out = StreamOutput(tail=tail)
        _TAIL_OUT[tail] = out
    return out


def _parse_records(text: str) -> list:
    """Whole-history JSON parse: one C-scanner pass over ``[r1,r2,...]``.

    Histories are one record per line in practice; anything denser (values
    spanning or sharing lines — which ``iter_history`` accepts) makes the
    joined array malformed and falls back.
    """
    lines = [ln for ln in text.splitlines() if ln and not ln.isspace()]
    if not lines:
        raise FastPrepFallback("empty history")
    try:
        records = json.loads("[" + ",".join(lines) + "]")
    except ValueError as e:
        raise FastPrepFallback(f"batch parse failed: {e}") from None
    return records


def fast_prepare(
    text: str | None = None, records: list | None = None
) -> FastPrepared:
    """One-pass decode + validate + prepare.

    Exactly one of ``text`` (JSONL) / ``records`` (pre-parsed record dicts,
    the ``submit`` frame's ``records`` field) must be given.  Raises
    :class:`FastPrepFallback` on any input the fast path cannot prove it
    handles identically to the slow path.
    """
    if records is None:
        assert text is not None
        records = _parse_records(text)
    # (time, client_id, inp) per open call, keyed by op_id.
    calls: dict[int, tuple[int, int, StreamInput]] = {}
    seen: set[int] = set()
    # (call, ret, client_id, op_id, inp, out, pending) in finish order.
    done: list[tuple[int, int, int, int, StreamInput, StreamOutput, bool]] = []
    for t, rec in enumerate(records):
        if type(rec) is not dict:
            raise FastPrepFallback("record is not an object")
        evt = rec.get("event")
        if type(evt) is not dict or len(evt) != 1:
            raise FastPrepFallback("bad event object")
        client_id = rec.get("client_id")
        op_id = rec.get("op_id")
        if (
            type(client_id) is not int
            or client_id < 0
            or type(op_id) is not int
            or op_id < 0
        ):
            raise FastPrepFallback("bad client_id/op_id")
        if "Start" in evt:
            start = evt["Start"]
            if op_id in seen:
                raise FastPrepFallback("duplicate call")
            seen.add(op_id)
            if start == "Read":
                inp = _READ_INPUT
            elif start == "CheckTail":
                inp = _CHECK_TAIL_INPUT
            elif type(start) is dict and "Append" in start:
                args = start["Append"]
                if type(args) is not dict:
                    raise FastPrepFallback("Append args not an object")
                hashes = args.get("record_hashes")
                if hashes is None:
                    hashes = ()
                elif type(hashes) is list:
                    for h in hashes:
                        if not _u_int(h, _U64_MAX):
                            raise FastPrepFallback("bad record hash")
                    hashes = tuple(hashes)
                else:
                    raise FastPrepFallback("record_hashes not a list")
                num = args.get("num_records")
                if not _u_int(num, _U32_MAX) or num != len(hashes):
                    raise FastPrepFallback("bad num_records")
                match = args.get("match_seq_num")
                if match is not None and not _u_int(match, _U32_MAX):
                    raise FastPrepFallback("bad match_seq_num")
                set_tok = args.get("set_fencing_token")
                if set_tok is not None and type(set_tok) is not str:
                    raise FastPrepFallback("bad set_fencing_token")
                batch_tok = args.get("fencing_token")
                if batch_tok is not None and type(batch_tok) is not str:
                    raise FastPrepFallback("bad fencing_token")
                inp = StreamInput(
                    input_type=APPEND,
                    set_fencing_token=set_tok,
                    batch_fencing_token=batch_tok,
                    match_seq_num=match,
                    num_records=num,
                    record_hashes=hashes,
                )
            else:
                raise FastPrepFallback("unknown start variant")
            calls[op_id] = (t, client_id, inp)
        elif "Finish" in evt:
            fin = evt["Finish"]
            pending = calls.pop(op_id, None)
            if pending is None:
                raise FastPrepFallback("finish without call")
            call_t, call_client, inp = pending
            if client_id != call_client:
                raise FastPrepFallback("finish client mismatch")
            if type(fin) is str:
                if fin == "AppendIndefiniteFailure":
                    out = _OUT_INDEFINITE
                elif fin in (
                    "AppendDefiniteFailure",
                    "ReadFailure",
                    "CheckTailFailure",
                ):
                    out = _OUT_DEFINITE
                else:
                    raise FastPrepFallback("unknown finish variant")
            elif type(fin) is dict:
                if "AppendSuccess" in fin:
                    body = fin["AppendSuccess"]
                    if type(body) is not dict or not _u_int(
                        body.get("tail"), _U32_MAX
                    ):
                        raise FastPrepFallback("bad AppendSuccess")
                    out = _tail_out(body["tail"])
                elif "ReadSuccess" in fin:
                    body = fin["ReadSuccess"]
                    if (
                        type(body) is not dict
                        or not _u_int(body.get("tail"), _U32_MAX)
                        or not _u_int(body.get("stream_hash"), _U64_MAX)
                    ):
                        raise FastPrepFallback("bad ReadSuccess")
                    out = StreamOutput(
                        tail=body["tail"], stream_hash=body["stream_hash"]
                    )
                elif "CheckTailSuccess" in fin:
                    body = fin["CheckTailSuccess"]
                    if type(body) is not dict or not _u_int(
                        body.get("tail"), _U32_MAX
                    ):
                        raise FastPrepFallback("bad CheckTailSuccess")
                    out = _tail_out(body["tail"])
                else:
                    raise FastPrepFallback("unknown finish variant")
            else:
                raise FastPrepFallback("unknown finish variant")
            done.append((call_t, t, client_id, op_id, inp, out, False))
        else:
            raise FastPrepFallback("record is neither Start nor Finish")

    # Pending-call completion: weakest consistent output, returns placed
    # after every real event in call order (entries._collect_ops).
    horizon = len(records)
    for op_id, (call_t, client_id, inp) in sorted(
        calls.items(), key=lambda kv: kv[1][0]
    ):
        out = _OUT_INDEFINITE if inp.input_type == APPEND else _OUT_DEFINITE
        done.append((call_t, horizon, client_id, op_id, inp, out, True))
        horizon += 1
    done.sort(key=lambda rec: rec[0])

    # Per-client sequentiality (prepare raises HistoryError; we fall back
    # so the slow path words the rejection).
    last_ret: dict[int, int] = {}
    for call_t, _ret, client_id, _op, _inp, _out, _p in done:
        prev = last_ret.get(client_id)
        if prev is not None and call_t < prev:
            raise FastPrepFallback("overlapping ops within a client")
        last_ret[client_id] = _ret

    ops: list[Op] = []
    trivial: list[Op] = []
    chain_index: dict[int, int] = {}
    chains: list[list[int]] = []
    chain_of: list[int] = []
    for call_t, ret, client_id, op_id, inp, out, pending in done:
        if out.definite_failure:  # failure is implied: trivial-op elision
            trivial.append(
                Op(
                    index=-1,
                    op_id=op_id,
                    client_id=client_id,
                    call=call_t,
                    ret=ret,
                    inp=inp,
                    out=out,
                    pending=pending,
                )
            )
            continue
        i = len(ops)
        ops.append(
            Op(
                index=i,
                op_id=op_id,
                client_id=client_id,
                call=call_t,
                ret=ret,
                inp=inp,
                out=out,
                pending=pending,
            )
        )
        c = chain_index.get(client_id)
        if c is None:
            c = len(chains)
            chain_index[client_id] = c
            chains.append([])
        chains[c].append(i)
        chain_of.append(c)

    hist = History(
        ops=ops, trivial_ops=trivial, chains=chains, chain_of=chain_of
    )
    return FastPrepared(hist, records, text)


def slow_prepare(text: str) -> tuple[list, History]:
    """The layered reference path (shared by the fallback and tests):
    returns ``(events, hist)`` or raises ``DecodeError``/``HistoryError``."""
    from ..checker.entries import prepare

    events = list(ev.iter_history(text))
    return events, prepare(events, elide_trivial=True)
