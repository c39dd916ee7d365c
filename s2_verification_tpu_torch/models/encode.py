"""Encode a prepared history into fixed-width arrays for the device search.

The reference search walks heap-allocated model values through interface
dispatch (porcupine's ``Step`` on ``interface{}`` states).  For the GPU
search everything becomes dense integer arrays up front:

- one row per op: type, guards, output observation, call/return times, chain;
- fencing tokens interned to int ids (0 = "no token"; Go's ``nil`` vs ``""``
  distinction survives because the empty string gets its own nonzero id);
- ragged per-append record-hash lists packed into one padded uint32-pair
  matrix, one row per append, with per-op lengths (the device layer,
  ops/step_kernel.py, joins each pair into one int64 word) — the fold runs
  each lane for its own length only;
- chain tables: ops of one client in call order (the linearized set of a
  sequential client is always a prefix, so a device configuration stores one
  counter per chain instead of an op bitset).

A **forced prefix** is also precomputed: while the earliest remaining op's
return precedes every other op's call, that op is alone in its candidate
window and must linearize first, so the host applies it once and the search
starts from the resulting state set.  This folds the collector's rectifying
append (history.rs:650-679) — potentially covering a huge pre-existing
stream — into the initial state instead of a maximal-width row of the hash
matrix.

Every array dimension is **shape-bucketed** (``round_pow2`` /
``_bucket_chains`` / ``_bucket_len``) exactly as in the JAX package, so
both engines see identical arrays and the parity tests compare them field
by field; padded ops/chains are inert and ``num_ops`` stays the real count.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..checker.entries import History
from ..models.stream import APPEND, INIT_STATE, StreamState, step_set

__all__ = [
    "EncodedHistory",
    "encode_batch",
    "encode_history",
    "intern_state",
    "pad_encoded",
    "op_class_masks",
    "round_pow2",
    "INF_TIME",
]

INF_TIME = np.int32(2**31 - 1)


def round_pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n (but >= lo) — the shared shape-bucketing
    rule for both the encoder's array dimensions and the search's frontier
    capacities."""
    v = lo
    while v < n:
        v *= 2
    return v


def _bucket_chains(c: int) -> int:
    """Chain-count bucket: exact up to 8 chains, multiples of 4 above.

    The chain axis multiplies every per-layer expansion and fold, so
    coarse padding costs real throughput (pow2 11 -> 16 was +36% on the
    adversarial curve; mult-of-4 5 -> 8 was +46% on the collector
    headline).  Small counts stay exact — at most 8 variants there — and
    larger ones round to multiples of 4, keeping the total variant count
    bounded with <= 3 wasted chains."""
    c = max(2, c)
    if c <= 8:
        return c
    return ((c + 3) // 4) * 4


def _bucket_len(length: int) -> int:
    """Record-batch width bucket: pow2 up to 16, then multiples of 16.

    The JAX engine's fold scan runs the PADDED width for every lane, so
    this axis multiplies its fold cost (100 -> 112 instead of 128); the
    port keeps the bucket so both engines encode identically."""
    if length <= 16:
        return round_pow2(length, 1)
    return ((length + 15) // 16) * 16


@dataclass
class EncodedHistory:
    """Dense arrays over the N search-relevant ops (after forced-prefix
    reduction) of a prepared history."""

    # -- per-op input ------------------------------------------------------
    op_type: np.ndarray  # [N] int32: 0 append, 1 read, 2 check-tail
    has_set_token: np.ndarray  # [N] bool
    set_token: np.ndarray  # [N] int32 interned id
    has_batch_token: np.ndarray  # [N] bool
    batch_token: np.ndarray  # [N] int32
    has_match: np.ndarray  # [N] bool
    match_seq: np.ndarray  # [N] uint32
    num_records: np.ndarray  # [N] uint32
    rh_row: np.ndarray  # [N] int32 row into rh matrices (0 for non-appends)
    rh_len: np.ndarray  # [N] int32
    # -- per-op output observation ----------------------------------------
    out_failure: np.ndarray  # [N] bool
    out_definite: np.ndarray  # [N] bool
    out_tail: np.ndarray  # [N] uint32 (valid iff not out_failure)
    out_has_hash: np.ndarray  # [N] bool
    out_hash_hi: np.ndarray  # [N] uint32
    out_hash_lo: np.ndarray  # [N] uint32
    # -- real-time structure ----------------------------------------------
    call: np.ndarray  # [N] int32
    ret: np.ndarray  # [N] int32 (INF_TIME for pending ops)
    chain_of: np.ndarray  # [N] int32
    # -- record-hash matrix ------------------------------------------------
    rh_hi: np.ndarray  # [R, L] uint32
    rh_lo: np.ndarray  # [R, L] uint32
    # -- chain tables ------------------------------------------------------
    chain_ops: np.ndarray  # [C, Lc] int32, -1 padded
    chain_len: np.ndarray  # [C] int32
    chain_start: np.ndarray  # [C] int32 forced-prefix ops already applied
    # -- initial state set (post forced-prefix) ----------------------------
    init_states: list[StreamState]
    # -- interning ---------------------------------------------------------
    token_of_id: list[str | None] = field(default_factory=lambda: [None])
    #: op indices (into History.ops) in forced-prefix order
    forced_prefix: list[int] = field(default_factory=list)
    #: real (unpadded) op count; arrays are shape-bucketed past it with
    #: inert entries so distinct histories share compiled search programs
    n_ops: int = -1

    @property
    def num_ops(self) -> int:
        return int(self.n_ops) if self.n_ops >= 0 else int(self.op_type.shape[0])

    @property
    def num_chains(self) -> int:
        return int(self.chain_len.shape[0])

    @property
    def total_remaining(self) -> int:
        return int((self.chain_len - self.chain_start).sum())

    def keep_index(self) -> list[int]:
        """Encoded op index → original ``History.ops`` index (inverse of the
        forced-prefix peel, which keeps relative order)."""
        forced = set(self.forced_prefix)
        n_total = self.num_ops + len(self.forced_prefix)
        return [i for i in range(n_total) if i not in forced]


def op_class_masks(enc: "EncodedHistory") -> dict[str, np.ndarray]:
    """Step-kernel behavior classes of every encoded op row, as one shared
    derivation (the device tables and the prune analysis need the same
    masks):

    - ``is_indef``: indefinite append failure — the only two-successor op;
    - ``inert``: identity on every state (definite failures of any type,
      failed reads/check_tails — the latter are definite by construction);
    - ``filter_succ``: successful read/check_tail — a pure filter pinned
      to its observed tail (and hash, when present);
    - ``app_succ``: successful append — single-successor mutator that
      linearizes exactly at tail ``out_tail - num_records``.

    Padded rows (zeroed arrays past ``num_ops``) fall into ``app_succ``
    with zero records; consumers must reach ops through the chain tables
    (padded rows are in no chain), not through these masks alone.
    """
    is_append = enc.op_type == APPEND
    return {
        "is_indef": enc.out_failure & ~enc.out_definite & is_append,
        "inert": enc.out_failure & (enc.out_definite | ~is_append),
        "filter_succ": ~is_append & ~enc.out_failure,
        "app_succ": is_append & ~enc.out_failure,
    }


def _forced_prefix(history: History) -> tuple[list[int], list[StreamState]]:
    """Ops that must linearize first, and the state set after applying them.

    An op whose return precedes every other remaining op's call is the only
    candidate in its window: any valid linearization starts with it.  Applied
    repeatedly this folds the strictly-sequential prologue of a history
    (rectifying append, single-client warm-up) into the initial states.
    """
    ops = history.ops
    if not ops:
        return [], [INIT_STATE]
    order = sorted(range(len(ops)), key=lambda i: ops[i].call)
    prefix: list[int] = []
    states = [INIT_STATE]
    k = 0
    while k < len(order):
        op = ops[order[k]]
        next_call = ops[order[k + 1]].call if k + 1 < len(order) else None
        if next_call is not None and op.ret > next_call:
            break
        new_states = step_set(states, op.inp, op.out)
        if not new_states:
            # Forced op fails: the history is illegal; let the search engine
            # discover it uniformly by keeping this op unapplied.
            break
        states = new_states
        prefix.append(order[k])
        k += 1
    return prefix, states


def encode_history(history: History) -> EncodedHistory:
    forced, init_states = _forced_prefix(history)
    forced_set = set(forced)

    ops = history.ops
    keep = [op for op in ops if op.index not in forced_set]
    n = len(keep)
    # Shape buckets: every array dimension that reaches a compiled program
    # rounds up to a power of two, so distinct histories of similar size
    # share XLA executables.  Without this, a long-lived process checking
    # many histories compiles one program set per exact (N, C, Lc, R, L)
    # tuple and accumulates compile state without bound (observed: an
    # 800-history differential soak exhausted 125 GB of host RAM inside
    # LLVM).  Padded ops are inert — trivial outputs, no tokens, in no
    # chain — and padded chains are empty, so search semantics are
    # unchanged; ``num_ops`` stays the real count.
    n2 = round_pow2(n, 4) if n else 0

    tokens: dict[str, int] = {}
    token_of_id: list[str | None] = [None]

    def intern(tok: str | None) -> int:
        if tok is None:
            return 0
        tid = tokens.get(tok)
        if tid is None:
            tid = len(token_of_id)
            tokens[tok] = tid
            token_of_id.append(tok)
        return tid

    op_type = np.zeros(n2, np.int32)
    has_set_token = np.zeros(n2, bool)
    set_token = np.zeros(n2, np.int32)
    has_batch_token = np.zeros(n2, bool)
    batch_token = np.zeros(n2, np.int32)
    has_match = np.zeros(n2, bool)
    match_seq = np.zeros(n2, np.uint32)
    num_records = np.zeros(n2, np.uint32)
    rh_row = np.zeros(n2, np.int32)
    rh_len = np.zeros(n2, np.int32)
    out_failure = np.zeros(n2, bool)
    out_definite = np.zeros(n2, bool)
    out_tail = np.zeros(n2, np.uint32)
    out_has_hash = np.zeros(n2, bool)
    out_hash_hi = np.zeros(n2, np.uint32)
    out_hash_lo = np.zeros(n2, np.uint32)
    call = np.zeros(n2, np.int32)
    ret = np.zeros(n2, np.int32)
    # Inert pad defaults (overwritten below for the n real ops): trivial
    # check-tail definite failures with windows at infinity.
    op_type[n:] = 2
    out_failure[n:] = True
    out_definite[n:] = True
    ret[n:] = INF_TIME

    append_rows: list[tuple[int, ...]] = []
    for j, op in enumerate(keep):
        inp, out = op.inp, op.out
        op_type[j] = inp.input_type
        if inp.input_type == APPEND:
            has_set_token[j] = inp.set_fencing_token is not None
            set_token[j] = intern(inp.set_fencing_token)
            has_batch_token[j] = inp.batch_fencing_token is not None
            batch_token[j] = intern(inp.batch_fencing_token)
            has_match[j] = inp.match_seq_num is not None
            match_seq[j] = np.uint32((inp.match_seq_num or 0) & 0xFFFFFFFF)
            num_records[j] = np.uint32((inp.num_records or 0) & 0xFFFFFFFF)
            rh_row[j] = len(append_rows)
            rh_len[j] = len(inp.record_hashes)
            append_rows.append(inp.record_hashes)
        out_failure[j] = out.failure
        out_definite[j] = out.definite_failure
        out_tail[j] = np.uint32((out.tail or 0) & 0xFFFFFFFF)
        out_has_hash[j] = out.stream_hash is not None
        if out.stream_hash is not None:
            out_hash_hi[j] = np.uint32(out.stream_hash >> 32)
            out_hash_lo[j] = np.uint32(out.stream_hash & 0xFFFFFFFF)
        call[j] = op.call
        ret[j] = INF_TIME if op.pending else op.ret

    r = round_pow2(max(1, len(append_rows)))
    width = _bucket_len(max(1, max((len(row) for row in append_rows), default=1)))
    rh_hi = np.zeros((r, width), np.uint32)
    rh_lo = np.zeros((r, width), np.uint32)
    for i, row in enumerate(append_rows):
        arr = np.asarray(row, np.uint64)
        rh_hi[i, : len(row)] = (arr >> np.uint64(32)).astype(np.uint32)
        rh_lo[i, : len(row)] = (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    # Chains over the kept ops (renumbered), preserving History's chain ids.
    new_index = {op.index: j for j, op in enumerate(keep)}
    c = len(history.chains)
    chain_lists: list[list[int]] = [[] for _ in range(c)]
    chain_of = np.zeros(len(op_type), np.int32)
    for chain_id, members in enumerate(history.chains):
        for op_index in members:
            j = new_index.get(op_index)
            if j is not None:
                chain_of[j] = chain_id
                chain_lists[chain_id].append(j)
    c2 = _bucket_chains(c)
    lc = round_pow2(max(1, max((len(m) for m in chain_lists), default=1)))
    chain_ops = np.full((c2, lc), -1, np.int32)
    chain_len = np.zeros(c2, np.int32)
    for chain_id, members in enumerate(chain_lists):
        chain_ops[chain_id, : len(members)] = members
        chain_len[chain_id] = len(members)

    return EncodedHistory(
        op_type=op_type,
        has_set_token=has_set_token,
        set_token=set_token,
        has_batch_token=has_batch_token,
        batch_token=batch_token,
        has_match=has_match,
        match_seq=match_seq,
        num_records=num_records,
        rh_row=rh_row,
        rh_len=rh_len,
        out_failure=out_failure,
        out_definite=out_definite,
        out_tail=out_tail,
        out_has_hash=out_has_hash,
        out_hash_hi=out_hash_hi,
        out_hash_lo=out_hash_lo,
        call=call,
        ret=ret,
        chain_of=chain_of,
        rh_hi=rh_hi,
        rh_lo=rh_lo,
        chain_ops=chain_ops,
        chain_len=chain_len,
        chain_start=np.zeros(c2, np.int32),
        init_states=init_states,
        token_of_id=token_of_id,
        forced_prefix=forced,
        n_ops=n,
    )


def _pad1(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[0] == n:
        return a
    out = np.full(n, fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def _pad2(a: np.ndarray, rows: int, cols: int, fill) -> np.ndarray:
    if a.shape == (rows, cols):
        return a
    out = np.full((rows, cols), fill, a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def pad_encoded(
    enc: EncodedHistory, n2: int, r: int, w: int, c2: int, lc: int
) -> EncodedHistory:
    """Widen an encoding to the given dims with the encoder's inert pads.

    Identical semantics to encoding into the larger buckets directly: pad
    ops are trivial check-tail definite failures with windows at infinity,
    pad chains are empty, pad record-hash cells are masked by ``rh_len``.
    Returns ``enc`` itself when already at the target dims.
    """
    if (
        enc.op_type.shape[0] == n2
        and enc.rh_hi.shape == (r, w)
        and enc.chain_ops.shape == (c2, lc)
    ):
        return enc
    return EncodedHistory(
        op_type=_pad1(enc.op_type, n2, 2),
        has_set_token=_pad1(enc.has_set_token, n2, False),
        set_token=_pad1(enc.set_token, n2, 0),
        has_batch_token=_pad1(enc.has_batch_token, n2, False),
        batch_token=_pad1(enc.batch_token, n2, 0),
        has_match=_pad1(enc.has_match, n2, False),
        match_seq=_pad1(enc.match_seq, n2, 0),
        num_records=_pad1(enc.num_records, n2, 0),
        rh_row=_pad1(enc.rh_row, n2, 0),
        rh_len=_pad1(enc.rh_len, n2, 0),
        out_failure=_pad1(enc.out_failure, n2, True),
        out_definite=_pad1(enc.out_definite, n2, True),
        out_tail=_pad1(enc.out_tail, n2, 0),
        out_has_hash=_pad1(enc.out_has_hash, n2, False),
        out_hash_hi=_pad1(enc.out_hash_hi, n2, 0),
        out_hash_lo=_pad1(enc.out_hash_lo, n2, 0),
        call=_pad1(enc.call, n2, 0),
        ret=_pad1(enc.ret, n2, INF_TIME),
        chain_of=_pad1(enc.chain_of, n2, 0),
        rh_hi=_pad2(enc.rh_hi, r, w, 0),
        rh_lo=_pad2(enc.rh_lo, r, w, 0),
        chain_ops=_pad2(enc.chain_ops, c2, lc, -1),
        chain_len=_pad1(enc.chain_len, c2, 0),
        chain_start=_pad1(enc.chain_start, c2, 0),
        init_states=enc.init_states,
        token_of_id=enc.token_of_id,
        forced_prefix=enc.forced_prefix,
        n_ops=enc.n_ops,
    )


def encode_batch(hists: list[History]) -> list[EncodedHistory]:
    """Encode histories to **uniform** array dims for lane stacking.

    The forced-prefix peel shrinks N per lane, and the append-row count R
    and the chain-length bucket Lc differ between histories of one shape.
    A lane-batched search needs every lane's arrays shape-identical, so
    each lane is encoded normally and then widened (:func:`pad_encoded`) to
    the batch's maximum of every (already bucketed) dimension.
    """
    encs = [encode_history(h) for h in hists]
    n2 = max(e.op_type.shape[0] for e in encs)
    r = max(e.rh_hi.shape[0] for e in encs)
    w = max(e.rh_hi.shape[1] for e in encs)
    c2 = max(e.chain_ops.shape[0] for e in encs)
    lc = max(e.chain_ops.shape[1] for e in encs)
    return [pad_encoded(e, n2, r, w, c2, lc) for e in encs]


def intern_state(enc: EncodedHistory, state: StreamState) -> tuple[int, int, int, int]:
    """(tail, hash_hi, hash_lo, token_id) encoding of a model state.

    Token must already be interned; states produced by the forced prefix can
    only carry tokens that appear as some op's set_fencing_token, which
    encode_history interned.
    """
    if state.fencing_token is None:
        tid = 0
    else:
        try:
            tid = enc.token_of_id.index(state.fencing_token)
        except ValueError:
            tid = len(enc.token_of_id)
            enc.token_of_id.append(state.fencing_token)
    return (
        state.tail & 0xFFFFFFFF,
        (state.stream_hash >> 32) & 0xFFFFFFFF,
        state.stream_hash & 0xFFFFFFFF,
        tid,
    )
