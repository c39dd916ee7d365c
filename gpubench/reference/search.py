"""Whether a history is linearizable, by a breadth-first search.

A configuration is how many operations of each client have taken their
place (a client's operations run one after another, so these are
prefixes) and one model state.  Layer ``n`` holds every distinct
configuration with ``n`` operations placed.  An operation may be placed
next when it was called before every unplaced operation returned.  The
history is linearizable when a configuration places every operation; it is
not when a layer is empty.

Two rules leave the answer as it is and keep the layers small:

- definite failures change no state and are left out (each fits into any
  linearization of the rest, right after the operations that returned
  before its call);
- a tail never falls, so a configuration whose tail has passed what an
  unplaced operation needs (a read's or check-tail's reported tail, or a
  successful append's tail before it) is dropped.  Not applied where
  tails could wrap at 2^32.

``decide`` returns the ``op_id``s of a linearization, or None.
"""

from __future__ import annotations

import numpy as np

from .history import APPEND, Op, trivial
from .model import M32, hash_equal, step, token_ids
from .xxh3 import fold_np

__all__ = ["decide", "TooLarge"]

_INF = np.iinfo(np.int64).max


class TooLarge(RuntimeError):
    """A layer outgrew the row limit given to :func:`decide`."""


def _tail_cap(op: Op) -> int:
    if op.failure:
        return _INF
    if op.kind == APPEND:
        return (op.tail - op.num_records) & M32
    return op.tail & M32


def _chains(ops: list[Op]) -> list[list[Op]]:
    by_client: dict[int, list[Op]] = {}
    for op in ops:
        by_client.setdefault(op.client_id, []).append(op)
    chains = list(by_client.values())
    for chain in chains:
        for a, b in zip(chain, chain[1:]):
            if b.call < a.ret:
                raise ValueError(f"client {a.client_id} has overlapping ops {a.op_id} and {b.op_id}")
    return chains


def _suffix_min(values: list[int]) -> np.ndarray:
    out = np.full(len(values) + 1, _INF, dtype=np.int64)
    for i in range(len(values) - 1, -1, -1):
        out[i] = min(values[i], out[i + 1])
    return out


def _unique_rows(counts, tail, hsh, tok) -> np.ndarray:
    key = np.ascontiguousarray(np.column_stack([counts, tail, hsh.view(np.int64), tok]))
    void = key.view(np.dtype((np.void, key.dtype.itemsize * key.shape[1]))).reshape(-1)
    _, first = np.unique(void, return_index=True)
    return np.sort(first)


def decide(ops: list[Op], *, fold=fold_np, same_hash=hash_equal, max_rows: int = 1 << 23) -> list[int] | None:
    kept = [op for op in ops if not trivial(op)]
    chains = _chains(kept)
    ids = token_ids(kept)
    index_of = {op.op_id: i for i, op in enumerate(kept)}
    n_chains = len(chains)
    call = [np.array([op.call for op in ch] + [_INF], dtype=np.int64) for ch in chains]
    first_ret = [_suffix_min([op.ret for op in ch]) for ch in chains]
    wraps = sum(op.num_records for op in kept if op.kind == APPEND) > M32
    cap = [_suffix_min([_INF if wraps else _tail_cap(op) for op in ch]) for ch in chains]
    counts = np.zeros((1, n_chains), dtype=np.int64)
    tail = np.zeros(1, np.int64)
    hsh = np.zeros(1, np.uint64)
    tok = np.zeros(1, np.int64)
    layers: list[tuple[np.ndarray, np.ndarray]] = []
    for _ in range(len(kept)):
        cols = range(n_chains)
        min_ret = np.min(np.stack([first_ret[j][counts[:, j]] for j in cols]), axis=0)
        caps = np.stack([cap[j][counts[:, j]] for j in cols], axis=1)
        parts = []
        for j in cols:
            pos = counts[:, j]
            rows = np.nonzero(call[j][pos] < min_ret)[0]
            for p in np.unique(pos[rows]):
                rs = rows[pos[rows] == p]
                op = chains[j][p]
                child_caps = caps[rs].copy()
                child_caps[:, j] = cap[j][p + 1]
                src, t, h, k = step(op, tail[rs], hsh[rs], tok[rs], ids, cap=child_caps.min(axis=1),
                                    fold=fold, same_hash=same_hash)
                c = counts[rs[src]].copy()
                c[:, j] += 1
                parts.append((c, t, h, k, rs[src], np.full(len(src), index_of[op.op_id], dtype=np.int64)))
        if not parts or not sum(len(p[1]) for p in parts):
            return None
        counts, tail, hsh, tok, parent, placed = (np.concatenate(x) for x in zip(*parts))
        first = _unique_rows(counts, tail, hsh, tok)
        counts, tail, hsh, tok = counts[first], tail[first], hsh[first], tok[first]
        if len(tail) > max_rows:
            raise TooLarge(f"a layer of {len(tail)} configurations")
        layers.append((parent[first], placed[first]))
    order, row = [], 0
    for parent, placed in reversed(layers):
        order.append(kept[placed[row]].op_id)
        row = parent[row]
    return order[::-1]
