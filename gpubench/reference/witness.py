"""Whether an order of a history's operations linearizes it.

``replay(ops, order)`` takes the ``op_id``s in the order a checker gave
them and answers ``(True, "")`` or ``(False, why)``.  The order must name
every operation once, except that definite failures may be left out: they
change no state, so each goes in right after the last operation that
returned before it was called, where real time allows it.  Then:

- real time: no operation may come after one that was called after it
  returned;
- the model: the set of states, from tail 0, hash 0 and no token, stepped
  through every operation in turn (:func:`.model.step`, the hash folded by
  :mod:`.xxh3`), never empties.
"""

from __future__ import annotations

import numpy as np

from .history import Op, trivial
from .model import step, token_ids

__all__ = ["replay"]


def _dedup(tail, hsh, tok):
    key = np.stack([tail, hsh.view(np.int64), tok], axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    return tail[first], hsh[first], tok[first]


def replay(ops: list[Op], order: list[int]) -> tuple[bool, str]:
    by_id = {op.op_id: op for op in ops}
    seq: list[Op] = []
    for op_id in order:
        if op_id not in by_id:
            return False, f"op {op_id} is not in the history"
        seq.append(by_id[op_id])
    if len({op.op_id for op in seq}) != len(seq):
        return False, "an op appears twice"
    named = set(order)
    left_out = [op for op in ops if op.op_id not in named]
    if any(not trivial(op) for op in left_out):
        return False, f"{sum(not trivial(op) for op in left_out)} ops that change state are left out"
    for op in left_out:
        at = 1 + max((i for i, o in enumerate(seq) if o.ret < op.call), default=-1)
        seq.insert(at, op)
    first_ret = float("inf")
    for i in range(len(seq) - 1, -1, -1):
        if seq[i].call > first_ret:
            return False, f"op {seq[i].op_id} at {i} comes after an op that returned before its call"
        first_ret = min(first_ret, seq[i].ret)
    ids = token_ids(ops)
    tail = np.zeros(1, np.int64)
    hsh = np.zeros(1, np.uint64)
    tok = np.zeros(1, np.int64)
    for i, op in enumerate(seq):
        _, tail, hsh, tok = step(op, tail, hsh, tok, ids)
        if len(tail) == 0:
            return False, f"no state is consistent with op {op.op_id} at {i}"
        tail, hsh, tok = _dedup(tail, hsh, tok)
    return True, ""
