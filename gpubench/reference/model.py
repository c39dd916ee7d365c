"""The S2 stream model, stepped over arrays of states.

A state is ``(tail, stream_hash, fencing token)``; the token is an id, 0
for none, interned per history.  One operation maps each state to the
states consistent with what it observed (upstream ``s2-porcupine``'s
model):

- append, with ``after`` the state once it takes effect (tail plus its
  records modulo 2^32, the hash folded over its record hashes, the token
  replaced when it sets one):
  - definite failure: the state;
  - indefinite failure: the state alone when its fencing token or its
    ``match_seq_num`` does not hold, else ``after`` and the state;
  - success: ``after`` if the token and ``match_seq_num`` hold and
    ``after``'s tail is the tail it reported, else nothing;
- read or check-tail: a reported stream hash must equal the state's and a
  reported tail its tail, else nothing; a failure keeps the state.
"""

from __future__ import annotations

import numpy as np

from .history import APPEND, Op
from .xxh3 import fold_np

__all__ = ["M32", "step", "hash_equal"]

M32 = (1 << 32) - 1


def hash_equal(hashes: np.ndarray, reported: int) -> np.ndarray:
    return hashes == np.uint64(reported)


def step(op: Op, tail, hsh, tok, token_id: dict, cap=None, fold=fold_np, same_hash=hash_equal):
    """The states ``op`` leads to from the states ``(tail, hsh, tok)``, as
    ``(src, tail, hsh, tok)``, ``src`` indexing each result's origin.
    ``cap`` (per state, optional) drops the results of an append whose
    tail would pass it before their hash is folded."""
    n = len(tail)
    keep = np.arange(n)
    if op.kind != APPEND:
        if op.failure:
            return keep, tail, hsh, tok
        ok = tail == (op.tail & M32)
        if op.stream_hash is not None:
            ok &= same_hash(hsh, op.stream_hash)
        src = np.nonzero(ok)[0]
        return src, tail[src], hsh[src], tok[src]
    if op.failure and op.definite:
        return keep, tail, hsh, tok
    ok = np.ones(n, dtype=bool)
    if op.batch_token is not None:
        ok &= tok == token_id[op.batch_token]
    if op.match_seq_num is not None:
        ok &= tail == (op.match_seq_num & M32)
    new_tail = (tail + op.num_records) & M32
    if not op.failure:
        ok &= new_tail == (op.tail & M32)
    if cap is not None:
        ok &= new_tail <= cap
    src = np.nonzero(ok)[0]
    uniq, inv = np.unique(hsh[src], return_inverse=True)
    new_hash = fold(uniq, op.record_hashes)[inv.reshape(-1)]
    new_tok = tok[src] if op.set_token is None else np.full(len(src), token_id[op.set_token], dtype=tok.dtype)
    if not op.failure:
        return src, new_tail[src], new_hash, new_tok
    # An indefinite failure: it took effect, or it did not.
    return (
        np.concatenate([src, keep]),
        np.concatenate([new_tail[src], tail]),
        np.concatenate([new_hash, hsh]),
        np.concatenate([new_tok, tok]),
    )


def token_ids(ops) -> dict:
    """Every fencing token of the history, numbered from 1."""
    ids: dict = {}
    for op in ops:
        for t in (op.set_token, op.batch_token):
            if t is not None and t not in ids:
                ids[t] = len(ids) + 1
    return ids
