"""Failure diagnostics: which ops *refuse* to linearize at the deepest
prefix.

The port's copy of the JAX package's ``checker/diagnostics.py`` (plain
Python), held against it by ``tests/test_torch_diagnostics.py``.

The reference hands ``porcupine.Visualize`` per-op partial-linearization
info that lets a reader explore where a failed check got stuck
(golang/s2-porcupine/main.go:606,627).  The engines here record the deepest
linearized prefix (``CheckResult.deepest``); this module turns that prefix
into an actionable report — the concrete ops whose outputs are inconsistent
with every state reachable at the deepest configuration — so the HTML
artifact can point at the culprit instead of only outlining how far the
search got.

The deepest set of a sequential client is always a per-chain prefix, so it
is equivalent to a counts vector; a bounded single-state DFS (same shape as
the device engine's witness recovery) re-derives one concrete path to that
configuration, and the path's end state is then tested against every
window-open candidate op.  Refusal is reported per reached state — exactly
the device engine's per-row semantics.
"""

from __future__ import annotations

import logging

from ..models.stream import INIT_STATE, step_set
from .entries import History

__all__ = ["deepest_refusals", "derive_path"]

log = logging.getLogger("s2_verification_tpu_torch.diagnostics")


def _counts_of_deepest(history: History, deepest: list[int]) -> list[int] | None:
    """Deepest op set → per-chain prefix lengths; None if not a prefix
    (malformed input, never expected from an engine)."""
    ds = set(deepest)
    counts = []
    for members in history.chains:
        k = 0
        for i, op_idx in enumerate(members):
            if op_idx in ds:
                if i != k:
                    return None
                k = i + 1
        counts.append(k)
    if sum(counts) != len(ds):
        return None
    return counts


def _next_cands(history: History, counts) -> tuple[dict[int, int], list[int]]:
    """Window-open candidate chains at a configuration (the host mirror of
    the engines' candidate rule): each chain's next op, filtered to those
    whose call precedes every unlinearized op's earliest return."""
    nxt: dict[int, int] = {}
    m = None
    for c, members in enumerate(history.chains):
        if counts[c] < len(members):
            j = members[counts[c]]
            nxt[c] = j
            r = history.ops[j].ret
            m = r if m is None else min(m, r)
    cand = [c for c, j in nxt.items() if m is None or history.ops[j].call < m]
    return nxt, cand


def derive_path(
    history: History,
    deepest: list[int],
    node_budget: int = 200_000,
):
    """Re-derive one concrete linearization ORDER reaching the deepest
    configuration (a per-chain prefix set), plus its end state.

    Returns ``(order, goal_state)`` — ``order`` is the op-index sequence of
    a valid path, the per-op ordinals the HTML artifact annotates a failed
    check with (porcupine's partial-linearization info, main.go:606,627) —
    or ``(None, None)`` when the set is not a prefix or the DFS exhausts
    ``node_budget`` nodes."""
    target = _counts_of_deepest(history, deepest)
    if target is None:
        log.warning("deepest set is not a per-chain prefix; no diagnostics")
        return None, None
    return _derive_from_counts(history, tuple(target), node_budget)


def _derive_from_counts(history: History, tt: tuple, node_budget: int):
    start = (0,) * len(history.chains)

    init_key = (
        start,
        (INIT_STATE.tail, INIT_STATE.stream_hash, INIT_STATE.fencing_token),
    )
    # Parent pointers (key -> (parent key, op index)) reconstruct the path
    # at the goal without carrying per-node op lists.
    parent: dict = {init_key: None}
    stack = [(init_key, INIT_STATE)]
    budget = node_budget
    goal = None
    while stack:
        key, state = stack.pop()
        counts_t = key[0]
        if counts_t == tt:
            goal = (key, state)
            break
        nxt, cand = _next_cands(history, counts_t)
        for c in cand:
            if counts_t[c] >= tt[c]:
                continue
            j = nxt[c]
            op = history.ops[j]
            nct = counts_t[:c] + (counts_t[c] + 1,) + counts_t[c + 1 :]
            for ns in step_set([state], op.inp, op.out):
                nkey = (nct, (ns.tail, ns.stream_hash, ns.fencing_token))
                if nkey in parent:
                    continue
                budget -= 1
                if budget <= 0:
                    log.warning(
                        "refusal diagnostics exhausted the %d-node budget",
                        node_budget,
                    )
                    return None, None
                parent[nkey] = (key, j)
                stack.append((nkey, ns))
    if goal is None:
        log.warning("deepest configuration not re-derivable; no diagnostics")
        return None, None
    order: list[int] = []
    key = goal[0]
    while parent[key] is not None:
        key, j = parent[key]
        order.append(j)
    order.reverse()
    return order, goal[1]


def deepest_refusals(
    history: History,
    deepest: list[int],
    node_budget: int = 200_000,
) -> tuple[list[int], list[int]] | None:
    """(deepest prefix ops in one valid linearization order, ops refusing
    to linearize there), or None when the prefix cannot be re-derived
    inside ``node_budget`` DFS nodes."""
    target = _counts_of_deepest(history, deepest)
    if target is None:
        log.warning("deepest set is not a per-chain prefix; no diagnostics")
        return None
    tt = tuple(target)
    order, goal_state = _derive_from_counts(history, tt, node_budget)
    if order is None:
        return None
    nxt, cand = _next_cands(history, tt)
    refused = [
        nxt[c]
        for c in cand
        if not step_set([goal_state], history.ops[nxt[c]].inp, history.ops[nxt[c]].out)
    ]
    return order, sorted(refused)
