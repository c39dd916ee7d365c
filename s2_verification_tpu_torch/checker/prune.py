"""Commutativity pruning: static interleaving analysis over one history.

The port's own copy of the JAX package's ``checker/prune.py`` (numpy
only, imported by nothing of that package), held against it by
``tests/test_torch_prune.py``.

The Wing–Gong search explores every admissible interleaving of concurrent
ops, but under the S2 Step kernel (models/stream.py) large families of
those interleavings are provably equivalent or provably dead, and both
facts are visible *statically* — from the observed outputs alone, before
any state is materialized.  This module derives three sound artifacts
(the DPOR move, specialized to the S2 model's monotone-tail structure):

**1. Append rank order** (``app_rank`` / ``minrank_tab``).  A successful
append with ``num_records >= 1`` moves the tail from ``out_tail - n`` to
``out_tail``; tails are monotone along every linearization, so two such
appends with distinct ``out_tail`` linearize in ``out_tail`` order in
*every* accepting interleaving — the pair commutes in the DPOR sense that
only one order ever needs exploring.  The search gates a ranked candidate
out of the window unless its rank is the minimum remaining rank: the
gated branches provably never accept, so OK *and* ILLEGAL verdicts are
both preserved (this is an exact prune, unlike the beam).  Appends
sharing an ``out_tail`` (never both acceptable, but order unprovable) and
zero-record appends are conservatively left unranked.

**2. Eager commit** (``inert`` / ``filter_succ``).  Reads and check_tails
never mutate state — ``step`` either returns ``{s}`` or ``{}`` — so a
candidate filter that *passes* the current state is an identity op there,
and any accepting continuation that linearizes it later can be reordered
to linearize it now (every other op sees the same states; the candidate
window only loosens).  The engines fold such ops into the auto-close
sweep: committed immediately, per single-state row on device, and only
when they pass **all** states of a configuration's set on the host (a
partial pass filters the set and is not an identity).  Inert ops
(definite failures — normally elided at prepare, but present under
``elide_trivial=False`` — and failed filters) commit unconditionally.

**3. Tail pins** (``pintail_tab``).  A successful filter observing
``out_tail = t`` can only linearize at a state whose tail *is* ``t``, and
a successful append with ``out_tail = t`` only at tail ``t - n``.  Tails
never decrease, so a configuration whose tail has passed the smallest
such pin among its remaining ops can never linearize that op — the row is
dead forever and is dropped.  On the adversarial k-family this collapses
the frontier from all ordered subsets to those at or below the pinning
read's tail (~99.7% of rows at k=10).

All three prunes are **verdict-exact**: they only remove interleavings
with no accepting extension (rank, pins) or with an equivalent retained
representative (eager commit), so OK, ILLEGAL and UNKNOWN all match the
un-pruned engines — the property ``chip_smoke.py``'s campaign matrix
enforces differentially on the card.  They assume tails do not wrap
u32 mid-history, the same monotonicity assumption the auto-close rules
already make (checker/device.py `_auto_close`).

The pairwise facts are also exposed directly (:func:`classify_pair`,
:func:`order_mask`) for unit coverage and for the canonical-order mask
the encoded tables summarize.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.encode import op_class_masks
from ..models.stream import APPEND

__all__ = [
    "RANK_INF",
    "PIN_INF",
    "FREE",
    "ORDERED",
    "CONFLICT",
    "PruneTables",
    "HostPrunePlan",
    "classify_pair",
    "commutes",
    "order_mask",
    "analyze_encoded",
    "analyze_history",
    "neutral_tables",
]

#: pair classes: FREE — order irrelevant (both orders reach identical
#: state sets); ORDERED — order statically forced (the canonical-order
#: mask fixes it; only one order can ever appear in an accepting
#: linearization); CONFLICT — no static fact, both orders explored.
FREE, ORDERED, CONFLICT = "free", "ordered", "conflict"

#: rank sentinel for unranked ops in the int32 tables
RANK_INF = np.int32(2**31 - 1)
#: pin sentinel (no pin) in the uint32 tables
PIN_INF = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Op classification (History-level; the encoded path mirrors these rules
# on the packed arrays)
# ---------------------------------------------------------------------------


def _is_inert(op) -> bool:
    """Identity on every state: definite failures (any type) and failed
    filters (read/check_tail failures are definite and guard nothing)."""
    if op.out.failure and op.out.definite_failure:
        return True
    return op.inp.input_type != APPEND and op.out.failure


def _is_filter_success(op) -> bool:
    return op.inp.input_type != APPEND and not op.out.failure


def _is_append_success(op) -> bool:
    return op.inp.input_type == APPEND and not op.out.failure


def _pin_of(op) -> int | None:
    """The unique tail this op can linearize at, if statically known."""
    if _is_filter_success(op):
        return int(op.out.tail) & 0xFFFFFFFF
    if _is_append_success(op):
        n = int(op.inp.num_records or 0)
        t = int(op.out.tail) & 0xFFFFFFFF
        if t >= n:  # no-wrap guard; wrapped tails stay unpinned
            return t - n
    return None


def classify_pair(op_i, op_j) -> str:
    """Statically classify the interleaving freedom of two ops.

    Returns :data:`FREE` when both orders provably reach identical state
    sets, :data:`ORDERED` when monotone tails force one order in every
    accepting linearization, :data:`CONFLICT` otherwise.  Used for tests
    and the explicit :func:`order_mask`; the engines consume the O(N)
    rank/pin summaries instead.
    """
    # Identity ops commute with everything: they always pass and never
    # move state, so both orders compose to the other op's step.
    if _is_inert(op_i) or _is_inert(op_j):
        return FREE

    fi, fj = _is_filter_success(op_i), _is_filter_success(op_j)
    ai, aj = _is_append_success(op_i), _is_append_success(op_j)

    if fi and fj:
        ti = int(op_i.out.tail) & 0xFFFFFFFF
        tj = int(op_j.out.tail) & 0xFFFFFFFF
        hi, hj = op_i.out.stream_hash, op_j.out.stream_hash
        if ti == tj:
            # Same committed prefix observed: both pass exactly at states
            # with that tail (and matching hash); each is identity there.
            if hi is None or hj is None or hi == hj:
                return FREE
            # Overlapping reads: same range, conflicting contents — they
            # can never both pass on one path, and neither order is
            # statically preferable.
            return CONFLICT
        # Disjoint committed ranges: the lower observation must precede
        # the higher one (tails are monotone), so the order is forced.
        return ORDERED

    if ai and aj:
        ni = int(op_i.inp.num_records or 0)
        nj = int(op_j.inp.num_records or 0)
        ti = int(op_i.out.tail) & 0xFFFFFFFF
        tj = int(op_j.out.tail) & 0xFFFFFFFF
        if ni >= 1 and nj >= 1 and ti != tj:
            return ORDERED
        return CONFLICT

    if (fi and aj) or (fj and ai):
        # Filter observing t vs append covering (a-n, a]: the filter
        # linearizes strictly outside the append's record range on every
        # accepting path, which fixes the order; an observation *inside*
        # the range can never linearize at all (the tail jumps across it),
        # which is a history-level inconsistency, not a static order.
        f_op, a_op = (op_i, op_j) if fi else (op_j, op_i)
        t = int(f_op.out.tail) & 0xFFFFFFFF
        a = int(a_op.out.tail) & 0xFFFFFFFF
        n = int(a_op.inp.num_records or 0)
        if n >= 1:
            if t <= a - n:
                return ORDERED  # filter strictly before the append
            if t >= a:
                return ORDERED  # append strictly before the filter
        return CONFLICT

    # At least one indefinite append / token mutator: fencing ops never
    # commute statically (their effect branch depends on the path).
    return CONFLICT


def commutes(op_i, op_j) -> bool:
    """True iff only one interleaving order of the pair needs exploring
    (the pair is FREE or statically ORDERED)."""
    return classify_pair(op_i, op_j) is not CONFLICT


def order_mask(history) -> np.ndarray:
    """Canonical-order mask: ``mask[i, j]`` iff op ``i`` must precede op
    ``j`` in every accepting linearization (the ORDERED pairs, oriented).

    O(N^2); meant for tests and small-history introspection — the engines
    consume the O(N) rank/pin tables, which summarize exactly this
    relation's append chain.  The mask is canonical: antisymmetric and
    transitively closed over the static order (both properties are what
    tests/test_torch_prune.py asserts).
    """
    ops = history.ops
    n = len(ops)
    mask = np.zeros((n, n), bool)

    def sort_key(op):
        # Position of the op on the tail axis: filters sit AT their
        # observed tail, appends END at theirs (and so sort after a
        # filter observing their start).
        t = int(op.out.tail) & 0xFFFFFFFF
        return (t, 0 if _is_filter_success(op) else 1)

    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if classify_pair(ops[i], ops[j]) is ORDERED:
                if sort_key(ops[i]) < sort_key(ops[j]):
                    mask[i, j] = True
    return mask


# ---------------------------------------------------------------------------
# Host plan (check_frontier)
# ---------------------------------------------------------------------------


@dataclass
class HostPrunePlan:
    """Prune artifacts for the host frontier search, op-index keyed."""

    #: op index -> rank in the forced append order (dense from 0)
    rank: dict[int, int] = field(default_factory=dict)
    #: minrank[c][k]: min rank among chain c ops at positions >= k
    minrank: list[list[int]] = field(default_factory=list)
    #: pin[c][k]: min tail pin among chain c ops at positions >= k
    pin: list[list[int]] = field(default_factory=list)
    #: ops that are identity on every state
    inert: set[int] = field(default_factory=set)
    #: successful filters: op index -> (out_tail, out stream_hash | None)
    filter_guard: dict[int, tuple[int, object]] = field(default_factory=dict)

    @property
    def n_ranked(self) -> int:
        return len(self.rank)

    def min_remaining_rank(self, counts) -> int:
        return min(
            (self.minrank[c][counts[c]] for c in range(len(counts))),
            default=int(RANK_INF),
        )

    def min_pin(self, counts) -> int:
        return min(
            (self.pin[c][counts[c]] for c in range(len(counts))),
            default=int(PIN_INF),
        )


def _rank_appends(ops, indices) -> dict[int, int]:
    """Dense out_tail ranks over the ranked-append subset of ``indices``.

    Duplicated out_tails disqualify the whole duplicate group (the order
    within it is not statically provable), matching the conservative
    exclusions documented in the module header.
    """
    ranked = [
        j
        for j in indices
        if _is_append_success(ops[j]) and int(ops[j].inp.num_records or 0) >= 1
    ]
    tails: dict[int, list[int]] = {}
    for j in ranked:
        tails.setdefault(int(ops[j].out.tail) & 0xFFFFFFFF, []).append(j)
    unique = sorted(t for t, js in tails.items() if len(js) == 1)
    return {tails[t][0]: r for r, t in enumerate(unique)}


def analyze_history(history) -> HostPrunePlan:
    """Build the host prune plan from a prepared History."""
    ops = history.ops
    chains = history.chains
    plan = HostPrunePlan()
    plan.rank = _rank_appends(ops, range(len(ops)))
    for c, chain in enumerate(chains):
        ln = len(chain)
        mr = [int(RANK_INF)] * (ln + 1)
        pn = [int(PIN_INF)] * (ln + 1)
        for k in range(ln - 1, -1, -1):
            j = chain[k]
            r = plan.rank.get(j, int(RANK_INF))
            p = _pin_of(ops[j])
            mr[k] = min(mr[k + 1], r)
            pn[k] = min(pn[k + 1], p if p is not None else int(PIN_INF))
        plan.minrank.append(mr)
        plan.pin.append(pn)
    for j, op in enumerate(ops):
        if _is_inert(op):
            plan.inert.add(j)
        elif _is_filter_success(op):
            plan.filter_guard[j] = (
                int(op.out.tail) & 0xFFFFFFFF,
                op.out.stream_hash,
            )
    return plan


# ---------------------------------------------------------------------------
# Encoded tables (the device search)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PruneTables:
    """Numpy prune tables over an EncodedHistory (device layout).

    Neutral values (RANK_INF ranks, PIN_INF pins, all-false masks) make
    every consumer a no-op with an identical compiled graph — pruning
    on/off is a table-content change, not a retrace.
    """

    app_rank: np.ndarray  # [N] int32; RANK_INF = unranked
    minrank_tab: np.ndarray  # [C, Lc+1] int32 suffix-min rank
    pintail_tab: np.ndarray  # [C, Lc+1] uint32 suffix-min tail pin
    inert: np.ndarray  # [N] bool
    filter_succ: np.ndarray  # [N] bool (successful read/check_tail)
    n_ranked: int


def neutral_tables(n_ops: int, chain_shape: tuple[int, int]) -> PruneTables:
    c, lc = chain_shape
    return PruneTables(
        app_rank=np.full(n_ops, RANK_INF, np.int32),
        minrank_tab=np.full((c, lc + 1), RANK_INF, np.int32),
        pintail_tab=np.full((c, lc + 1), PIN_INF, np.uint32),
        inert=np.zeros(n_ops, bool),
        filter_succ=np.zeros(n_ops, bool),
        n_ranked=0,
    )


def analyze_encoded(enc) -> PruneTables:
    """Build the encoded prune tables.  Only ops reachable through the
    chain tables are classified — padded rows (which masquerade as
    zero-record appends) never receive ranks, pins, or eager masks."""
    n = int(enc.op_type.shape[0])
    c, lc = enc.chain_ops.shape
    t = neutral_tables(n, (c, lc))
    app_rank = t.app_rank.copy()
    minrank_tab = t.minrank_tab.copy()
    pintail_tab = t.pintail_tab.copy()
    inert = t.inert.copy()
    filter_succ = t.filter_succ.copy()

    live = [
        int(enc.chain_ops[ci, k])
        for ci in range(c)
        for k in range(int(enc.chain_len[ci]))
    ]

    masks = op_class_masks(enc)
    app_succ = masks["app_succ"]
    filt_succ = masks["filter_succ"]
    is_inert = masks["inert"]

    tails: dict[int, list[int]] = {}
    for j in live:
        if app_succ[j] and int(enc.num_records[j]) >= 1:
            tails.setdefault(int(enc.out_tail[j]), []).append(j)
        inert[j] = bool(is_inert[j])
        filter_succ[j] = bool(filt_succ[j])
    unique = sorted(tl for tl, js in tails.items() if len(js) == 1)
    for r, tl in enumerate(unique):
        app_rank[tails[tl][0]] = r

    def pin_of(j: int) -> int:
        if filt_succ[j]:
            return int(enc.out_tail[j])
        if app_succ[j]:
            nr = int(enc.num_records[j])
            tl = int(enc.out_tail[j])
            if tl >= nr:
                return tl - nr
        return int(PIN_INF)

    for ci in range(c):
        ln = int(enc.chain_len[ci])
        for k in range(ln - 1, -1, -1):
            j = int(enc.chain_ops[ci, k])
            minrank_tab[ci, k] = min(minrank_tab[ci, k + 1], app_rank[j])
            pintail_tab[ci, k] = min(int(pintail_tab[ci, k + 1]), pin_of(j))

    return PruneTables(
        app_rank=app_rank,
        minrank_tab=minrank_tab,
        pintail_tab=pintail_tab,
        inert=inert,
        filter_succ=filter_succ,
        n_ranked=len(unique),
    )
