"""Frontier (breadth-first) linearizability search — host reference.

The port's own copy of the JAX package's ``checker/frontier.py`` (plain
Python, imported by nothing of that package; its statistics are the one
:class:`.stats.FrontierStats` of the port), held against it by
``tests/test_torch_frontier.py``.  It is the ``check -backend=frontier``
engine.

This is the algorithm the device search executes, in plain python, used both as
its differential oracle and as the place the invariants are documented.  It
is DFS-equivalent in verdict (explores the same reachable configuration
graph as the Wing–Gong search in checker/oracle.py) but executes layer by
layer so every step is a dense, batched map over a *frontier* — the shape
that batches onto the GPU.

Key structural facts it exploits (see checker/entries.py):

- Ops within a chain (client id) are sequential, so a configuration's
  linearized set is one prefix counter per chain — no op bitset.
- A configuration is ``(counts, state-set)``; two configurations with equal
  counts and equal state sets have identical futures, so layers dedup on
  exactly that pair (the frontier twin of Lowe's memoization).
- Candidate rule: chain c's next op j can linearize iff ``call[j] < m`` where
  ``m`` is the minimum return time over *all* unlinearized ops — and since
  returns are increasing within a chain, ``m`` is the min over chains of the
  next op's return.
- BFS layers are exhaustive: every linearization has length N, success iff
  some configuration completes all chains, failure iff a layer is empty.

The JAX engine's prefix resume and snapshot cuts (``init_counts``,
``init_states``, ``snapshot_cuts``, ``complete_cuts``, ``state_digest``)
and its ``progress`` sink serve that package's ``checker/prefix.py``,
``service/distsearch.py`` and daemon, which the port does not have yet;
they come with the slice that ports those callers.

**Auto-close** (an optimization the reference's Porcupine search lacks):
an indefinite-failure append whose effect branch is *dead forever* — its
``match_seq_num`` is below every candidate state's tail (tails are
monotone), or its fencing token can no longer match (no remaining op sets
it) — steps every state to itself.  Linearizing it immediately, without
forking a child, is sound (nothing is lost: its only surviving branch
changes no state) and complete (it must be linearized eventually and the
position no longer matters).  Without this, the open ops left behind by
client rotation multiply candidate positions combinatorially — this is
precisely what makes adversarial histories CPU-intractable for Porcupine.
"""

from __future__ import annotations

import time
import zlib

from ..models.stream import APPEND, INIT_STATE, StreamState, step_set
from .entries import History, Op
from .oracle import CheckOutcome, CheckResult
from .stats import FrontierStats

__all__ = ["check_frontier", "check_frontier_auto", "FrontierStats"]


def _state_canon(s: StreamState) -> str:
    """The canonical text of one stream state."""
    return f"{s.tail}:{s.stream_hash}:{s.fencing_token!r}"


def _cfg_digest(cfg) -> int:
    """Deterministic (PYTHONHASHSEED-independent) beam tie-break digest."""
    counts, states = cfg
    parts = [",".join(map(str, counts))]
    for s in sorted(states):
        parts.append(_state_canon(s))
    return zlib.crc32("|".join(parts).encode())


def _op_dead_forever(
    op: Op, states: frozenset[StreamState], settable_tokens: frozenset[str]
) -> bool:
    """True if an indefinite append's effect branch can never fire again."""
    if not op.is_indefinite_append:
        return False
    inp = op.inp
    if inp.match_seq_num is not None:
        # Tails are monotone along every path; once every candidate state's
        # tail has passed the guard, the effect can never apply.
        if all(s.tail > inp.match_seq_num for s in states):
            return True
    if inp.batch_fencing_token is not None:
        token = inp.batch_fencing_token
        if all(s.fencing_token != token for s in states) and token not in settable_tokens:
            return True
    return False


def check_frontier(
    history: History,
    auto_close: bool = True,
    max_frontier: int | None = None,
    beam: bool = False,
    collect_stats: bool = False,
    witness: bool = True,
    profile: bool = False,
    time_budget_s: float | None = None,
    prune: bool = False,
) -> CheckResult:
    """Decide linearizability by frontier BFS.  Verdict matches the DFS.

    With ``beam=True``, layers exceeding ``max_frontier`` are *pruned* to the
    best configurations (fewest linearized indefinite appends — the lazy
    order — then deterministic hash) instead of aborting.  An OK under
    pruning is still sound (any accepting path proves linearizability); a
    dead end after pruning is inconclusive and reported UNKNOWN — callers
    escalate to an exhaustive pass (see :func:`check_frontier_auto`).

    ``witness=True`` keeps parent links for every configuration generated so
    an accepting path can be walked back into a concrete linearization —
    O(visited configs) extra memory (comparable to the DFS memo cache);
    pass ``witness=False`` for verdict-only runs.

    ``profile=True`` (implies ``collect_stats``) additionally records a
    per-layer timeline — frontier width, layer-max state-set size, ops
    auto-closed in the layer, and elapsed wall seconds — on
    ``stats.timeline``, the raw material for the viz frontier panel and
    the daemon's per-job ``profile`` field.

    ``time_budget_s`` bounds the search wall clock (checked per layer);
    expiry returns UNKNOWN, matching the other engines' budget semantics.

    ``prune=True`` activates the verdict-exact commutativity prunes
    (checker/prune.py): eager commit of inert / passing-filter candidates
    inside the auto-close sweep, the append rank gate, and tail-pin
    dead-configuration elimination.  All three preserve OK, ILLEGAL *and*
    UNKNOWN (they never set ``stats.pruned``).
    """
    collect_stats = collect_stats or profile
    ops = history.ops
    chains = history.chains
    n_chains = len(chains)
    stats = FrontierStats()

    if not ops:
        return CheckResult(CheckOutcome.OK, linearization=[], final_states=[INIT_STATE])

    settable_tokens = frozenset(
        op.inp.set_fencing_token
        for op in ops
        if op.inp.input_type == APPEND and op.inp.set_fencing_token is not None
    )

    init_counts = tuple(0 for _ in range(n_chains))
    init_cfg = (init_counts, frozenset([INIT_STATE]))
    frontier: dict[tuple[tuple[int, ...], frozenset[StreamState]], None] = {
        init_cfg: None
    }

    plan = None
    if prune:
        from .prune import analyze_history

        plan = analyze_history(history)
    # Witness links: cfg -> (parent cfg, ops auto-closed at the parent's
    # layer, the expanded op) — walked backwards on accept to recover a
    # concrete linearization (same role as the device engine's witness log).
    parents: dict = {init_cfg: None} if witness else {}
    # Deepest committed prefix across the whole search (diagnostics parity
    # with the oracle's global best, oracle.py:130).
    deep_counts = init_counts
    deep_sum = 0

    def walk(cfg) -> list[int]:
        rev: list[int] = []
        while parents[cfg] is not None:
            cfg, closed_ops, op_index = parents[cfg]
            rev.append(op_index)
            rev.extend(reversed(closed_ops))
        rev.reverse()
        return rev

    def completion(counts) -> list[int]:
        # Remaining ops are all indefinite appends: call order respects both
        # chain order and real time, and each no-effect step is valid.
        rest = [
            chains[c][k]
            for c in range(n_chains)
            for k in range(counts[c], len(chains[c]))
        ]
        rest.sort(key=lambda j: ops[j].call)
        return rest

    def deepest_of(counts) -> list[int]:
        return [chains[c][k] for c in range(n_chains) for k in range(counts[c])]

    # Per-chain prefix counts of indefinite appends, for the relaxed
    # acceptance test and the lazy beam ranking.
    open_prefix = [
        [0] * (len(chain) + 1) for chain in chains
    ]
    for c, chain in enumerate(chains):
        for k, op_index in enumerate(chain):
            open_prefix[c][k + 1] = open_prefix[c][k] + int(
                ops[op_index].is_indefinite_append
            )

    def accepting(counts) -> bool:
        """All remaining ops are indefinite appends.

        Such ops step every non-empty state set to a non-empty superset-or-
        self, and once only they remain every one of them is a candidate, so
        they can be linearized in any order — the configuration is accepted
        without materializing those 2^(remaining) layers.
        """
        for c in range(n_chains):
            remaining = len(chains[c]) - counts[c]
            if remaining and (
                open_prefix[c][-1] - open_prefix[c][counts[c]] != remaining
            ):
                return False
        return True

    def opens_taken(counts) -> int:
        return sum(open_prefix[c][counts[c]] for c in range(n_chains))

    def next_op(counts, c) -> Op | None:
        if counts[c] >= len(chains[c]):
            return None
        return ops[chains[c][counts[c]]]

    def window(counts) -> tuple[int, list[int]]:
        """(m, candidate chains) for a configuration."""
        m = None
        for c in range(n_chains):
            op = next_op(counts, c)
            if op is not None and (m is None or op.ret < m):
                m = op.ret
        cands = []
        for c in range(n_chains):
            op = next_op(counts, c)
            if op is not None and op.call < m:
                cands.append(c)
        return m, cands

    def auto_close_config(counts, states):
        closed_ops: list[int] = []
        if not auto_close:
            return counts, states, closed_ops
        counts = list(counts)
        changed = True
        while changed:
            changed = False
            _, cands = window(tuple(counts))
            for c in cands:
                op = next_op(tuple(counts), c)
                eager = False
                if plan is not None:
                    j = chains[c][counts[c]]
                    if j in plan.inert:
                        eager = True
                    else:
                        guard = plan.filter_guard.get(j)
                        if guard is not None:
                            t, hsh = guard
                            # Identity only where it passes EVERY state —
                            # a partial pass filters the set.
                            eager = all(
                                s.tail == t
                                and (hsh is None or s.stream_hash == hsh)
                                for s in states
                            )
                if eager or _op_dead_forever(op, states, settable_tokens):
                    closed_ops.append(chains[c][counts[c]])
                    counts[c] += 1
                    if eager:
                        stats.prune_commits += 1
                    else:
                        stats.auto_closed += 1
                    changed = True
        return tuple(counts), states, closed_ops

    # Per-layer profiling state: `entry` is the timeline dict under
    # construction; _finish_layer() seals it at every layer exit point.
    t_search = time.monotonic()
    entry: dict | None = None
    layer_states = 0
    auto_before = 0

    def _finish_layer() -> None:
        if entry is not None:
            entry["states"] = layer_states
            entry["auto_closed"] = stats.auto_closed - auto_before
            entry["elapsed_s"] = round(time.monotonic() - t_search, 6)

    deadline = None if time_budget_s is None else t_search + time_budget_s

    def _done(res: CheckResult) -> CheckResult:
        _finish_layer()
        if collect_stats:
            res.stats = stats  # type: ignore[attr-defined]
        return res

    layer = 0
    while True:
        layer += 1
        stats.layers = layer
        if deadline is not None and time.monotonic() > deadline:
            return _done(CheckResult(CheckOutcome.UNKNOWN, deepest=deepest_of(deep_counts)))
        stats.max_frontier = max(stats.max_frontier, len(frontier))
        layer_states = 0
        if profile:
            auto_before = stats.auto_closed
            entry = {
                "layer": layer,
                "frontier": len(frontier),
                "states": 0,
                "auto_closed": 0,
                "elapsed_s": 0.0,
            }
            stats.timeline.append(entry)

        closed: dict[tuple[tuple[int, ...], frozenset[StreamState]], None] = {}
        #: post-close cfg -> (pre-close cfg, ops closed getting there)
        close_link: dict = {}
        for counts, states in frontier:
            pre = (counts, states)
            counts, states, closed_ops = auto_close_config(counts, states)
            key = (counts, states)
            if key not in closed:
                closed[key] = None
                close_link[key] = (pre, closed_ops)

        for counts, states in closed:
            csum = sum(counts)
            if csum > deep_sum:
                deep_sum, deep_counts = csum, counts
            if accepting(counts):
                stats.max_state_set = max(stats.max_state_set, len(states))
                layer_states = max(layer_states, len(states))
                if witness:
                    pre, closed_ops = close_link[(counts, states)]
                    order = walk(pre) + closed_ops + completion(counts)
                else:
                    order = None
                return _done(
                    CheckResult(
                        CheckOutcome.OK,
                        linearization=order,
                        deepest=order or [],
                        final_states=sorted(states),
                    )
                )

        children: dict[tuple[tuple[int, ...], frozenset[StreamState]], None] = {}
        for counts, states in closed:
            if plan is not None and min(s.tail for s in states) > plan.min_pin(counts):
                # Every state's tail has passed the smallest pin among the
                # remaining ops: that op can never linearize from here, so
                # no accepting extension exists — exact, unlike the beam.
                stats.prune_dead += 1
                continue
            pre, closed_ops = close_link[(counts, states)]
            _, cands = window(counts)
            minrank = plan.min_remaining_rank(counts) if plan is not None else None
            for c in cands:
                if plan is not None:
                    r = plan.rank.get(chains[c][counts[c]])
                    if r is not None and r > minrank:
                        # A later-ranked append before an earlier-ranked
                        # one cannot appear in any accepting
                        # linearization (tails are monotone).
                        stats.prune_ranked += 1
                        continue
                op = next_op(counts, c)
                new_states = step_set(sorted(states), op.inp, op.out)
                stats.expanded += 1
                if not new_states:
                    continue
                stats.max_state_set = max(stats.max_state_set, len(new_states))
                layer_states = max(layer_states, len(new_states))
                child_counts = counts[:c] + (counts[c] + 1,) + counts[c + 1 :]
                child = (child_counts, frozenset(new_states))
                if child not in children:
                    children[child] = None
                    if witness and child not in parents:
                        parents[child] = (pre, tuple(closed_ops), chains[c][counts[c]])

        if not children:
            outcome = CheckOutcome.UNKNOWN if stats.pruned else CheckOutcome.ILLEGAL
            return _done(CheckResult(outcome, deepest=deepest_of(deep_counts)))
        if max_frontier is not None and len(children) > max_frontier:
            if not beam:
                return _done(CheckResult(CheckOutcome.UNKNOWN, deepest=deepest_of(deep_counts)))
            stats.pruned = True
            ranked = sorted(
                children, key=lambda cfg: (opens_taken(cfg[0]), _cfg_digest(cfg))
            )
            children = dict.fromkeys(ranked[:max_frontier])
        _finish_layer()
        frontier = children


def check_frontier_auto(
    history: History,
    beam_width: int = 4096,
    exhaustive_cap: int | None = None,
    collect_stats: bool = False,
    witness: bool = True,
    profile: bool = False,
    time_budget_s: float | None = None,
    prune: bool = False,
) -> CheckResult:
    """Beam-first frontier check with exhaustive escalation.

    Phase 1 runs a pruned (beam) search: fast, and an OK is conclusive.
    Only if the beam dead-ends after pruning does phase 2 re-run without a
    beam — the porcupine-equivalent exhaustive search (optionally bounded by
    ``exhaustive_cap``, beyond which the result is UNKNOWN).  With
    ``profile=True`` the returned stats/timeline describe the phase that
    produced the verdict (the exhaustive pass, when it ran).
    """
    res = check_frontier(
        history,
        max_frontier=beam_width,
        beam=True,
        collect_stats=collect_stats,
        witness=witness,
        profile=profile,
        time_budget_s=time_budget_s,
        prune=prune,
    )
    if res.outcome != CheckOutcome.UNKNOWN:
        return res
    return check_frontier(
        history,
        max_frontier=exhaustive_cap,
        collect_stats=collect_stats,
        witness=witness,
        profile=profile,
        time_budget_s=time_budget_s,
        prune=prune,
    )
