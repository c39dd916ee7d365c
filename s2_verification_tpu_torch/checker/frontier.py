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

**Prefix resume & snapshot cuts** (the incremental-verification engine,
see checker/prefix.py): because ops are call-ordered, a boundary after op
K with ``max(ret of ops[:K]) < min(call of ops[K:])`` is *prefix-closed* —
the candidate rule forces every linearization to commit exactly
``ops[:K]`` before any later op.  ``step_set`` distributes over unions of
state sets and the candidate/acceptance rules depend only on counts, so
the *union* of every reachable state set at that cut is a single carried
configuration that is verdict-equivalent to restarting from op 0:
resume-OK iff cold-OK, provided the union is exact.  ``check_frontier``
therefore accepts ``init_counts``/``init_states`` (resume from a carried
cut) and ``snapshot_cuts`` (collect those unions during the search); a
cut's union is only *complete* — and only then emitted on
``res.snapshots`` — once every configuration in a layer has linearized
past it, and any beam prune invalidates cuts not yet complete (a pruned
branch could have contributed states; a subset union can produce a false
ILLEGAL on resume, which is exactly the unsoundness the completeness rule
exists to prevent).

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
from bisect import bisect_left
from typing import Iterable

from ..models.stream import APPEND, INIT_STATE, StreamState, step_set
from .entries import History, Op
from .oracle import CheckOutcome, CheckResult
from .stats import FrontierStats

__all__ = ["check_frontier", "check_frontier_auto", "FrontierStats", "state_digest"]


def _state_canon(s: StreamState) -> str:
    """The canonical text of one stream state — the digest's sole input."""
    return f"{s.tail}:{s.stream_hash}:{s.fencing_token!r}"


def state_digest(s: StreamState) -> int:
    """Deterministic 32-bit digest of a single stream state.

    The same canon the beam tie-break digest folds per state; exposed so
    a distributed search can partition a frontier union into disjoint
    digest ranges that both ends of the wire compute identically
    (PYTHONHASHSEED-independent, like every digest in this module).
    """
    return zlib.crc32(_state_canon(s).encode())


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
    init_counts: tuple[int, ...] | None = None,
    init_states: Iterable[StreamState] | None = None,
    snapshot_cuts: Iterable[int] | None = None,
    complete_cuts: bool = False,
    time_budget_s: float | None = None,
    progress=None,
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

    ``init_counts``/``init_states`` resume the search from a carried cut:
    the caller asserts the boundary was prefix-closed and the states are
    the exact reachable-state union there (checker/prefix.py produces
    both).  A resumed OK linearization covers only the ops searched here.

    ``snapshot_cuts`` is a set of op boundaries K (each prefix-closed, as
    computed by :func:`..checker.prefix.closed_boundaries`); on an OK
    verdict the result carries ``res.snapshots`` — ``{K: sorted state
    union}`` for every cut whose union completed before any prune.

    ``complete_cuts=True`` holds an accept until every requested cut's
    union is complete: the relaxed acceptance (all remaining ops are
    indefinite appends) normally ends the search without materializing
    those layers, which leaves a requested cut below the frontier floor
    incomplete — an OK *without* its end union.  Distributed partition
    searches (service/distsearch.py) need the union itself, so they pay
    for the held layers; the verdict is unchanged, only the return is
    deferred until the unions are exact.

    ``time_budget_s`` bounds the search wall clock (checked per layer);
    expiry returns UNKNOWN, matching the other engines' budget semantics.

    ``progress`` is an optional :class:`.progress.ProgressSink`: each
    layer offers ``(ops committed, total ops, frontier width, states
    expanded)`` and the sink time-gates what actually leaves — one clock
    read per layer on the fast path.

    ``prune=True`` activates the verdict-exact commutativity prunes
    (checker/prune.py): eager commit of inert / passing-filter candidates
    inside the auto-close sweep, the append rank gate, and tail-pin
    dead-configuration elimination.  All three preserve OK, ILLEGAL *and*
    UNKNOWN (they never set ``stats.pruned``).  While ``snapshot_cuts``
    are collecting, the rank gate and pin kill stand down — gated branches
    never accept but can still contribute states to a cut union, and the
    snapshot contract promises the *exact* reachable union (see
    checker/prefix.py); eager commit reaches identical unions (filters are
    identity where they commit) and stays active.
    """
    collect_stats = collect_stats or profile
    ops = history.ops
    chains = history.chains
    n_chains = len(chains)
    stats = FrontierStats()

    if not ops:
        start = sorted(init_states) if init_states else [INIT_STATE]
        return CheckResult(CheckOutcome.OK, linearization=[], final_states=start)

    settable_tokens = frozenset(
        op.inp.set_fencing_token
        for op in ops
        if op.inp.input_type == APPEND and op.inp.set_fencing_token is not None
    )

    if init_counts is None:
        init_counts = tuple(0 for _ in range(n_chains))
    else:
        init_counts = tuple(init_counts)
    start_states = (
        frozenset(init_states) if init_states is not None else frozenset([INIT_STATE])
    )
    init_cfg = (init_counts, start_states)
    frontier: dict[tuple[tuple[int, ...], frozenset[StreamState]], None] = {
        init_cfg: None
    }
    base_sum = sum(init_counts)

    # Snapshot-cut table: K -> [expected counts at the cut, state union,
    # complete?].  The counts at a closed cut are forced (every
    # linearization of K ops commits exactly ops[:K]), so they are derived
    # from chain membership, and noting a config is a sum lookup plus an
    # equality check that doubles as a self-test of closedness.
    cuts: dict[int, list] = {}
    for K in sorted(set(snapshot_cuts or ())):
        if base_sum < K <= len(ops):
            counts_k = tuple(bisect_left(chain, K) for chain in chains)
            cuts[K] = [counts_k, set(), False]

    def note_cut(counts, states) -> None:
        cut = cuts.get(sum(counts))
        if cut is not None and not cut[2] and counts == cut[0]:
            cut[1].update(states)

    plan = None
    if prune:
        from .prune import analyze_history

        plan = analyze_history(history)
    # Rank gate + pin kill vs snapshot cuts: see the docstring — both
    # stand down while cuts are collecting so unions stay exact.
    order_prunes = plan is not None and not cuts
    # Witness links: cfg -> (parent cfg, ops auto-closed at the parent's
    # layer, the expanded op) — walked backwards on accept to recover a
    # concrete linearization (same role as the device engine's witness log).
    parents: dict = {init_cfg: None} if witness else {}
    target = tuple(len(c) for c in chains)
    # Deepest committed prefix across the whole search (diagnostics parity
    # with the oracle's global best, oracle.py:130).
    deep_counts = init_counts
    deep_sum = sum(init_counts)

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
                    if cuts:
                        # Auto-close leaves states untouched, so each
                        # intermediate position is a reachable cut config.
                        note_cut(tuple(counts), states)
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

    def _ok_result(order, final_states) -> CheckResult:
        res = CheckResult(
            CheckOutcome.OK,
            linearization=order,
            deepest=order or [],
            final_states=final_states,
        )
        if cuts:
            snaps = {
                K: sorted(cut[1])
                for K, cut in cuts.items()
                if cut[2] and cut[1]
            }
            if snaps:
                res.snapshots = snaps  # type: ignore[attr-defined]
        if collect_stats:
            res.stats = stats  # type: ignore[attr-defined]
        return res

    #: first accepting configuration seen while ``complete_cuts`` holds
    #: the return open (the verdict; only the unions are still cooking)
    held: tuple | None = None

    layer = 0
    while True:
        layer += 1
        stats.layers = layer
        if progress is not None:
            progress.update(
                ops_committed=deep_sum,
                total_ops=len(ops),
                frontier_width=len(frontier),
                states_expanded=stats.expanded,
                layer=layer,
                engine="frontier",
            )
        if deadline is not None and time.monotonic() > deadline:
            _finish_layer()
            res = CheckResult(CheckOutcome.UNKNOWN, deepest=deepest_of(deep_counts))
            if collect_stats:
                res.stats = stats  # type: ignore[attr-defined]
            return res
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
            if cuts:
                note_cut(counts, states)
            counts, states, closed_ops = auto_close_config(counts, states)
            key = (counts, states)
            if key not in closed:
                closed[key] = None
                close_link[key] = (pre, closed_ops)

        if cuts:
            # A cut is complete once no configuration can reach it again:
            # children of this layer sit strictly above the layer's minimum
            # post-close sum, so every cut at or below that floor is final.
            floor = min(sum(counts) for counts, _ in closed)
            for K, cut in cuts.items():
                if not cut[2] and K <= floor:
                    cut[2] = True
            if held is not None and all(cut[2] for cut in cuts.values()):
                _finish_layer()
                return _ok_result(*held)

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
                if complete_cuts and any(
                    not cut[2] for cut in cuts.values()
                ):
                    # The verdict is decided, but a requested union is
                    # still collecting below this configuration — hold
                    # the return and keep expanding until it is exact.
                    if held is None:
                        held = (order, sorted(states))
                    continue
                _finish_layer()
                return _ok_result(order, sorted(states))

        children: dict[tuple[tuple[int, ...], frozenset[StreamState]], None] = {}
        for counts, states in closed:
            if order_prunes and min(s.tail for s in states) > plan.min_pin(counts):
                # Every state's tail has passed the smallest pin among the
                # remaining ops: that op can never linearize from here, so
                # no accepting extension exists — exact, unlike the beam.
                stats.prune_dead += 1
                continue
            pre, closed_ops = close_link[(counts, states)]
            _, cands = window(counts)
            minrank = plan.min_remaining_rank(counts) if order_prunes else None
            for c in cands:
                if order_prunes:
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
            _finish_layer()
            if held is not None:
                # Exhaustion: no configuration can reach any cut again,
                # so every surviving union is final.
                for cut in cuts.values():
                    cut[2] = True
                return _ok_result(*held)
            outcome = CheckOutcome.UNKNOWN if stats.pruned else CheckOutcome.ILLEGAL
            res = CheckResult(outcome, deepest=deepest_of(deep_counts))
            if collect_stats:
                res.stats = stats  # type: ignore[attr-defined]
            return res
        if max_frontier is not None and len(children) > max_frontier:
            if not beam:
                _finish_layer()
                res = CheckResult(
                    CheckOutcome.UNKNOWN, deepest=deepest_of(deep_counts)
                )
                if collect_stats:
                    res.stats = stats  # type: ignore[attr-defined]
                return res
            stats.pruned = True
            if cuts:
                # A pruned branch could still have contributed states to a
                # cut not yet complete; a partial union resumed later can
                # only produce a *false ILLEGAL* — refuse those snapshots.
                for K in [K for K, cut in cuts.items() if not cut[2]]:
                    del cuts[K]
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
    init_counts: tuple[int, ...] | None = None,
    init_states: Iterable[StreamState] | None = None,
    snapshot_cuts: Iterable[int] | None = None,
    time_budget_s: float | None = None,
    progress=None,
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
        init_counts=init_counts,
        init_states=init_states,
        snapshot_cuts=snapshot_cuts,
        time_budget_s=time_budget_s,
        progress=progress,
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
        init_counts=init_counts,
        init_states=init_states,
        snapshot_cuts=snapshot_cuts,
        time_budget_s=time_budget_s,
        progress=progress,
        prune=prune,
    )
