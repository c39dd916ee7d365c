"""Prefix-closed boundaries and resumable frontier carries.

The port's copy of the JAX package's ``checker/prefix.py`` (pure Python;
the carries it writes are byte-equal to that package's).

The soundness backbone of incremental verification (service/prefixstore.py,
the daemon's ``follow`` op).  A boundary after op K of a prepared history is
**prefix-closed** when every one of the first K ops returned before any
later op was called::

    max(ret over ops[:K])  <  min(call over ops[K:])

Because the frontier search's candidate rule only admits an op whose call
precedes the minimum outstanding return, every linearization of the full
history commits *exactly* ``ops[:K]`` (as a set, in some order) before any
op of the suffix — the boundary is a cut no interleaving crosses.  At such
a cut the entire search state is one configuration: the forced per-chain
counts plus the **union** of every reachable state set.  ``step_set``
distributes over unions and the candidate/acceptance rules depend only on
counts, so resuming from ``(counts_K, union_K)`` is verdict-equivalent to
a cold search — provided the union is *exact*.  A subset (e.g. from a
pruned search) could produce a false ILLEGAL on resume; supersets cannot
occur because collection only ever records reachable states.  The
completeness bookkeeping lives in checker/frontier.py (``snapshot_cuts``).

A boundary crossed by an in-flight op is never closed: a pending op's
completed return is placed at the event horizon, past every real call, so
any pending op in the prefix kills every later boundary except the trivial
K = num_ops one — which callers must additionally refuse when the history
has pending ops at all (the op's effect is not yet decided, so a carry
would bake an unfinished op into the committed prefix; see
``has_open_ops``).

Everything here is pure op-index geometry; the chain-hash keys that name
cuts on the wire live in service/prefixstore.py.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass

from ..models.stream import StreamState
from .entries import History

__all__ = [
    "PrefixCarry",
    "boundary_counts",
    "choose_cuts",
    "closed_boundaries",
    "has_open_ops",
]


def closed_boundaries(history: History) -> list[int]:
    """Every prefix-closed op boundary K, ascending, 0 < K <= num_ops.

    Ops are call-sorted (checker/entries.py), so the suffix minimum call is
    just ``ops[K].call`` and the scan is linear.  K = num_ops (empty
    suffix) is vacuously closed and always included for non-empty
    histories; whether it is *usable* further depends on
    :func:`has_open_ops`.
    """
    ops = history.ops
    n = len(ops)
    if n == 0:
        return []
    out: list[int] = []
    max_ret = -1
    for K in range(1, n):
        max_ret = max(max_ret, ops[K - 1].ret)
        if max_ret < ops[K].call:
            out.append(K)
    out.append(n)
    return out


def has_open_ops(history: History) -> bool:
    """True when any op (including elided trivial ops) never finished.

    A pending op's outcome is undecided — the checker completes it with the
    weakest consistent output, which is fine for a one-shot verdict but
    must never be committed into a carried prefix: the real finish may
    arrive in the next window and re-prepare differently.  Stores and the
    ``follow`` handler refuse to snapshot such histories.
    """
    return any(op.pending for op in history.ops) or any(
        op.pending for op in history.trivial_ops
    )


def boundary_counts(history: History, K: int) -> tuple[int, ...]:
    """The forced per-chain counts at closed cut K.

    Chain lists hold op indices in ascending order, so the number of a
    chain's ops inside ``ops[:K]`` is a bisect.
    """
    return tuple(bisect_left(chain, K) for chain in history.chains)


def choose_cuts(history: History, max_cuts: int = 8) -> list[int]:
    """Pick snapshot cuts: the deepest closed boundary always, plus up to
    ``max_cuts - 1`` more spread evenly across the remaining closed
    boundaries (shallow cuts catch short extensions, deep cuts long ones).
    """
    bounds = closed_boundaries(history)
    if len(bounds) <= max_cuts:
        return bounds
    picked = {bounds[-1]}
    step = (len(bounds) - 1) / max(1, max_cuts - 1)
    for i in range(max_cuts - 1):
        picked.add(bounds[int(round(i * step))])
    return sorted(picked)


@dataclass(frozen=True)
class PrefixCarry:
    """A decided prefix: resume the search at op ``ops`` from ``states``.

    ``ops`` counts *cumulative* committed ops (across every prior window
    for follow lineages); ``states`` is the exact reachable-state union at
    the cut, as produced by ``check_frontier(..., snapshot_cuts=...)``.
    """

    ops: int
    states: tuple[StreamState, ...]

    def to_payload(self) -> dict:
        return {
            "n": self.ops,
            "s": [[s.tail, s.stream_hash, s.fencing_token] for s in self.states],
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "PrefixCarry":
        states = tuple(
            StreamState(tail=int(t), stream_hash=int(h), fencing_token=tok)
            for t, h, tok in payload["s"]
        )
        if not states:
            raise ValueError("prefix carry with empty state union")
        return cls(ops=int(payload["n"]), states=states)
