"""Fleet-distributed frontier search with crash-tolerant partition
ownership.

One CPU-intractable history, N nodes: the coordinator (hosted by
``service/router.py``) slices the prepared history into consecutive
**segments** at event-closed cuts, and at each segment boundary splits
the carried frontier *state union* into disjoint **partitions** by
state-digest range (``checker.frontier.state_digest``).  Each partition
ships to a backend as a ``delta`` frame — the segment's history text
plus the partition's share of the union in the prefix-carry payload
shape (checker/prefix.py) — and comes back as an end-of-segment union
the coordinator merges before fanning out the next segment.

Soundness (why partition verdicts merge by union):

* A segment cut is chosen where no op spans the boundary (the open-op
  scan below), so the segment is a standalone suffix history exactly
  like a ``follow`` window: per-segment counts restart at zero and the
  carried union is the one configuration every linearization passes
  through (checker/prefix.py).
* ``step_set`` applies per state and unions results, so for any op
  sequence the reachable state set from ``A ∪ B`` is the union of the
  reachable sets from ``A`` and from ``B``.  Hence a segment search
  seeded with partition ``P_i`` explores exactly the ``P_i``-ancestored
  slice of the full search: the segment is linearizable from ``U`` iff
  it is from at least one partition, and the end-of-segment union from
  ``U`` is the union of the partition results.  Auto-close stays sound
  per partition: it only linearizes indefinite appends whose effect
  branch is dead *for the states present*, and the no-effect branch
  changes nothing — reachability from that partition is preserved
  exactly.
* Partition searches run the **exhaustive** frontier engine (no beam)
  so the returned union is complete, and the end cut is only attached
  once every accepted configuration linearized everything.  An OK that
  arrives *without* an end union (early-accept on a tail of indefinite
  appends) cannot be merged — the coordinator raises
  :class:`DistSearchError` and the router falls back to the plain
  single-node route: honest, never wrong.
* Search pruning (``serve --prune``, checker/prune.py) composes with
  partitioning without coordination: partition jobs always carry
  snapshot cuts, and the frontier engine stands its *order* prunes
  (append rank gate, tail pin) down while cuts are collecting — a
  gated path never accepts, but its dead-weight states belong in the
  promised exact union.  Eager commit stays on because committed ops
  are state-identity where they commit, so the end-of-segment union is
  byte-identical either way.  The rank tables themselves are derived
  from each segment's own encoded history, so re-grants and epoch
  bumps recompute them deterministically — no pruned precedence ever
  crosses a partition boundary.

Robustness (the actual point — see the grant ledger in
``service/journal.py``):

* **Grant-before-ship**: every grant is journaled before the wire sees
  it, so a coordinator death leaves the open ranges on disk for the
  doctor and for the next epoch.
* **Epoch fencing**: one monotone counter per search.  A partition that
  fails, straggles, or dies is re-granted under a *new* epoch; the old
  owner's eventual reply is rejected at both ends — the backend
  re-checks its grant table when the verdict is ready, and
  :meth:`Coordinator._accept_delta` is the single merge entry point
  that refuses anything but the exact live epoch of a not-yet-decided
  partition.  Zero stale deltas are ever merged, by construction.
* **Exactly-one-conclusive-owner**: the merged verdict is only emitted
  once every partition of every segment has exactly one accepted,
  conclusive delta; duplicates and zombies land in the fence counters
  instead.

The port's copy of the JAX package's ``service/distsearch.py``: packed
states, partition ids, segment plans and grant-ledger records are the
JAX package's byte for byte, and the partition searches run on the
backends' host frontier engine, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field

from ..checker.entries import History
from ..checker.frontier import state_digest
from ..checker.prefix import PrefixCarry
from ..models.stream import INIT_STATE, StreamState
from ..utils import events as ev
from .client import VerifydError
from .overload import CancelToken
from .prefixstore import prefix_accumulators
from .protocol import ERR_EPOCH

__all__ = [
    "Coordinator",
    "DistSearchConfig",
    "DistSearchError",
    "pack_states",
    "part_ranges",
    "partition_states",
    "plan_segments",
    "unpack_states",
]

log = logging.getLogger("s2_verification_tpu_torch.verifyd")

_DIGEST_SPACE = 1 << 32


def pack_states(states) -> list:
    """Wire form of a state union: the prefix-carry ``"s"`` shape
    (checker/prefix.py), sorted so identical unions serialize to
    identical bytes — ``json.dumps(pack_states(u), sort_keys=True,
    separators=(",", ":"))`` is the canonical delta encoding."""
    return [
        [s.tail, s.stream_hash, s.fencing_token] for s in sorted(states)
    ]


def unpack_states(payload) -> tuple[StreamState, ...]:
    """Inverse of :func:`pack_states`; raises ValueError on malformed rows."""
    try:
        return tuple(
            StreamState(tail=int(t), stream_hash=int(h), fencing_token=tok)
            for t, h, tok in payload
        )
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed state union payload: {e}") from e


def part_ranges(n: int) -> list[tuple[int, int]]:
    """Split the 32-bit digest space into ``n`` half-open ranges."""
    n = max(1, int(n))
    bounds = [(_DIGEST_SPACE * i) // n for i in range(n + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(n)]


def part_id(lo: int, hi: int) -> str:
    return f"{lo:08x}-{hi:08x}"


def partition_states(states, n: int) -> dict[str, list[StreamState]]:
    """Partition a union into up to ``n`` non-empty digest-range parts.

    Disjoint and covering by construction (every state's digest lands in
    exactly one range); empty ranges are dropped — granting a partition
    with nothing to search is wasted wire and a vacuous owner.
    """
    ranges = part_ranges(n)
    out: dict[str, list[StreamState]] = {}
    for s in states:
        d = state_digest(s) % _DIGEST_SPACE
        # ranges are equal-width, so the owning range is a division
        idx = min(len(ranges) - 1, (d * len(ranges)) // _DIGEST_SPACE)
        lo, hi = ranges[idx]
        if not (lo <= d < hi):  # guard the rounding at range edges
            idx = next(
                i for i, (a, b) in enumerate(ranges) if a <= d < b
            )
            lo, hi = ranges[idx]
        out.setdefault(part_id(lo, hi), []).append(s)
    return out


@dataclass
class Segment:
    """One consecutive slice of the prepared history.

    ``events`` index into the canonical serialized line list (one line
    per event — the coordinator re-serializes, so this holds regardless
    of how densely the client packed its JSONL); ``ops`` the cumulative
    prepared-op count at the segment's end; ``key`` the chain-hash store
    key naming the end boundary (service/prefixstore.py key canon).
    """

    index: int
    key: str
    event_lo: int
    event_hi: int
    ops_hi: int


def _closed_event_cuts(events) -> list[int]:
    """Event indices where no op is in flight (a cut both event- and
    op-closed: every call before it has its finish before it too)."""
    open_ops: set[tuple] = set()
    cuts = []
    for i, le in enumerate(events):
        key = (le.client_id, le.op_id)
        if le.is_start:
            open_ops.add(key)
        else:
            open_ops.discard(key)
        if not open_ops:
            cuts.append(i + 1)
    return cuts


def plan_segments(
    events, hist: History, segments: int
) -> list[Segment] | None:
    """Slice the history into up to ``segments`` standalone suffixes.

    Cut positions are picked from the event-closed cuts nearest to an
    even op spread.  Returns None when the history offers no usable
    interior cut (single segment = nothing to distribute segment-wise;
    the caller still partitions the initial union for the whole run).
    """
    n_events = len(events)
    n_ops = len(hist.ops)
    if n_events == 0 or n_ops == 0:
        return None
    # ops are call-ordered and call/ret are event indices, so the op
    # count at event cut e is the number of ops whose call precedes e.
    calls = [op.call for op in hist.ops]

    def ops_at(e: int) -> int:
        from bisect import bisect_left

        return bisect_left(calls, e)

    interior = [e for e in _closed_event_cuts(events) if 0 < e < n_events]
    # A cut only helps if both sides carry ops.
    interior = [e for e in interior if 0 < ops_at(e) < n_ops]
    want = max(1, int(segments))
    chosen: list[int] = []
    if want > 1 and interior:
        targets = [(n_ops * i) // want for i in range(1, want)]
        for t in targets:
            best = min(interior, key=lambda e: abs(ops_at(e) - t))
            if best not in chosen:
                chosen.append(best)
        chosen.sort()
    cut_events = chosen + [n_events]
    cut_ops = [ops_at(e) if e < n_events else n_ops for e in cut_events]
    # Boundary names: the chain-hash accumulator keys of the interior op
    # cuts — the same canon the prefix store uses, so a segment boundary
    # is identifiable across nodes and boots.
    keys = prefix_accumulators(hist, [k for k in cut_ops if 0 < k <= n_ops])
    out = []
    lo = 0
    for i, (e, k) in enumerate(zip(cut_events, cut_ops)):
        out.append(
            Segment(
                index=i,
                key=keys.get(k, f"seg:{i}:{k}"),
                event_lo=lo,
                event_hi=e,
                ops_hi=k,
            )
        )
        lo = e
    return out


class DistSearchError(RuntimeError):
    """The search cannot be completed distributed (no usable partition
    topology, an unmergeable OK, too few healthy nodes).  The router
    answers by falling back to the single-node route — the distributed
    path degrades to correct-but-serial, never to wrong."""


@dataclass
class DistSearchConfig:
    #: target segment count (actual cuts depend on closed-cut geometry)
    segments: int = 3
    #: seconds a granted partition may run before an idle healthy node
    #: steals it under a new epoch (0 disables stealing)
    straggler_s: float = 10.0
    #: per-delta wire timeout (None = bounded only by the job deadline)
    attempt_timeout_s: float | None = None
    #: re-grants per partition (failover or inconclusive) before the
    #: search gives up as UNKNOWN
    max_regrants: int = 3
    #: coordinator-owned wire threads (grants are synchronous and cheap;
    #: deltas block one thread each until the backend decides)
    io_workers: int = 8
    #: seconds between owner progress polls (``watch`` by partition
    #: fingerprint; 0 disables polling and stealing degrades to the
    #: legacy pure-wall-clock rule)
    progress_poll_s: float = 1.0


@dataclass
class _Attempt:
    part: str
    epoch: int
    node: str
    future: object
    started: float = field(default_factory=time.monotonic)
    #: last observed (ops_committed, states_expanded) from the owner's
    #: watch surface; -1 = no heartbeat seen yet for this attempt
    ops: int = -1
    expanded: int = -1
    #: last time the observation *advanced* — the stall clock.  Starts
    #: at grant time, so an owner that never reports degrades exactly
    #: to the legacy started-based wall-clock rule.
    last_advance: float = field(default_factory=time.monotonic)
    next_poll: float = 0.0
    poll_future: object = None


class Coordinator:
    """One distributed search run.

    ``nodes`` is a zero-arg callable returning the currently healthy
    candidates as ``(name, client)`` pairs — the router passes a view of
    its routable set so node death (prober) and breaker state feed
    straight into re-grant placement.  All wire calls run on the
    coordinator's own small executor, never on the router's submit pool
    (the routed submit occupying one pool slot must not deadlock waiting
    for pool slots of its own).
    """

    def __init__(
        self,
        *,
        search: str,
        nodes,
        ledger=None,
        config: DistSearchConfig | None = None,
        cancel: CancelToken | None = None,
        epoch_floor: int = 0,
        counter=None,
        trace_id: str | None = None,
    ) -> None:
        self.search = search
        self.nodes = nodes
        self.ledger = ledger
        self.cfg = config or DistSearchConfig()
        self.cancel = cancel or CancelToken()
        self.trace_id = trace_id
        self._count = counter or (lambda key, n=1: None)
        self._lock = threading.Lock()
        #: live epoch per (seg key, part id); the merge-side fence
        self._epochs: dict[tuple[str, str], int] = {}
        #: partitions already decided (duplicate-accept guard)
        self._decided: set[tuple[str, str]] = set()
        self._results: dict[tuple[str, str], dict] = {}
        self._epoch = int(epoch_floor)
        self.fences = 0
        self.regrants = 0
        self.steals = 0
        self.stall_steals = 0
        self.grants = 0
        self.stale_accepted = 0  # structurally zero; asserted by the gate
        self.delta_bytes = 0
        #: part id -> owner node, for the live stats view (chaos gate
        #: reads this to pick its SIGKILL victim)
        self.active: dict[str, str] = {}
        self.owners: dict[str, str] = {}
        #: part id -> last progress row polled off the owning backend
        #: (router's ``watch --search`` aggregation reads this)
        self.progress: dict[str, dict] = {}
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, self.cfg.io_workers),
            thread_name_prefix="distsearch-io",
        )

    # -- epoch fence (the single merge entry point) --------------------------

    def _next_epoch(self) -> int:
        with self._lock:
            self._epoch += 1
            return self._epoch

    def _accept_delta(
        self, seg: str, part: str, epoch: int, body: dict
    ) -> bool:
        """Admit one delta into the merge iff it carries the partition's
        live epoch and the partition is still undecided.  Everything the
        robustness story promises funnels through here: a zombie's reply
        (stale epoch), a duplicate of an already-merged partition, and a
        reply for a revoked grant are all fenced, counted, journaled —
        and never merged."""
        key = (seg, part)
        with self._lock:
            live = self._epochs.get(key)
            if live != epoch or key in self._decided:
                self.fences += 1
                stale = True
            else:
                self._decided.add(key)
                self._results[key] = body
                stale = False
        if stale:
            self._count("fenced")
            if self.ledger is not None:
                self.ledger.fence(
                    search=self.search, seg=seg, part=part, epoch=epoch,
                    op="delta",
                )
            return False
        return True

    # -- node selection ------------------------------------------------------

    def _healthy(self) -> list:
        try:
            return list(self.nodes())
        except Exception:
            return []

    def _pick_node(self, busy: set, avoid: str | None = None):
        """Least-loaded healthy node, preferring idle ones and avoiding
        the node the partition is being taken from."""
        cands = self._healthy()
        if not cands:
            return None
        idle = [c for c in cands if c[0] not in busy and c[0] != avoid]
        if idle:
            return idle[0]
        other = [c for c in cands if c[0] != avoid]
        return other[0] if other else cands[0]

    # -- the run -------------------------------------------------------------

    def run(self, lines: list[str], events, hist: History) -> dict:
        """Execute the whole search; returns the merged reply payload.

        Raises :class:`DistSearchError` for anything that must fall back
        to the single-node route.  A spent deadline returns
        ``{"verdict": 2, "outcome": "unknown", "reason": "deadline"}`` —
        the router maps it to the definite ``DeadlineExceeded``.
        """
        t0 = time.monotonic()
        try:
            return self._run(lines, events, hist, t0)
        finally:
            self._pool.shutdown(wait=False)
            self.active.clear()

    def _run(self, lines, events, hist, t0: float) -> dict:
        segments = plan_segments(events, hist, self.cfg.segments)
        if segments is None:
            raise DistSearchError("history has no ops to distribute")
        healthy = self._healthy()
        if len(healthy) < 2:
            raise DistSearchError(
                f"need >= 2 healthy backends, have {len(healthy)}"
            )
        if self.ledger is not None:
            self.ledger.search(
                search=self.search,
                segs=len(segments),
                parts=len(healthy),
            )
        union: tuple[StreamState, ...] = (INIT_STATE,)
        partitions_total = 0
        for seg in segments:
            final = seg.index == len(segments) - 1
            seg_text = "\n".join(lines[seg.event_lo:seg.event_hi])
            parts = partition_states(union, max(1, len(self._healthy())))
            if not parts:
                raise DistSearchError("empty carried union")
            partitions_total += len(parts)
            merged, verdict = self._run_segment(
                seg, seg_text, parts, final=final
            )
            if verdict == 1:
                return self._verdict_reply(1, "illegal", t0, partitions_total)
            if verdict == 2:
                reason = merged if isinstance(merged, str) else "exhausted"
                if reason == "deadline":
                    return {
                        "verdict": 2,
                        "outcome": "unknown",
                        "reason": "deadline",
                    }
                return self._verdict_reply(
                    2, "unknown", t0, partitions_total, reason=reason
                )
            if final:
                return self._verdict_reply(0, "ok", t0, partitions_total)
            union = merged
            if not union:
                # every partition searched to a dead end — the frontier
                # died at this boundary, which is a definite ILLEGAL
                return self._verdict_reply(1, "illegal", t0, partitions_total)
        raise DistSearchError("no final segment")  # unreachable

    def _verdict_reply(
        self, verdict: int, outcome: str, t0: float, partitions: int,
        reason: str | None = None,
    ) -> dict:
        if self.ledger is not None:
            self.ledger.verdict(
                search=self.search, verdict=verdict, outcome=outcome
            )
        out = {
            "verdict": verdict,
            "outcome": outcome,
            "distributed": True,
            "partitions": partitions,
            "grants": self.grants,
            "regrants": self.regrants,
            "steals": self.steals,
            "stall_steals": self.stall_steals,
            "fences": self.fences,
            "stale_accepted": self.stale_accepted,
            "epochs": self._epoch,
            "owners": dict(self.owners),
            "wall_s": round(time.monotonic() - t0, 4),
        }
        if reason is not None:
            out["reason"] = reason
        return out

    # -- one segment ---------------------------------------------------------

    def _grant_and_ship(
        self, seg: Segment, seg_text: str, part: str,
        states, node_name: str, client, reason: str,
        want_union: bool = True,
    ) -> _Attempt:
        """Grant-before-ship: journal, handshake, then launch the delta."""
        epoch = self._next_epoch()
        with self._lock:
            self._epochs[(seg.key, part)] = epoch
        if self.ledger is not None:
            self.ledger.grant(
                search=self.search, seg=seg.key, part=part, epoch=epoch,
                node=node_name, reason=reason,
            )
        self.grants += 1
        self._count("granted")
        if reason == "regrant":
            self.regrants += 1
            self._count("regranted")
        elif reason in ("steal", "stall-steal"):
            self.steals += 1
            self._count("stolen")
            if reason == "stall-steal":
                self.stall_steals += 1
                self._count("stall_stolen")
        self.active[part] = node_name
        self.owners[part] = node_name
        with self._lock:
            self.progress.pop(part, None)  # the new owner's rows replace it
        carry = PrefixCarry(ops=0, states=tuple(states)).to_payload()
        remaining = self.cancel.remaining()
        tmo = self.cfg.attempt_timeout_s
        if remaining is not None:
            tmo = remaining if tmo is None else min(tmo, remaining)

        def _exchange() -> dict:
            client.grant(
                search=self.search, seg=seg.key, part=part, epoch=epoch,
                timeout=min(10.0, tmo) if tmo is not None else 10.0,
            )
            return client.delta(
                seg_text,
                search=self.search,
                seg=seg.key,
                part=part,
                epoch=epoch,
                carry=carry,
                union=want_union,
                deadline_s=remaining,
                timeout=tmo,
                trace_id=self.trace_id,
            )

        return _Attempt(
            part=part, epoch=epoch, node=node_name,
            future=self._pool.submit(_exchange),
        )

    def _revoke(self, seg: Segment, attempt: _Attempt, reason: str) -> None:
        """Close the superseded grant: journal the closure and tell the
        old owner (best-effort — a SIGKILLed owner can't hear it; the
        epoch fence covers that case at merge time)."""
        if self.ledger is not None:
            self.ledger.done(
                search=self.search, seg=seg.key, part=attempt.part,
                epoch=attempt.epoch, reason=reason,
            )
        for name, client in self._healthy():
            if name != attempt.node:
                continue
            def _bye(c=client, a=attempt):
                try:
                    c.partition_done(
                        search=self.search, part=a.part, epoch=a.epoch + 1,
                        reason="revoked", timeout=5.0,
                    )
                except Exception:
                    pass
            self._pool.submit(_bye)
            break

    def progress_snapshot(self) -> dict:
        """Per-partition progress aggregate for the router's ``watch``
        surface: owner, epoch and the last row polled off each owner."""
        with self._lock:
            parts = {p: dict(r) for p, r in self.progress.items()}
        return {
            "search": self.search,
            "epoch": self._epoch,
            "owners": dict(self.owners),
            "partitions": parts,
        }

    def _poll_progress(self, a: _Attempt, now: float) -> None:
        """Non-blocking progress poll of one attempt's owner.

        Harvests the previous poll's answer (advancing the attempt's
        stall clock when ``ops_committed``/``states_expanded`` moved),
        then launches the next at ``progress_poll_s`` cadence on the
        coordinator's own executor — the wait loop never blocks on a
        watch round-trip.  Owners that answer ``UnknownJob`` (progress
        disabled, job not yet admitted) simply never advance the clock.
        """
        if self.cfg.progress_poll_s <= 0:
            return
        fut = a.poll_future
        if fut is not None:
            if not fut.done():
                return
            a.poll_future = None
            row = None
            try:
                got = fut.result()
                rows = got.get("progress") or []
                if rows and isinstance(rows[0], dict):
                    row = rows[0]
            except Exception:
                row = None
            if row is not None:
                ops = int(row.get("ops_committed") or 0)
                expanded = int(row.get("states_expanded") or 0)
                if ops > a.ops or expanded > a.expanded:
                    a.last_advance = now
                a.ops = max(a.ops, ops)
                a.expanded = max(a.expanded, expanded)
                with self._lock:
                    self.progress[a.part] = {
                        "node": a.node,
                        "epoch": a.epoch,
                        "ops_committed": a.ops,
                        "total_ops": row.get("total_ops"),
                        "states_expanded": a.expanded,
                        "progress_ratio": row.get("progress_ratio"),
                        "eta_s": row.get("eta_s"),
                        "layer_rate": row.get("layer_rate"),
                        "stalled_s": round(now - a.last_advance, 3),
                    }
        if now < a.next_poll:
            return
        a.next_poll = now + self.cfg.progress_poll_s
        client = next(
            (c for n, c in self._healthy() if n == a.node), None
        )
        if client is None:
            return
        fp = f"ppart:{self.search[:16]}/{a.part}"

        def _ask(c=client, key=fp):
            return c.watch(fingerprint=key, timeout=5.0)

        a.poll_future = self._pool.submit(_ask)

    def _harvest_zombie(self, seg: Segment, attempt: _Attempt) -> None:
        """A superseded attempt's eventual reply must still hit the fence
        (counted, journaled) — attach it instead of abandoning it."""
        def _done(fut, a=attempt):
            try:
                body = fut.result()
            except Exception:
                return  # the zombie died with its node; nothing to fence
            if isinstance(body, dict):
                self._accept_delta(seg.key, a.part, a.epoch, body)

        attempt.future.add_done_callback(_done)

    def _run_segment(
        self, seg: Segment, seg_text: str, parts: dict, *, final: bool
    ):
        """Fan one segment out, survive failures, merge.

        Returns ``(merged union | reason, verdict)`` with verdict 0/1/2:
        0 = every partition conclusive and at least one OK (the merged
        union is the OK partitions' end unions); 1 = every partition
        ILLEGAL; 2 = inconclusive (re-grants exhausted or deadline).
        """
        attempts: dict[str, _Attempt] = {}
        regrants_left = {p: self.cfg.max_regrants for p in parts}
        failed_reason: str | None = None
        for part, states in parts.items():
            node = self._pick_node(
                busy={a.node for a in attempts.values()}
            )
            if node is None:
                return "no_backend", 2
            attempts[part] = self._grant_and_ship(
                seg, seg_text, part, states, node[0], node[1], "grant",
                want_union=not final,
            )
        pending = set(parts)
        while pending:
            if self.cancel.check() is not None:
                for part in list(pending):
                    a = attempts.get(part)
                    if a is not None:
                        self._revoke(seg, a, "failed")
                        self._harvest_zombie(seg, a)
                return "deadline", 2
            done, _ = wait(
                {attempts[p].future for p in pending},
                timeout=0.25,
                return_when=FIRST_COMPLETED,
            )
            now = time.monotonic()
            for part in list(pending):
                a = attempts[part]
                if a.future in done:
                    ok_body: dict | None = None
                    retry_reason: str | None = None
                    try:
                        body = a.future.result()
                        if isinstance(body, dict):
                            ok_body = body
                        else:
                            retry_reason = "garbled"
                    except VerifydError as e:
                        if e.cls == ERR_EPOCH:
                            # the backend fenced our own live epoch: the
                            # grant raced a newer one; treat as failure
                            retry_reason = "fenced"
                        else:
                            retry_reason = e.cls
                    except Exception as e:  # transport death, SIGKILL…
                        retry_reason = type(e).__name__
                    if ok_body is not None and self._accept_delta(
                        seg.key, part, a.epoch, ok_body
                    ):
                        self.delta_bytes += len(
                            json.dumps(
                                ok_body.get("states") or [],
                                separators=(",", ":"),
                            )
                        )
                        self._count(
                            "delta_bytes",
                            len(json.dumps(ok_body.get("states") or [],
                                           separators=(",", ":"))),
                        )
                        verdict = ok_body.get("verdict")
                        if verdict == 2 and regrants_left[part] > 0:
                            # inconclusive is not a decision: the
                            # partition goes back out under a new epoch
                            with self._lock:
                                self._decided.discard((seg.key, part))
                                self._results.pop((seg.key, part), None)
                            regrants_left[part] -= 1
                            node = self._pick_node(
                                {x.node for x in attempts.values()},
                                avoid=a.node,
                            )
                            if node is None:
                                return "no_backend", 2
                            self._revoke(seg, a, "failed")
                            attempts[part] = self._grant_and_ship(
                                seg, seg_text, part, parts[part],
                                node[0], node[1], "regrant",
                                want_union=not final,
                            )
                            continue
                        if self.ledger is not None:
                            self.ledger.delta(
                                search=self.search, seg=seg.key, part=part,
                                epoch=a.epoch, node=a.node,
                                verdict=verdict,
                                states=len(ok_body.get("states") or []),
                                size=len(json.dumps(
                                    ok_body.get("states") or [],
                                    separators=(",", ":"),
                                )),
                            )
                            self.ledger.done(
                                search=self.search, seg=seg.key, part=part,
                                epoch=a.epoch, reason="done",
                            )
                        self.active.pop(part, None)
                        pending.discard(part)
                        continue
                    if ok_body is not None:
                        # merged elsewhere already (fenced duplicate)
                        pending.discard(part)
                        continue
                    # attempt failed: re-grant under a new epoch
                    if regrants_left[part] <= 0:
                        failed_reason = retry_reason or "exhausted"
                        self._revoke(seg, a, "failed")
                        pending.discard(part)
                        continue
                    regrants_left[part] -= 1
                    node = self._pick_node(
                        {x.node for x in attempts.values()}, avoid=a.node
                    )
                    if node is None:
                        failed_reason = "no_backend"
                        pending.discard(part)
                        continue
                    self._revoke(seg, a, "failed")
                    attempts[part] = self._grant_and_ship(
                        seg, seg_text, part, parts[part],
                        node[0], node[1], "regrant",
                        want_union=not final,
                    )
                else:
                    self._poll_progress(a, now)
                    # Stall clock: the straggler budget runs from the
                    # owner's last *progress advance*, not its grant
                    # time — a slow-but-advancing partition is left
                    # alone; one whose reported search stopped moving
                    # is stolen even if a faster sibling keeps the
                    # coordinator busy.  Owners that never report
                    # degrade to the legacy wall-clock rule
                    # (last_advance stays at grant time).
                    if (
                        self.cfg.straggler_s > 0
                        and now - a.last_advance > self.cfg.straggler_s
                        and regrants_left[part] > 0
                    ):
                        # Steal only onto an *idle* healthy node —
                        # re-running the same work on an equally busy
                        # node would just double the load.
                        busy = {x.node for x in attempts.values()}
                        idle = [
                            c for c in self._healthy() if c[0] not in busy
                        ]
                        if idle:
                            saw_progress = a.ops >= 0 or a.expanded >= 0
                            reason = (
                                "stall-steal" if saw_progress else "steal"
                            )
                            log.info(
                                "partition %s on %s %s for %.1fs; "
                                "%s to %s",
                                part,
                                a.node,
                                "made no search progress"
                                if saw_progress
                                else "straggling",
                                now - a.last_advance,
                                reason,
                                idle[0][0],
                            )
                            regrants_left[part] -= 1
                            self._revoke(seg, a, "revoked")
                            self._harvest_zombie(seg, a)
                            attempts[part] = self._grant_and_ship(
                                seg, seg_text, part, parts[part],
                                idle[0][0], idle[0][1], reason,
                                want_union=not final,
                            )
        if failed_reason is not None:
            return failed_reason, 2
        # merge: exactly one accepted delta per partition (the fence
        # guarantees it); decide the segment
        bodies = [
            self._results[(seg.key, p)]
            for p in parts
            if (seg.key, p) in self._results
        ]
        if len(bodies) != len(parts):
            return "lost_partition", 2
        if any(b.get("verdict") == 2 for b in bodies):
            return "exhausted", 2
        ok_bodies = [b for b in bodies if b.get("verdict") == 0]
        if not ok_bodies:
            return (), 1  # every partition ILLEGAL
        if final:
            return (), 0
        merged: set[StreamState] = set()
        for b in ok_bodies:
            payload = b.get("states")
            if not payload:
                raise DistSearchError(
                    "partition OK without an end-of-segment union "
                    "(early accept); falling back to single-node"
                )
            merged.update(unpack_states(payload))
        return tuple(sorted(merged)), 0
