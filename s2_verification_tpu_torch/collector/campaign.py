"""Time-phased fault campaigns + ground-truth violation injection.

The static :class:`~.fake_s2.FaultPlan` applies one fault mix uniformly for
a whole run.  A :class:`Campaign` sequences *phases* over the collector's
:class:`~.clock.VirtualClock` — partition windows where some client slots
cannot reach the stream, duplicate/torn/late ack delivery, latency storms,
crash-restart windows — so a single history exercises fault transitions,
not just fault rates.  Phase boundaries are virtual seconds; since the
clock, the server rng, and every client rng are seeded, a campaign replays
byte-identically (same seeds ⇒ same history bytes, same label).

**Ground-truth violation injection** is the second half: a phase may arm a
deliberate-violation class, and the stream then commits exactly one
linearizability violation per history:

- ``drop_acked`` — ack an append (claimed tail) without applying it;
- ``reorder`` — swap two adjacent records *within* an acked batch, so
  every later read serves a chain-fold no batch ordering can produce;
- ``stale_read`` — serve one client a prefix strictly shorter than a tail
  that same client already observed (tail monotonicity violation);
- ``fence_resurrect`` — accept an append fenced by a token whose set
  attempt *definitely failed* (a fenced-out writer writing anyway).

Each class is only injected (or only *confirmed*, for ``drop_acked`` /
``reorder``) when the resulting history is provably non-linearizable, so
the emitted ``expect`` label is sound in both directions:

- ``stale_read`` / ``fence_resurrect`` are self-evident at injection time
  (same-client sequentiality / a token never current in any branch);
- ``reorder`` confirms at the first successful read after the swap (the
  64-bit order-sensitive chain fold matches no legal record order short
  of a hash collision — the same ground the repo's
  ``adversarial_events(unsatisfiable=True)`` stands on);
- ``drop_acked`` confirms at the first *read success whose Start is logged
  after the dropped append's Finish*: log order is real-time order for
  the checker, so that read must linearize after the acked append yet its
  fold lacks the acked records.  The stream watches the event log through
  the sink's observer hook, keeping O(open-ops) state, and suppresses
  injected faults after firing so a confirming read always lands.

A fired-but-unconfirmed violation (possible for ``drop_acked`` only, e.g.
the run ended before anyone read) labels the history ``expect=unknown``
rather than guessing — the soak loop skips scoring those instead of ever
charging the checker with a false verdict on an unprovable instance.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field

from ..utils import events as ev
from ..utils.hashing import record_hash
from .clock import vsleep
from .collect import CollectConfig, collect_history, collect_to_file
from .fake_s2 import FakeS2Stream, FaultPlan
from .transport import (
    AppendAck,
    AppendConditionFailed,
    CheckTailError,
    DefiniteServerError,
    IndefiniteServerError,
    ReadError,
)

__all__ = [
    "VIOLATION_CLASSES",
    "CampaignPhase",
    "Campaign",
    "CampaignStream",
    "builtin_campaigns",
    "get_campaign",
    "campaign_config",
    "collect_labeled",
    "collect_labeled_to_file",
    "label_path_for",
]

#: Deliberate-violation classes a phase may arm (at most one fires per run).
VIOLATION_CLASSES = ("drop_acked", "reorder", "stale_read", "fence_resurrect")


@dataclass(frozen=True)
class CampaignPhase:
    """One window of the campaign timeline (durations in virtual seconds)."""

    name: str
    #: phase length on the VirtualClock; the last phase runs until the end
    duration_s: float
    faults: FaultPlan = field(default_factory=FaultPlan)
    #: client slots (collector spawn indices) that cannot reach the stream
    partition: tuple[int, ...] = ()
    #: crash-restart window: every call fails; records persist across it
    down: bool = False
    #: duplicate/torn ack delivery: the append applies but the ack is lost,
    #: surfacing as an ambiguous (indefinite) outcome — legal by design
    p_dup_ack: float = 0.0
    #: extra post-apply ack latency (late acks widen op overlap windows)
    late_ack_s: float = 0.0
    #: arm a deliberate-violation class (one of VIOLATION_CLASSES) or None
    violation: str | None = None


@dataclass(frozen=True)
class Campaign:
    name: str
    phases: tuple[CampaignPhase, ...]
    workflow: str = "regular"
    #: default collector sizing (CLI/tests may override)
    clients: int = 4
    ops: int = 48
    description: str = ""

    def __post_init__(self) -> None:
        if not self.phases:
            raise ValueError("a campaign needs at least one phase")
        armed = [p.violation for p in self.phases if p.violation is not None]
        if len(set(armed)) > 1:
            raise ValueError("a campaign may arm at most one violation class")
        for v in armed:
            if v not in VIOLATION_CLASSES:
                raise ValueError(f"unknown violation class {v!r}")

    def violation_class(self) -> str | None:
        for p in self.phases:
            if p.violation is not None:
                return p.violation
        return None

    def phase_at(self, now: float) -> tuple[int, CampaignPhase]:
        """Phase index + phase for a virtual timestamp (clamped to last)."""
        t = 0.0
        for i, ph in enumerate(self.phases[:-1]):
            t += ph.duration_s
            if now < t:
                return i, ph
        return len(self.phases) - 1, self.phases[-1]


class _CampaignClient:
    """Per-client-slot facade over a CampaignStream.

    The transport protocol carries no caller identity, but partitions and
    violations are per-client; the collector hands each spawned client its
    own facade (slot = spawn index, stable across client-id rotation).
    """

    def __init__(self, parent: "CampaignStream", slot: int) -> None:
        self._parent = parent
        self.slot = slot

    @property
    def clock(self):
        return self._parent.clock

    @clock.setter
    def clock(self, value) -> None:
        self._parent.clock = value

    async def append(self, bodies, **kw) -> AppendAck:
        return await self._parent.client_append(self.slot, bodies, **kw)

    async def read_all(self):
        return await self._parent.client_read(self.slot)

    async def check_tail(self) -> int:
        return await self._parent.client_check_tail(self.slot)

    def snapshot_bodies(self):
        return self._parent.snapshot_bodies()


class CampaignStream(FakeS2Stream):
    """A FakeS2Stream whose fault mix follows a campaign's phase timeline
    and which can commit (at most) one provable violation per history."""

    def __init__(self, campaign: Campaign, seed: int) -> None:
        super().__init__(
            rng=random.Random(seed ^ 0x5EED),
            faults=campaign.phases[0].faults,
        )
        self.campaign = campaign
        self.seed = seed
        #: dedicated rng for violation choices, so arming a violation does
        #: not shift the legal-fault coin sequence of the shared server rng
        self._vrng = random.Random((seed * 0x9E3779B1) ^ 0xFA117)
        #: set once, when the armed violation fires
        self.violation: dict | None = None
        self._confirmed = False
        # per-slot max tail actually observed via a completed successful op
        self._slot_observed_tail: dict[int | None, int] = {}
        # fencing-token life cycle, for fence_resurrect soundness: a token
        # is resurrectable only if its set attempt resolved as a *definite*
        # failure — never set, never ambiguous (an ambiguous/open fence op
        # could be modeled as applied, which would legalize the resurrect)
        self._tokens_inflight: set[str] = set()
        self._tokens_set: set[str] = set()
        self._tokens_tainted: set[str] = set()
        self._tokens_definite: set[str] = set()
        # drop_acked confirmation watches the event log via the sink
        # observer (log order == the checker's real-time order)
        self._track_drop = campaign.violation_class() == "drop_acked"
        self._open_appends: dict[tuple[int, int], tuple[int, ...]] = {}
        self._drop_hashes: tuple[int, ...] | None = None
        self._drop_finished = False
        self._post_drop_reads: set[tuple[int, int]] = set()

    # -- plumbing -----------------------------------------------------------

    def for_client(self, slot: int) -> _CampaignClient:
        return _CampaignClient(self, slot)

    def _now(self) -> float:
        return getattr(self.clock, "now", 0.0) if self.clock is not None else 0.0

    def _phase(self) -> tuple[int, CampaignPhase]:
        return self.campaign.phase_at(self._now())

    async def _plat(self, f: FaultPlan) -> None:
        if f.max_latency > 0:
            await vsleep(self.clock, self.rng.uniform(f.min_latency, f.max_latency))

    def _note_observed(self, slot: int | None, tail: int) -> None:
        if tail > self._slot_observed_tail.get(slot, 0):
            self._slot_observed_tail[slot] = tail

    def _forcing_honest(self) -> bool:
        """After a violation fires, suppress injected faults until it is
        confirmed so the confirming observation is guaranteed to land."""
        return self.violation is not None and not self._confirmed

    def _resolve_token(self, token: str | None, outcome: str) -> None:
        if token is None:
            return
        self._tokens_inflight.discard(token)
        {"set": self._tokens_set,
         "tainted": self._tokens_tainted,
         "definite": self._tokens_definite}[outcome].add(token)

    def _apply_tracked(self, bodies, set_fencing_token) -> int:
        tail = self._apply(bodies, set_fencing_token)
        if set_fencing_token is not None:
            self._resolve_token(set_fencing_token, "set")
        return tail

    # -- protocol surface (slot None = setup/unpartitioned caller) ----------

    async def append(self, bodies, **kw) -> AppendAck:
        return await self.client_append(None, bodies, **kw)

    async def read_all(self):
        return await self.client_read(None)

    async def check_tail(self) -> int:
        return await self.client_check_tail(None)

    # -- operations ---------------------------------------------------------

    async def client_append(
        self,
        slot: int | None,
        bodies,
        *,
        match_seq_num: int | None = None,
        fencing_token: str | None = None,
        set_fencing_token: str | None = None,
    ) -> AppendAck:
        if set_fencing_token is not None:
            # Track before any await: the Start event is already logged, so
            # from here this token has a visible (possibly open) set attempt.
            self._tokens_inflight.add(set_fencing_token)
        _, ph = self._phase()
        f = ph.faults
        await self._plat(f)
        honest = self._forcing_honest()
        if ph.down and not honest:
            self._resolve_token(set_fencing_token, "definite")
            await self._plat(f)
            raise DefiniteServerError("unavailable")
        if slot in ph.partition and not honest:
            self._resolve_token(set_fencing_token, "definite")
            await self._plat(f)
            raise DefiniteServerError("partitioned")
        if not honest and self.violation is None and ph.violation is not None:
            fired = self._try_violate_append(
                ph.violation,
                slot,
                bodies,
                match_seq_num=match_seq_num,
                fencing_token=fencing_token,
                set_fencing_token=set_fencing_token,
            )
            if fired is not None:
                await self._plat(f)
                return fired
        if not honest:
            r = self.rng.random()
            if r < f.p_append_definite:
                self._resolve_token(set_fencing_token, "definite")
                await self._plat(f)
                raise DefiniteServerError("rate_limited")
            if r < f.p_append_definite + f.p_append_indefinite:
                applied = (
                    self._preconditions_hold(match_seq_num, fencing_token)
                    and self.rng.random() < f.p_indefinite_applied
                )
                if applied:
                    self._apply_tracked(bodies, set_fencing_token)
                else:
                    self._resolve_token(set_fencing_token, "tainted")
                if set_fencing_token is not None and applied:
                    # applied but the client never learns: still ambiguous
                    self._tokens_tainted.add(set_fencing_token)
                await self._plat(f)
                raise IndefiniteServerError("deadline_exceeded")
            if ph.p_dup_ack > 0 and self.rng.random() < ph.p_dup_ack:
                # torn/duplicate ack: the append applies (when it can) but
                # the ack never arrives — ambiguous to the client, legal
                if self._preconditions_hold(match_seq_num, fencing_token):
                    self._apply_tracked(bodies, set_fencing_token)
                    if set_fencing_token is not None:
                        self._tokens_tainted.add(set_fencing_token)
                else:
                    self._resolve_token(set_fencing_token, "tainted")
                if ph.late_ack_s > 0:
                    await vsleep(
                        self.clock, ph.late_ack_s * self.rng.uniform(0.5, 1.5)
                    )
                await self._plat(f)
                raise IndefiniteServerError("ack_lost")
        if not self._preconditions_hold(match_seq_num, fencing_token):
            self._resolve_token(set_fencing_token, "definite")
            await self._plat(f)
            raise AppendConditionFailed(
                f"match_seq_num={match_seq_num} token={fencing_token!r} "
                f"vs tail={self.tail} stream_token={self.fencing_token!r}"
            )
        tail = self._apply_tracked(bodies, set_fencing_token)
        if not honest and self.violation is None and ph.violation == "reorder":
            self._maybe_reorder(slot, len(bodies))
        if not honest and ph.late_ack_s > 0:
            await vsleep(self.clock, ph.late_ack_s * self.rng.uniform(0.5, 1.5))
        await self._plat(f)
        self._note_observed(slot, tail)
        return AppendAck(tail=tail)

    async def client_read(self, slot: int | None):
        _, ph = self._phase()
        f = ph.faults
        await self._plat(f)
        honest = self._forcing_honest()
        if ph.down and not honest:
            await self._plat(f)
            raise ReadError("unavailable")
        if slot in ph.partition and not honest:
            await self._plat(f)
            raise ReadError("partitioned")
        if (
            not honest
            and self.violation is None
            and ph.violation == "stale_read"
        ):
            stale = self._try_violate_stale_read(slot)
            if stale is not None:
                await self._plat(f)
                return stale
        if not honest and self.rng.random() < f.p_read_fail:
            await self._plat(f)
            raise ReadError("stream reset")
        bodies = [r.body for r in self.records]
        if (
            self.violation is not None
            and self.violation["class"] == "reorder"
            and not self._confirmed
        ):
            # This read's fold includes the in-batch swap: no ordering of
            # the acked batches reproduces it, so the history is now pinned
            # non-linearizable (the client logs ReadSuccess unconditionally
            # once we return).
            self._confirmed = True
            self.violation["confirmed_at"] = self._now()
        await self._plat(f)
        self._note_observed(slot, len(bodies))
        return bodies

    async def client_check_tail(self, slot: int | None) -> int:
        _, ph = self._phase()
        f = ph.faults
        await self._plat(f)
        honest = self._forcing_honest()
        if ph.down and not honest:
            await self._plat(f)
            raise CheckTailError("unavailable")
        if slot in ph.partition and not honest:
            await self._plat(f)
            raise CheckTailError("partitioned")
        if not honest and self.rng.random() < f.p_check_tail_fail:
            await self._plat(f)
            raise CheckTailError("unavailable")
        t = self.tail
        await self._plat(f)
        self._note_observed(slot, t)
        return t

    # -- deliberate violations ----------------------------------------------

    def _fire(self, cls: str, slot: int | None, **detail) -> None:
        self.violation = {
            "class": cls,
            "slot": slot,
            "at": round(self._now(), 6),
            "phase": self._phase()[1].name,
            **detail,
        }

    def _try_violate_append(
        self,
        cls: str,
        slot: int | None,
        bodies,
        *,
        match_seq_num,
        fencing_token,
        set_fencing_token,
    ) -> AppendAck | None:
        if cls == "drop_acked":
            if (
                bodies
                and set_fencing_token is None
                and self._preconditions_hold(match_seq_num, fencing_token)
            ):
                claimed = self.tail + len(bodies)
                self._drop_hashes = tuple(record_hash(b) for b in bodies)
                self._fire(
                    "drop_acked", slot, claimed_tail=claimed, records=len(bodies)
                )
                # Nothing applied; the client receives a successful ack.
                return AppendAck(tail=claimed)
        elif cls == "fence_resurrect":
            if (
                bodies
                and set_fencing_token is None
                and fencing_token is not None
                and fencing_token in self._tokens_definite
                and fencing_token not in self._tokens_set
                and fencing_token not in self._tokens_tainted
                and fencing_token not in self._tokens_inflight
                and (match_seq_num is None or match_seq_num == self.tail)
            ):
                # The token's set attempt definitely failed, so it is
                # current in no branch of any linearization — yet we apply.
                tail = self._apply_tracked(bodies, None)
                self._fire(
                    "fence_resurrect", slot, token=fencing_token, tail=tail
                )
                self._confirmed = True
                self.violation["confirmed_at"] = self.violation["at"]
                return AppendAck(tail=tail)
        return None

    def _maybe_reorder(self, slot: int | None, n: int) -> None:
        """After an honest apply+ack of the last ``n`` records: swap the
        first adjacent pair with distinct bodies *within* the batch."""
        base = len(self.records) - n
        for i in range(n - 1):
            a, b = self.records[base + i], self.records[base + i + 1]
            if a.body != b.body:
                self.records[base + i], self.records[base + i + 1] = b, a
                self._fire(
                    "reorder",
                    slot,
                    batch_base=base,
                    swapped=(base + i, base + i + 1),
                )
                return

    def _try_violate_stale_read(self, slot: int | None):
        t_obs = self._slot_observed_tail.get(slot, 0)
        if t_obs < 1:
            return None
        stale = self._vrng.randrange(t_obs)
        self._fire("stale_read", slot, observed_tail=t_obs, served_tail=stale)
        self._confirmed = True
        self.violation["confirmed_at"] = self.violation["at"]
        # A true historical prefix — but strictly behind a tail this same
        # client already observed via a completed op, and tails never shrink.
        return [r.body for r in self.records[:stale]]

    # -- log observer (drop_acked confirmation) -----------------------------

    def observe(self, le: ev.LabeledEvent) -> None:
        """Sink observer: sees every event in final log order, O(open-ops)
        state.  Only drop_acked needs it — its illegality proof rides on a
        read whose Start is logged after the dropped append's Finish."""
        if not self._track_drop or self._confirmed:
            return
        e = le.event
        key = (le.client_id, le.op_id)
        if isinstance(e, ev.AppendStart):
            self._open_appends[key] = tuple(e.record_hashes)
        elif isinstance(
            e, (ev.AppendSuccess, ev.AppendDefiniteFailure, ev.AppendIndefiniteFailure)
        ):
            hashes = self._open_appends.pop(key, None)
            if (
                not self._drop_finished
                and self._drop_hashes is not None
                and hashes == self._drop_hashes
                and isinstance(e, ev.AppendSuccess)
            ):
                self._drop_finished = True
        elif isinstance(e, ev.ReadStart):
            if self._drop_finished:
                self._post_drop_reads.add(key)
        elif isinstance(e, (ev.ReadSuccess, ev.ReadFailure)):
            if key in self._post_drop_reads:
                self._post_drop_reads.discard(key)
                if isinstance(e, ev.ReadSuccess) and self.violation is not None:
                    self._confirmed = True
                    self.violation["confirmed_by"] = {
                        "client_id": le.client_id,
                        "op_id": le.op_id,
                    }

    # -- labeling -----------------------------------------------------------

    def label(self) -> dict:
        """Ground-truth sidecar for the collected history (JSON-safe)."""
        armed = self.campaign.violation_class()
        fired = self.violation is not None
        if not fired:
            expect = "legal"
        elif self._confirmed:
            expect = "illegal"
        else:
            expect = "unknown"
        return {
            "campaign": self.campaign.name,
            "seed": self.seed,
            "workflow": self.campaign.workflow,
            "expect": expect,
            "violation": armed,
            "fired": fired,
            "confirmed": self._confirmed,
            "detail": dict(self.violation) if self.violation else None,
        }


# --------------------------------------------------------------------------
# Built-in campaign matrix
# --------------------------------------------------------------------------

def _quiet(lat: float = 0.003) -> FaultPlan:
    return FaultPlan(min_latency=0.001, max_latency=lat)


def _chaosy(intensity: float = 0.2) -> FaultPlan:
    return FaultPlan.chaos(intensity=intensity, max_latency=0.004)


def _storm() -> FaultPlan:
    return FaultPlan(
        p_append_definite=0.1,
        p_append_indefinite=0.25,
        p_read_fail=0.15,
        p_check_tail_fail=0.15,
        min_latency=0.004,
        max_latency=0.02,
    )


def builtin_campaigns() -> dict[str, Campaign]:
    """The seeded campaign matrix `make soak` runs: every legal fault shape
    and every violation class, each as one named, replayable campaign."""
    legal = [
        Campaign(
            name="steady",
            description="uniform light chaos, no phase transitions",
            phases=(CampaignPhase("steady", 1.0, faults=_chaosy(0.15)),),
        ),
        Campaign(
            name="partition",
            description="two client slots lose the stream mid-run, then heal",
            phases=(
                CampaignPhase("warmup", 0.05, faults=_quiet()),
                CampaignPhase(
                    "partitioned", 0.1, faults=_chaosy(0.2), partition=(1, 2)
                ),
                CampaignPhase("healed", 1.0, faults=_quiet()),
            ),
        ),
        Campaign(
            name="ack-storm",
            description="duplicate/torn acks + late acks under a latency storm",
            phases=(
                CampaignPhase("warmup", 0.04, faults=_quiet()),
                CampaignPhase(
                    "storm", 0.12, faults=_storm(), p_dup_ack=0.2, late_ack_s=0.01
                ),
                CampaignPhase("calm", 1.0, faults=_quiet()),
            ),
        ),
        Campaign(
            name="crash-restart",
            description="the stream crashes (every call fails) and restarts "
            "with its records intact",
            phases=(
                CampaignPhase("up", 0.05, faults=_chaosy(0.2)),
                CampaignPhase("down", 0.05, faults=_quiet(), down=True),
                CampaignPhase("restarted", 1.0, faults=_quiet()),
            ),
        ),
        Campaign(
            name="fencing-race",
            description="fencing workflow under a storm: token races stay legal",
            workflow="fencing",
            phases=(
                CampaignPhase("race", 0.08, faults=_storm()),
                CampaignPhase("settle", 1.0, faults=_chaosy(0.15)),
            ),
        ),
    ]
    illegal = [
        Campaign(
            name="drop-acked",
            description="an acked append silently never applies",
            phases=(
                CampaignPhase("warmup", 0.06, faults=_chaosy(0.15)),
                CampaignPhase(
                    "violate", 1.0, faults=_quiet(), violation="drop_acked"
                ),
            ),
        ),
        Campaign(
            name="reorder",
            description="applied records reordered behind an acked tail",
            phases=(
                CampaignPhase("warmup", 0.06, faults=_chaosy(0.15)),
                CampaignPhase("violate", 1.0, faults=_quiet(), violation="reorder"),
            ),
        ),
        Campaign(
            name="stale-read",
            description="one client is served a tail behind what it already saw",
            phases=(
                CampaignPhase("warmup", 0.06, faults=_quiet()),
                CampaignPhase(
                    "violate", 1.0, faults=_quiet(), violation="stale_read"
                ),
            ),
        ),
        Campaign(
            name="fence-resurrect",
            description="a definitely-fenced-out writer's append is accepted",
            workflow="fencing",
            phases=(
                CampaignPhase("warmup", 0.06, faults=_quiet()),
                CampaignPhase(
                    "violate", 1.0, faults=_quiet(), violation="fence_resurrect"
                ),
            ),
        ),
    ]
    return {c.name: c for c in legal + illegal}


def get_campaign(name: str) -> Campaign:
    table = builtin_campaigns()
    try:
        return table[name]
    except KeyError:
        raise KeyError(
            f"unknown campaign {name!r}; known: {', '.join(sorted(table))}"
        ) from None


# --------------------------------------------------------------------------
# Labeled collection
# --------------------------------------------------------------------------

def campaign_config(
    campaign: Campaign,
    seed: int,
    *,
    clients: int | None = None,
    ops: int | None = None,
) -> CollectConfig:
    return CollectConfig(
        num_concurrent_clients=clients if clients is not None else campaign.clients,
        num_ops_per_client=ops if ops is not None else campaign.ops,
        workflow=campaign.workflow,
        seed=seed,
        faults=FaultPlan(),  # unused: phases carry the fault plans
        indefinite_failure_backoff_s=0.002,
        max_client_ids=64,
    )


def _finish_label(label: dict, cfg: CollectConfig) -> dict:
    label["clients"] = cfg.num_concurrent_clients
    label["ops"] = cfg.num_ops_per_client
    return label


def collect_labeled(
    campaign: Campaign,
    seed: int,
    *,
    clients: int | None = None,
    ops: int | None = None,
) -> tuple[list[ev.LabeledEvent], dict]:
    """Run one campaign in-memory; returns (events, ground-truth label)."""
    cfg = campaign_config(campaign, seed, clients=clients, ops=ops)
    stream = CampaignStream(campaign, seed)
    events = collect_history(cfg, stream)
    return events, _finish_label(stream.label(), cfg)


def label_path_for(history_path: str) -> str:
    return history_path + ".label.json"


def collect_labeled_to_file(
    campaign: Campaign,
    seed: int,
    out_dir: str = "./data",
    *,
    clients: int | None = None,
    ops: int | None = None,
) -> tuple[str, str, dict]:
    """Stream one campaign's history to ``<out_dir>/records.<epoch>.jsonl``
    and its label to ``<path>.label.json``; returns (path, label_path, label)."""
    cfg = campaign_config(campaign, seed, clients=clients, ops=ops)
    stream = CampaignStream(campaign, seed)
    path = collect_to_file(cfg, stream, out_dir)
    label = _finish_label(stream.label(), cfg)
    lpath = label_path_for(path)
    with open(lpath, "w", encoding="utf-8") as f:
        json.dump(label, f, sort_keys=True, indent=1)
        f.write("\n")
    return path, lpath, label
