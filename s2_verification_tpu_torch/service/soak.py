"""Closed-loop soak: generate → submit → score against ground truth.

The collector's fault campaigns (:mod:`..collector.campaign`) emit each
history with a sound ``expect=legal|illegal`` label.  The soak runner
closes the loop: it drives a seeded campaign schedule, submits every
labeled history to a live verifyd daemon or router fleet over the normal
client path, and compares each verdict with its label — continuously proving the checker catches real
violations (and never invents them) while the serving fleet may itself be
under chaos.

A verdict that contradicts its ground-truth label is a **checker false
verdict** — the one failure mode the rest of the test pyramid cannot see.
On any mismatch the runner:

- raises the ``checker_false_verdict`` builtin alert (webhook delivery via
  the alert engine, when configured);
- dumps a flight-recorder marker carrying the offending history's
  fingerprint, campaign name and seed — one command reproduces the exact
  bytes (campaigns are deterministic);
- saves the offending history + label under ``<state_dir>/false_verdicts``;
- finishes the schedule and reports nonzero (exit 1).

``verifyd_soak_*`` metric families make the loop observable like every
other subsystem; ``--metrics-port`` serves them over the standard
``/metrics`` endpoint.  The port's copy of the JAX package's
``service/soak.py``, over the port's campaigns, alerts and flight
recorder.
"""

from __future__ import annotations

import io
import json
import logging
import os
import time
from dataclasses import dataclass

from ..checker.entries import prepare
from ..collector.campaign import builtin_campaigns, collect_labeled, get_campaign
from ..obs.alerts import AlertEngine
from ..obs.flight import FLIGHT_SUBDIR, FlightRecorder
from ..obs.metrics import MetricsRegistry
from ..utils import events as ev
from .cache import history_fingerprint
from .client import VerifydClient, VerifydError

__all__ = ["SoakConfig", "SoakRunner", "soak_exit_code", "repro_command"]

log = logging.getLogger("s2_verification_tpu_torch.soak")

#: verdict ints from the wire (oracle CheckOutcome values)
_VERDICT_NAMES = {0: "legal", 1: "illegal", 2: "unknown"}


@dataclass
class SoakConfig:
    #: daemon or router address (unix-socket path or host:port)
    address: str
    secret: bytes | None = None
    #: campaign names to run; empty = the full builtin matrix
    campaigns: tuple[str, ...] = ()
    seed: int = 0
    #: how many passes over the campaign list (each with fresh seeds)
    cycles: int = 1
    #: override campaign client/op sizing (None = campaign defaults)
    clients: int | None = None
    ops: int | None = None
    #: submit retry policy (rides out fleet failovers / restarts)
    retries: int = 8
    backoff_s: float = 0.25
    submit_timeout_s: float | None = 120.0
    deadline_s: float | None = None
    #: alert webhook for checker_false_verdict delivery (None = no webhooks)
    alert_url: str | None = None
    #: flight ring + offending-history dumps live here (None = neither)
    state_dir: str | None = None
    #: serve /metrics on this port (None = no endpoint; 0 = ephemeral)
    metrics_port: int | None = None
    #: control case: deliberately flip the first scored history's label to
    #: prove the false-verdict alert + nonzero-exit path end to end
    mislabel_first: bool = False


def repro_command(label: dict) -> str:
    """One command that regenerates the flagged history byte-identically."""
    cmd = (
        f"python -m s2_verification_tpu_torch collect"
        f" --campaign {label['campaign']} --seed {label['seed']}"
    )
    if label.get("clients") is not None:
        cmd += f" --num-concurrent-clients {label['clients']}"
    if label.get("ops") is not None:
        cmd += f" --num-ops-per-client {label['ops']}"
    return cmd


class SoakRunner:
    """Runs one soak schedule to completion and scores every verdict."""

    def __init__(
        self,
        cfg: SoakConfig,
        *,
        registry: MetricsRegistry | None = None,
        engine: AlertEngine | None = None,
        recorder: FlightRecorder | None = None,
    ) -> None:
        self.cfg = cfg
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._m_generated = r.counter(
            "verifyd_soak_histories_generated_total",
            "Labeled campaign histories generated",
            labelnames=("campaign",),
        )
        self._m_submitted = r.counter(
            "verifyd_soak_submitted_total",
            "Labeled histories submitted for verdicts",
            labelnames=("campaign",),
        )
        self._m_verdicts = r.counter(
            "verifyd_soak_verdicts_total",
            "Verdicts scored, by ground-truth label x checker answer",
            labelnames=("expected", "actual"),
        )
        self._m_false = r.counter(
            "verifyd_soak_false_verdicts_total",
            "Verdicts that contradicted their ground-truth label",
            labelnames=("campaign",),
        )
        self._m_inconclusive = r.counter(
            "verifyd_soak_inconclusive_total",
            "Submissions answered UNKNOWN (not scored as false)",
            labelnames=("campaign",),
        )
        self._m_unlabeled = r.counter(
            "verifyd_soak_unlabeled_total",
            "Histories whose violation fired but never confirmed (skipped)",
            labelnames=("campaign",),
        )
        self._m_errors = r.counter(
            "verifyd_soak_submit_errors_total",
            "Submissions lost to transport/daemon errors after retries",
            labelnames=("campaign",),
        )
        self._m_phase = r.gauge(
            "verifyd_soak_campaign_phase",
            "Schedule position: index of the campaign run in flight",
        )
        self.recorder = recorder
        self._own_recorder = False
        if self.recorder is None and cfg.state_dir:
            os.makedirs(cfg.state_dir, exist_ok=True)
            self.recorder = FlightRecorder(
                os.path.join(cfg.state_dir, FLIGHT_SUBDIR)
            )
            self._own_recorder = True
        self.engine = engine
        self._own_engine = False
        if self.engine is None and cfg.alert_url:
            # dedup_s=0: a soak wants every false verdict delivered, not
            # one page per window
            self.engine = AlertEngine(
                cfg.alert_url,
                registry=self.registry,
                recorder=self.recorder,
                dedup_s=0.0,
            )
            self._own_engine = True

    # -- schedule ------------------------------------------------------------

    def schedule(self) -> list[tuple[str, int]]:
        names = list(self.cfg.campaigns) or sorted(builtin_campaigns())
        out = []
        for cycle in range(self.cfg.cycles):
            for i, name in enumerate(names):
                out.append((name, self.cfg.seed + cycle * 8191 + i * 131))
        return out

    # -- one run -------------------------------------------------------------

    def run(self) -> dict:
        cfg = self.cfg
        client = VerifydClient(
            cfg.address, timeout=cfg.submit_timeout_s, secret=cfg.secret
        )
        sched = self.schedule()
        results: list[dict] = []
        false_verdicts: list[dict] = []
        errors: list[dict] = []
        table: dict[str, int] = {}
        unlabeled = inconclusive = submitted = 0
        t0 = time.time()
        for idx, (name, seed) in enumerate(sched):
            self._m_phase.set(idx)
            campaign = get_campaign(name)
            events, label = collect_labeled(
                campaign, seed, clients=cfg.clients, ops=cfg.ops
            )
            self._m_generated.inc(campaign=name)
            expect = label["expect"]
            if cfg.mislabel_first and idx == 0:
                # Deliberately poisoned control: the checker *should*
                # disagree with this label, proving the sentinel fires.
                expect = "illegal" if expect == "legal" else "legal"
                label = {**label, "expect": expect, "mislabeled_control": True}
            row = {
                "campaign": name,
                "seed": seed,
                "expect": expect,
                "events": len(events),
                "control": bool(label.get("mislabeled_control")),
            }
            if expect == "unknown":
                # Fired-but-unconfirmed violation: no sound label exists,
                # so scoring it either way could frame the checker.
                unlabeled += 1
                self._m_unlabeled.inc(campaign=name)
                row["outcome"] = "unlabeled"
                results.append(row)
                log.warning(
                    "soak[%d] %s seed=%d: violation unconfirmed; skipped",
                    idx,
                    name,
                    seed,
                )
                continue
            buf = io.StringIO()
            ev.write_history(events, buf)
            text = buf.getvalue()
            row["fingerprint"] = history_fingerprint(prepare(events))
            try:
                reply = client.submit_with_retry(
                    text,
                    client="soak",
                    no_viz=True,
                    retries=cfg.retries,
                    backoff_s=cfg.backoff_s,
                    deadline_s=cfg.deadline_s,
                )
            except (VerifydError, OSError) as e:
                self._m_errors.inc(campaign=name)
                row["outcome"] = "submit_error"
                row["error"] = f"{type(e).__name__}: {e}"
                errors.append(row)
                results.append(row)
                log.error("soak[%d] %s seed=%d: submit lost: %s", idx, name, seed, e)
                continue
            submitted += 1
            self._m_submitted.inc(campaign=name)
            actual = _VERDICT_NAMES.get(int(reply.get("verdict", 2)), "unknown")
            self._m_verdicts.inc(expected=expect, actual=actual)
            table[f"{expect}->{actual}"] = table.get(f"{expect}->{actual}", 0) + 1
            row.update(
                actual=actual,
                backend=reply.get("backend"),
                cached=reply.get("cached"),
                trace_id=reply.get("trace_id"),
            )
            if actual == "unknown":
                inconclusive += 1
                self._m_inconclusive.inc(campaign=name)
                row["outcome"] = "inconclusive"
            elif actual != expect:
                self._m_false.inc(campaign=name)
                row["outcome"] = "false_verdict"
                self._flag_false_verdict(row, label, text)
                false_verdicts.append(row)
            else:
                row["outcome"] = "ok"
            results.append(row)
            log.info(
                "soak[%d/%d] %s seed=%d expect=%s actual=%s (%s)",
                idx + 1,
                len(sched),
                name,
                seed,
                expect,
                row.get("actual", "-"),
                row["outcome"],
            )
        self._m_phase.set(len(sched))
        if self.engine is not None:
            self.engine.flush()
            if self._own_engine:
                self.engine.close()
        if self.recorder is not None and self._own_recorder:
            self.recorder.close()
        return {
            "schedule": [list(s) for s in sched],
            "generated": len(sched),
            "submitted": submitted,
            "ok": sum(1 for r in results if r["outcome"] == "ok"),
            "false_verdicts": false_verdicts,
            "submit_errors": errors,
            "inconclusive": inconclusive,
            "unlabeled": unlabeled,
            "verdict_table": table,
            "wall_s": round(time.time() - t0, 3),
            "results": results,
        }

    # -- sentinel ------------------------------------------------------------

    def _flag_false_verdict(self, row: dict, label: dict, text: str) -> None:
        repro = repro_command(label)
        payload = {
            "fingerprint": row.get("fingerprint"),
            "campaign": row["campaign"],
            "seed": row["seed"],
            "expected": row["expect"],
            "actual": row["actual"],
            "trace_id": row.get("trace_id"),
            "repro": repro,
        }
        log.error(
            "CHECKER FALSE VERDICT: %s expected=%s actual=%s — repro: %s",
            row.get("fingerprint"),
            row["expect"],
            row["actual"],
            repro,
        )
        if self.engine is not None:
            self.engine.observe_event({"ev": "checker_false_verdict", **payload})
        if self.recorder is not None:
            self.recorder.dump("checker_false_verdict", **payload)
        if self.cfg.state_dir:
            d = os.path.join(self.cfg.state_dir, "false_verdicts")
            os.makedirs(d, exist_ok=True)
            base = os.path.join(d, str(row.get("fingerprint", "unknown")))
            with open(base + ".jsonl", "w", encoding="utf-8") as f:
                f.write(text)
            with open(base + ".label.json", "w", encoding="utf-8") as f:
                json.dump({**label, "repro": repro}, f, sort_keys=True, indent=1)
                f.write("\n")


def soak_exit_code(summary: dict) -> int:
    """1 on any checker false verdict; 3 when the loop could not prove
    itself clean (lost submissions, UNKNOWN verdicts, unlabeled skips);
    0 for a clean, fully-scored run."""
    if summary["false_verdicts"]:
        return 1
    if summary["submit_errors"] or summary["inconclusive"] or summary["unlabeled"]:
        return 3
    return 0
