"""Command line: ``python -m s2_verification_tpu_torch check -file=H.jsonl``
and ``python -m s2_verification_tpu_torch collect``.

``collect`` records a history against the in-process fault-injecting fake
S2 (``collector/``), with the JAX package's flags and defaults, writes
``<out-dir>/records.<epoch>.jsonl`` and prints its path (exit 0; 64 on a
usage error or an unknown ``--campaign``).

``check`` decides one JSONL history (the reference collector's format,
utils/events.py) and exits with the verdict, as the JAX package's CLI does:

    0  linearizable (OK) — the witness linearization is logged
    1  not linearizable (ILLEGAL) — the refusal reports are logged
    2  inconclusive (UNKNOWN)
    64 usage or parse error; also: no CUDA device for ``-device cuda``, a
       ``-checkpoint`` file that cannot resume this search, or a search tier
       that this port does not have yet (with ``-stats`` the JSON line then
       says ``"outcome": "unported"`` and names the tier)

Backends: ``device`` (default) runs the GPU frontier search
(checker/device.py::check_device_auto) on ``-device`` (``cuda`` by default;
``cpu`` runs the same search with the plain PyTorch fold); ``oracle`` runs
the CPU Wing–Gong reference (checker/oracle.py), bounded by
``-time-budget``.  The device search ignores ``-time-budget``, as in the
JAX package.  ``-device-rows N`` caps the device-resident frontier of the
device search's exhaustive phase (default 2^23 on the card, 0 on the CPU:
past its 2^20-row bucket the frontier grows on the device up to N rows,
expanded in chunks; past N it spills to host RAM and streams through the
device layer by layer).  ``-checkpoint PATH`` snapshots the device search
(``PATH.beam`` for its beam phase, ``PATH`` and ``PATH.spill.npz`` for the
exhaustive phase, in the JAX package's format) and resumes a matching
snapshot; the oracle ignores it.
``--prune`` and ``--speculate-depth K`` turn on the device
search's verdict-exact prunes and speculative dive (the oracle ignores
both); ``-profile OUT.json`` writes the search-shape profile
(checker/profile.py).  There is no HTML visualization yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from . import __version__
from .checker.checkpoint import CheckpointError
from .checker.device import DeviceUnavailable, check_device_auto
from .checker.entries import History, prepare
from .checker.oracle import CheckOutcome, CheckResult, check
from .checker.profile import accel_counters, job_profile
from .collector.collect import CollectConfig, collect_to_file
from .collector.fake_s2 import FaultPlan
from .utils import events as ev

log = logging.getLogger("s2_verification_tpu_torch.cli")

USAGE_EXIT = 64


class _Parser(argparse.ArgumentParser):
    """argparse exits 2 on usage errors, which would collide with the
    'inconclusive' verdict; route usage errors to the documented 64."""

    def error(self, message: str) -> None:  # noqa: D401 - argparse hook
        self.print_usage(sys.stderr)
        self.exit(USAGE_EXIT, f"{self.prog}: error: {message}\n")


def _read_events(path: str) -> list[ev.LabeledEvent]:
    if path == "-":
        return list(ev.iter_history(sys.stdin))
    return ev.read_history(path)


def _run_backend(args: argparse.Namespace, hist: History) -> CheckResult:
    if args.backend == "oracle":
        if args.checkpoint is not None:
            log.warning(
                "-checkpoint only applies to the device search; the %s backend will not snapshot",
                args.backend,
            )
        if args.device_rows is not None:
            log.warning(
                "-device-rows only applies to the device search; the %s backend ignores it",
                args.backend,
            )
        budget = args.time_budget
        return check(hist, time_budget_s=None if budget is None or budget <= 0 else budget)
    dev_kw = {} if args.device_rows is None else {"device_rows_cap": args.device_rows}
    return check_device_auto(
        hist,
        collect_stats=args.stats,
        device=args.device,
        checkpoint_path=args.checkpoint,
        profile=bool(args.profile),
        prune=args.prune,
        speculate_depth=args.speculate_depth,
        **dev_kw,
    )


def _check_one(args: argparse.Namespace, on_result=None) -> int:
    file_path = args.file
    try:
        events = _read_events(file_path)
    except (OSError, ValueError) as e:
        log.error("failed to read history: %s", e)
        return USAGE_EXIT
    try:
        checked = prepare(events, elide_trivial=True)
    except ValueError as e:
        log.error("malformed history: %s", e)
        return USAGE_EXIT

    t0 = time.monotonic()
    try:
        res = _run_backend(args, checked)
    except DeviceUnavailable as e:
        log.error("%s", e)
        return USAGE_EXIT
    except CheckpointError as e:
        log.error("%s — remove the file or point -checkpoint elsewhere", e)
        return USAGE_EXIT
    except NotImplementedError as e:
        # Not bad input: the search needs a tier this port lacks.  -stats
        # says so, so a caller can tell the two 64s apart.
        log.error("cannot decide this history yet: %s", e)
        if args.stats:
            line = {"file": file_path, "outcome": "unported", "backend": args.backend, "reason": str(e)}
            print(json.dumps(line), flush=True)
        return USAGE_EXIT
    dt = time.monotonic() - t0
    if on_result is not None:
        on_result(file_path, res, checked)

    if args.profile:
        # Search-shape profile: FrontierStats fields + the per-segment
        # timeline, the JAX CLI's schema.
        prof = job_profile(res)
        prof.update(
            file=file_path,
            outcome=res.outcome.value,
            backend=args.backend,
            wall_s=round(dt, 4),
            ops=len(checked.ops),
        )
        with open(args.profile, "w", encoding="utf-8") as f:
            json.dump(prof, f, indent=2)
            f.write("\n")
        log.info("wrote search profile to %s", args.profile)

    if args.stats:
        # One machine-readable line on stdout: verdict, wall-clock, search
        # statistics (the JAX CLI's -stats schema plus host_syncs/device).
        line = {
            "file": file_path,
            "outcome": res.outcome.value,
            "backend": args.backend,
            "wall_s": round(dt, 4),
            "ops": len(checked.ops),
            "witness": res.linearization is not None,
        }
        st = getattr(res, "stats", None)
        if st is not None:
            line.update(
                layers=st.layers,
                max_frontier=st.max_frontier,
                expanded=st.expanded,
                auto_closed=st.auto_closed,
                pruned=st.pruned,
                host_syncs=st.host_syncs,
                device=args.device,
            )
            line.update(accel_counters(st))
        if res.steps:
            line["steps"] = res.steps
        print(json.dumps(line), flush=True)

    if res.outcome == CheckOutcome.OK:
        log.info(
            "history is linearizable (%s backend, %.3fs, %d ops)",
            args.backend,
            dt,
            len(checked.ops),
        )
        if res.linearization is not None:
            ops = checked.ops
            log.info(
                "witness (op_id order): %s",
                " ".join(str(ops[i].op_id) for i in res.linearization),
            )
        return 0
    if res.outcome == CheckOutcome.ILLEGAL:
        log.error("history is NOT linearizable (%s backend, %.3fs)", args.backend, dt)
        ops = checked.ops
        for prefix, refused in res.refusals:
            log.error(
                "after %d linearized ops, refused: %s",
                len(prefix),
                " ".join(f"op_id={ops[i].op_id}" for i in refused) or "(none)",
            )
        return 1
    log.error("check inconclusive (%s backend, %.3fs)", args.backend, dt)
    return 2


def _cmd_collect(args: argparse.Namespace) -> int:
    if args.list_campaigns:
        from .collector.campaign import builtin_campaigns

        for name, c in sorted(builtin_campaigns().items()):
            print(
                f"{name:16s} workflow={c.workflow:13s} "
                f"violation={c.violation_class() or '-':15s} {c.description}"
            )
        return 0
    if args.campaign:
        from .collector.campaign import collect_labeled_to_file, get_campaign

        try:
            campaign = get_campaign(args.campaign)
        except KeyError as e:
            log.error("%s", e.args[0])
            return USAGE_EXIT
        if args.socket:
            log.error(
                "--campaign needs the in-process path (per-client fault "
                "facades); --socket is unsupported"
            )
            return USAGE_EXIT
        if args.workflow is not None and args.workflow != campaign.workflow:
            log.warning(
                "--workflow %s ignored: campaign %r runs workflow %s",
                args.workflow,
                campaign.name,
                campaign.workflow,
            )
        path, lpath, label = collect_labeled_to_file(
            campaign,
            args.seed,
            out_dir=args.out_dir,
            clients=args.num_concurrent_clients,
            ops=args.num_ops_per_client,
        )
        log.info(
            "ground-truth label expect=%s (violation=%s confirmed=%s) at %s",
            label["expect"],
            label["violation"],
            label["confirmed"],
            lpath,
        )
        print(path)
        return 0
    faults = FaultPlan.chaos(args.chaos) if args.chaos > 0 else FaultPlan()
    cfg = CollectConfig(
        num_concurrent_clients=(
            5 if args.num_concurrent_clients is None else args.num_concurrent_clients
        ),
        num_ops_per_client=(
            100 if args.num_ops_per_client is None else args.num_ops_per_client
        ),
        workflow=args.workflow if args.workflow is not None else "regular",
        seed=args.seed,
        faults=faults,
    )
    if args.socket:
        # The stream state and fault injection live in a server on another
        # thread and loop; the collector speaks the seam protocol over a
        # real unix socket (collect-history.rs:70-94 speaks to a network
        # endpoint).
        from .collector.collect import default_stream
        from .collector.socket_s2 import S2SocketServer, S2SocketTransport

        with S2SocketServer(default_stream(cfg), args.socket):
            path = collect_to_file(
                cfg, stream=S2SocketTransport(args.socket), out_dir=args.out_dir
            )
    else:
        path = collect_to_file(cfg, out_dir=args.out_dir)
    # The reference prints the history path as its last act
    # (collect-history.rs:195-200).
    print(path)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(
        prog="s2_verification_tpu_torch",
        description="S2 linearizability checker on PyTorch + CUDA",
    )
    p.add_argument("-version", "--version", action="version", version=__version__)
    sub = p.add_subparsers(dest="cmd", required=True, parser_class=_Parser)
    c = sub.add_parser("check", help="check a JSONL history for linearizability")
    c.add_argument("-file", "--file", required=True, help="history JSONL path, '-' for stdin")
    c.add_argument("-backend", "--backend", default="device", choices=["device", "oracle"])
    c.add_argument(
        "-device",
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the device backend runs (default cuda; cpu runs the "
        "plain PyTorch fold instead of the CUDA kernel)",
    )
    c.add_argument(
        "-time-budget",
        "--time-budget",
        type=float,
        default=None,
        help="oracle time budget in seconds (0 or unset = run to completion)",
    )
    c.add_argument(
        "-checkpoint",
        "--checkpoint",
        default=None,
        metavar="PATH",
        help="snapshot file for long device searches (resume + preemption safety)",
    )
    c.add_argument(
        "-device-rows",
        "--device-rows",
        type=int,
        default=None,
        help="device-resident frontier cap for the device search's "
        "exhaustive phase (default 2^23 on the card, 0 on the CPU; the "
        "chunked tier engages only above the 2^20 exhaustive bucket — "
        "smaller values, or 0, disable it); past it the frontier spills "
        "to host RAM",
    )
    c.add_argument(
        "--prune",
        action="store_true",
        help="verdict-exact search pruning (checker/prune.py): forced "
        "append order, eager commit of inert/passing-filter ops, "
        "tail-pin dead-configuration elimination — same verdicts, "
        "smaller search",
    )
    c.add_argument(
        "--speculate-depth",
        type=int,
        default=0,
        metavar="K",
        help="speculative multi-layer expansion for the device search: "
        "one K-layer dive per search segment, wholesale-discarded on "
        "misprediction (0 = off)",
    )
    c.add_argument(
        "-stats",
        "--stats",
        action="store_true",
        help="print one machine-readable JSON line on stdout (with the "
        "prune and speculation counters where nonzero)",
    )
    c.add_argument(
        "-profile",
        "--profile",
        default=None,
        metavar="OUT.json",
        help="write a search-shape profile JSON (FrontierStats + "
        "per-segment timeline) — the JAX CLI's schema",
    )

    g = sub.add_parser("collect", help="collect a history against the fake S2")
    g.add_argument(
        "basin",
        nargs="?",
        default="local",
        help="ignored (collection runs against the in-process fake S2)",
    )
    g.add_argument(
        "stream",
        nargs="?",
        default="stream",
        help="ignored (collection runs against the in-process fake S2)",
    )
    g.add_argument(
        "--num-concurrent-clients",
        type=int,
        default=None,
        help="default 5 (or the campaign's own sizing with --campaign)",
    )
    g.add_argument(
        "--num-ops-per-client",
        type=int,
        default=None,
        help="default 100 (or the campaign's own sizing with --campaign)",
    )
    g.add_argument(
        "--workflow",
        default=None,
        choices=["regular", "match-seq-num", "fencing"],
        help="default regular; a --campaign dictates its own workflow",
    )
    g.add_argument("--seed", type=int, default=0)
    g.add_argument(
        "--chaos",
        type=float,
        default=0.2,
        help="fault-injection intensity for the fake S2 (0 disables)",
    )
    g.add_argument(
        "--campaign",
        metavar="NAME",
        help="run one named fault campaign (time-phased faults, optional "
        "deliberate violation) and write a ground-truth "
        "<path>.label.json sidecar (expect=legal|illegal + the injected "
        "violation class) next to the history",
    )
    g.add_argument(
        "--list-campaigns",
        action="store_true",
        help="list the builtin campaign matrix and exit",
    )
    g.add_argument("--out-dir", default="./data")
    g.add_argument(
        "--socket",
        metavar="PATH",
        help="collect over a loopback unix-domain socket at PATH (serves "
        "the fault-injecting stream from another thread) instead of the "
        "in-process call path",
    )
    return p


def main(argv: list[str] | None = None, *, on_result=None) -> int:
    """Run the CLI.  ``on_result(path, CheckResult, History)``, when given,
    is called with each history ``check`` decides — for in-process callers
    that inspect the witness."""
    logging.basicConfig(
        stream=sys.stderr,
        level=os.environ.get("S2VTPU_LOG", "INFO").upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    args = build_parser().parse_args(argv)
    if args.cmd == "collect":
        return _cmd_collect(args)
    return _check_one(args, on_result=on_result)


if __name__ == "__main__":
    raise SystemExit(main())
