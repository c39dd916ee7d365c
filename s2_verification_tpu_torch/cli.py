"""Command line: ``python -m s2_verification_tpu_torch check -file=H.jsonl``
and ``python -m s2_verification_tpu_torch collect``.

``collect`` records a history against the in-process fault-injecting fake
S2 (``collector/``), with the JAX package's flags and defaults, writes
``<out-dir>/records.<epoch>.jsonl`` and prints its path (exit 0; 64 on a
usage error or an unknown ``--campaign``).

``check`` decides one JSONL history (the reference collector's format,
utils/events.py), or a corpus of them, and exits with the verdict, as the
JAX package's CLI does:

    0  linearizable (OK) — the witness linearization is logged
    1  not linearizable (ILLEGAL) — the refusal reports are logged
    2  inconclusive (UNKNOWN)
    64 usage or parse error; also: no CUDA device where the device search
       runs on ``-device cuda``, ``-backend=native`` without a buildable
       native engine, a ``-checkpoint`` file that cannot resume this
       search, or a search tier that this port does not have yet (with
       ``-stats`` the JSON line then says ``"outcome": "unported"`` and
       names the tier)

Backends, the JAX package's:

- ``oracle``   — the Python Wing–Gong search (checker/oracle.py);
- ``native``   — the same search in C++ (``csrc/s2check.cpp``, built at
                 first use; checker/native.py);
- ``frontier`` — the host BFS frontier engine (checker/frontier.py);
- ``device``   — the GPU frontier search (checker/device.py's
                 ``check_device_auto``) on ``-device`` (``cuda`` by
                 default; ``cpu`` runs it with the plain PyTorch fold);
- ``auto`` (the default) — the native engine (the Python oracle when it
                 cannot be built) within a CPU budget of ``-time-budget``
                 seconds, 10 when unset; when that concedes, the device
                 search; and when the device search concedes too with no
                 ``-time-budget`` set, an unbounded CPU run.  ``-time-budget
                 0`` runs the CPU engine to completion and never starts the
                 device search.  The device rung never gives way to the CPU
                 for want of a card: without one it exits 64.

``-time-budget`` bounds the CPU engines (0 or unset: unbounded, except
under ``auto``); the device search ignores it.  ``-device-rows N`` caps the
device-resident frontier of the device search's exhaustive phase (default
2^23 on the card, 0 on the CPU: past its 2^20-row bucket the frontier grows
on the device up to N rows, expanded in chunks; past N it spills to host
RAM and streams through the device layer by layer).  ``-checkpoint PATH``
snapshots the device search (``PATH.beam`` for its beam phase, ``PATH`` and
``PATH.spill.npz`` for the exhaustive phase, in the JAX package's format)
and resumes a matching snapshot.  ``--prune`` turns on the verdict-exact
prunes (device, frontier and native engines) and ``--speculate-depth K``
the device search's speculative dive; ``-profile OUT.json`` writes the
search-shape profile (checker/profile.py).  ``-checkpoint`` and
``-device-rows`` warn where no device search runs.

``-file`` naming a directory or a glob checks every ``*.jsonl`` it holds in
one process, prints one ``<path>: OK|ILLEGAL|UNKNOWN|ERROR`` line per file
and exits with the worst verdict (ILLEGAL, then an unreadable file, then
UNKNOWN); ``-checkpoint`` and ``-profile`` are ignored there.  Each check
writes an HTML visualization to ``-out-dir`` (``./porcupine-outputs``) as
``<base>-<unique>.html`` (viz.py), naming the ops refused at the deepest
configuration (checker/diagnostics.py); ``-no-viz`` skips it.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import sys
import tempfile
import time

from . import __version__
from .checker.checkpoint import CheckpointError
from .checker.device import DeviceUnavailable, check_device_auto
from .checker.entries import History, prepare
from .checker.native import NativeUnavailable, check_native
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


def _cpu_check(hist: History, budget: float | None, profile: bool = False, prune: bool = False) -> CheckResult:
    """Native engine when buildable, Python oracle otherwise."""
    try:
        return check_native(hist, time_budget_s=budget, profile=profile, prune=prune)
    except NativeUnavailable as e:
        log.debug("native checker unavailable (%s); using the Python oracle", e)
        return check(hist, time_budget_s=budget)


def _cpu(hist: History, budget: float | None, profile: bool, prune: bool = False) -> CheckResult:
    # Extra keywords only when asked: test doubles for _cpu_check keep the
    # plain (hist, budget) signature.
    kw = {}
    if profile:
        kw["profile"] = True
    if prune:
        kw["prune"] = True
    return _cpu_check(hist, budget, **kw)


def _run_backend(
    backend: str,
    hist: History,
    time_budget_s: float | None,
    checkpoint: str | None = None,
    device_rows: int | None = None,
    collect_stats: bool = False,
    profile: bool = False,
    prune: bool = False,
    speculate_depth: int = 0,
    device: str = "cuda",
) -> CheckResult:
    # Budget 0 = run to completion, the reference's unbounded default
    # (CheckEventsVerbose timeout 0, main.go:606).
    unbounded = time_budget_s is not None and time_budget_s <= 0
    if unbounded:
        time_budget_s = None
    device_only = backend in ("device", "auto") and not (backend == "auto" and unbounded)
    where = f"{backend} (unbounded CPU)" if backend == "auto" else backend
    if checkpoint is not None and not device_only:
        log.warning("-checkpoint only applies to the device search; the %s backend will not snapshot", where)
    if device_rows is not None and not device_only:
        log.warning("-device-rows only applies to the device search; the %s backend ignores it", where)
    if backend == "oracle":
        return check(hist, time_budget_s=time_budget_s)
    if backend == "native":
        return check_native(hist, time_budget_s=time_budget_s, profile=profile, prune=prune)
    if backend == "frontier":
        from .checker.frontier import check_frontier_auto

        return check_frontier_auto(hist, collect_stats=collect_stats, profile=profile, prune=prune)
    dev_kw = {} if device_rows is None else {"device_rows_cap": device_rows}
    dev_kw.update(
        collect_stats=collect_stats,
        device=device,
        checkpoint_path=checkpoint,
        profile=profile,
        prune=prune,
        speculate_depth=int(speculate_depth),
    )
    if backend == "device":
        return check_device_auto(hist, **dev_kw)
    if backend == "auto":
        if unbounded:
            # Never concede a decidable instance: the CPU runs to the end.
            return _cpu(hist, None, profile, prune)
        budget = time_budget_s if time_budget_s is not None else 10.0
        res = _cpu(hist, budget, profile, prune)
        if res.outcome != CheckOutcome.UNKNOWN:
            return res
        log.info("CPU engine hit its %.1fs budget; escalating to the device search", budget)
        res = check_device_auto(hist, **dev_kw)
        if res.outcome != CheckOutcome.UNKNOWN or time_budget_s is not None:
            return res
        # The device search conceded with no bound set by the user: the
        # reference is unbounded (CheckEventsVerbose timeout 0,
        # main.go:606), so close with an unbounded CPU run.
        log.info("device search inconclusive; falling back to the unbounded CPU engine (no -time-budget was set)")
        return _cpu(hist, None, profile, prune)
    raise ValueError(f"unknown backend {backend!r}")


def _resolve_corpus(file_arg: str) -> list[str] | None:
    """Corpus mode: a directory or glob pattern as ``-file`` expands to the
    sorted list of histories to check in one process.  None for one file
    (or stdin)."""
    if file_arg == "-":
        return None
    if os.path.isdir(file_arg):
        pattern = os.path.join(file_arg, "*.jsonl")
    elif any(ch in file_arg for ch in "*?[") and not os.path.isfile(file_arg):
        # A file whose name merely holds glob characters stays one file.
        pattern = file_arg
    else:
        return None
    # Glob matches can include directories.
    return sorted(p for p in glob.glob(pattern) if os.path.isfile(p))


def _cmd_check(args: argparse.Namespace, on_result=None) -> int:
    corpus = _resolve_corpus(args.file)
    if corpus is None:
        return _check_one(args, args.file, on_result)
    if not corpus:
        log.error("no histories match %s", args.file)
        return USAGE_EXIT
    if args.checkpoint:
        # One snapshot path cannot serve many histories (the fingerprint
        # binds it to one).
        log.warning("-checkpoint is ignored in corpus mode")
        args.checkpoint = None
    if args.profile:
        log.warning("--profile is ignored in corpus mode")
        args.profile = None
    seen: set[int] = set()
    for path in corpus:
        # An unreadable file does not abort the corpus.
        rc = _check_one(args, path, on_result)
        seen.add(rc)
        print(f"{path}: " + {0: "OK", 1: "ILLEGAL", 2: "UNKNOWN", 64: "ERROR"}.get(rc, str(rc)), flush=True)
    # Worst verdict wins: ILLEGAL > unreadable file > UNKNOWN > OK.
    for code in (1, USAGE_EXIT, 2):
        if code in seen:
            return code
    return 0


def _umask() -> int:
    cur = os.umask(0)
    os.umask(cur)
    return cur


def _write_artifact(args: argparse.Namespace, file_path: str, events, checked: History, res: CheckResult) -> None:
    """Refusal reports where the engine gave none, then the HTML
    visualization, as the JAX package's CLI writes them (main.go:608-631)."""
    if res.outcome in (CheckOutcome.ILLEGAL, CheckOutcome.UNKNOWN) and not res.refusals:
        # Engines without refusal reports of their own (oracle, native,
        # frontier) get them re-derived from the deepest prefix, so the
        # artifact names the culprit ops whichever engine decided.
        from .checker.diagnostics import deepest_refusals

        report = deepest_refusals(checked, res.deepest or [])
        if report is not None:
            res.refusals = [report]
    from .viz import write_visualization

    full = prepare(events, elide_trivial=False)
    os.makedirs(args.out_dir, exist_ok=True)
    base = "stdin" if file_path == "-" else os.path.basename(file_path)
    fd, path = tempfile.mkstemp(prefix=f"{base}-", suffix=".html", dir=args.out_dir)
    os.close(fd)
    # mkstemp creates the file 0600; the artifact is a report, not a secret.
    os.chmod(path, 0o644 & ~_umask())
    write_visualization(path, full, res, title=f"s2 linearizability check — {base}", checked=checked)
    log.info("wrote visualization to %s", path)


def _check_one(args: argparse.Namespace, file_path: str, on_result=None) -> int:
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
        res = _run_backend(
            args.backend,
            checked,
            args.time_budget,
            checkpoint=args.checkpoint,
            device_rows=args.device_rows,
            collect_stats=args.stats,
            profile=bool(args.profile),
            prune=args.prune,
            speculate_depth=args.speculate_depth,
            device=args.device,
        )
    except NativeUnavailable as e:
        log.error("native backend unavailable: %s", e)
        return USAGE_EXIT
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
    if not args.no_viz:
        _write_artifact(args, file_path, events, checked, res)
    if on_result is not None:
        on_result(file_path, res, checked)

    if args.profile:
        # Search-shape profile: FrontierStats fields + the timeline (+ the
        # native engine's phases), the JAX CLI's schema.
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
        # statistics (the JAX CLI's -stats schema, plus host_syncs/device
        # where the device search decided).
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
            )
            if args.backend in ("device", "auto"):
                line.update(host_syncs=st.host_syncs, device=args.device)
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
    c.add_argument(
        "-file",
        "--file",
        required=True,
        help="history JSONL path, '-' for stdin; a directory or (quoted) "
        "glob checks the whole corpus in one process — exit code is the "
        "worst outcome (ILLEGAL > unreadable file > UNKNOWN > OK)",
    )
    c.add_argument(
        "-backend",
        "--backend",
        default="auto",
        choices=["oracle", "native", "frontier", "device", "auto"],
    )
    c.add_argument(
        "-device",
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the device search runs (default cuda; cpu runs the "
        "plain PyTorch fold instead of the CUDA kernel)",
    )
    c.add_argument(
        "-time-budget",
        "--time-budget",
        type=float,
        default=None,
        help="CPU-engine time budget in seconds; 0 = run to completion, the "
        "reference's unbounded default (auto backend default: 10)",
    )
    c.add_argument("-out-dir", "--out-dir", default="./porcupine-outputs")
    c.add_argument("-no-viz", "--no-viz", action="store_true", help="skip the HTML artifact")
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
    return _cmd_check(args, on_result=on_result)


if __name__ == "__main__":
    raise SystemExit(main())
