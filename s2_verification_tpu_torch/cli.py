"""Command line: ``python -m s2_verification_tpu_torch check -file=H.jsonl``,
``collect``, ``serve``, ``submit``, ``follow``, ``trace``, ``dash``,
``watch``, ``doctor``, ``tsq``, ``quarantine``, ``profiles`` and ``lint``.

``serve`` runs verifyd, the resident verification daemon (service/), on a
unix socket and optionally an authenticated TCP listener (``--tcp`` + a
shared secret), with the JAX package's flags and defaults and one more,
``--torch-device`` (the device of the inline and supervised escalations
and of ``--batching --batch-engine vmap`` launch groups; the card unless
it names another).  ``--state-dir`` makes it durable (journal, verdict
segments, quarantine ledger, flight ring, profile archive, telemetry and,
with ``--prefix``, the prefix store, in the JAX package's formats),
``--metrics-port`` serves ``/metrics`` and ``/dashboard``, ``--alert-url``
delivers alerts.  ``submit`` sends one history to a running daemon of
either package and exits with the ``check`` exit code of its verdict (75
queue full after retries, 69 no daemon ever answered, 76 a daemon refused
after retries, 64 a history it could not decode).  ``follow`` verifies a
growing stream window by window against a ``--prefix`` daemon, carrying
the frontier token forward; ``trace``, ``dash`` and ``watch`` read a live
daemon's span ring, stats and progress board.  None of them loads
``torch`` unless the daemon escalates inline or launches a vmap group.

``lint`` runs verifylint (analysis/) over the port's own tree against its
own records (``.verifylint-torch-baseline.json``, the per-file cache
``.verifylint-torch-cache.json`` and ``docs/EVENTS_torch.md``), with the
JAX package's flags and exit codes (0 clean, 1 a new error or a stale
events document, 64 ``--write-baseline`` on a partial scan).  It loads
neither ``torch`` nor ``jax``.

``doctor``, ``tsq``, ``quarantine`` and ``profiles`` read a state
directory either package's daemon wrote: live through ``--socket`` (the
``tsq``, ``quarantine`` and ``profiles`` ops), or cold from the directory
of a dead daemon (``--state-dir``, ``--telemetry-dir``), with the JAX
package's flags and exit codes.  ``doctor`` is cold only and exits 0 on a
clean shutdown, 1 on an unclean death.

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


def check_device_auto(hist: History, **kw) -> CheckResult:
    """The device search (``checker/device.py``), imported at its first
    call: ``serve`` under ``--device supervised|off`` and ``submit`` must
    not load ``torch``."""
    from .checker.device import check_device_auto as search

    return search(hist, **kw)


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
    from .checker.device import DeviceUnavailable

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


def _read_secret(args: argparse.Namespace) -> bytes | None:
    """Shared secret for the TCP transport: ``--secret-file`` wins, then
    the ``VERIFYD_SECRET`` environment variable (never a CLI argument —
    process listings leak those)."""
    if getattr(args, "secret_file", None):
        with open(args.secret_file, "rb") as f:
            secret = f.read().strip()
        if not secret:
            raise SystemExit(f"secret file {args.secret_file} is empty")
        return secret
    env = os.environ.get("VERIFYD_SECRET", "")
    return env.encode("utf-8") if env else None


def _resolve_mesh_devices(spec: str | None, torch_device: str | None) -> int | None:
    """Resolve ``serve --mesh-devices N|auto`` to a device-pool size.

    ``auto`` counts the visible cards in a bounded probe child — the
    daemon process itself never initializes CUDA (a lost card can hang
    it; see service/supervise.py).  With ``--torch-device cpu`` there is
    one host device.
    """
    if spec is None:
        return None
    s = str(spec).strip().lower()
    if s in ("", "0", "none", "off"):
        return None
    if s != "auto":
        n = int(s)
        if n < 1:
            raise SystemExit(f"--mesh-devices must be >= 1, got {n}")
        return n
    if torch_device == "cpu":
        return 1
    import subprocess

    code = "import torch\nprint(torch.cuda.device_count())\n"
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            text=True,
            timeout=120,
        )
        if proc.returncode == 0:
            return max(1, int(proc.stdout.strip().splitlines()[-1]))
    except (subprocess.TimeoutExpired, OSError, ValueError, IndexError):
        pass
    log.warning("--mesh-devices auto: device probe failed; serving without a pool")
    return None


def _cmd_serve(args: argparse.Namespace) -> int:
    from .service.daemon import Verifyd, VerifydConfig, holds_card

    if os.path.exists(args.socket):
        # A stale socket file from a crashed daemon only a clean exit
        # removes; refusing with a clear message beats a bind error.
        log.error(
            "%s already exists — another verifyd running? (remove the file "
            "if it is stale)",
            args.socket,
        )
        return USAGE_EXIT
    secret = _read_secret(args)
    if args.tcp and not secret:
        log.error("--tcp requires a shared secret (--secret-file or VERIFYD_SECRET)")
        return USAGE_EXIT
    cfg = VerifydConfig(
        socket_path=args.socket,
        queue_depth=args.queue_depth,
        workers=args.workers,
        batch_max=args.batch_max,
        time_budget_s=args.time_budget,
        device=args.device,
        out_dir=args.out_dir,
        no_viz=args.no_viz,
        stats_log=args.stats_log or None,
        device_rows=args.device_rows,
        tcp=args.tcp or None,
        secret=secret,
        state_dir=args.state_dir or None,
        fsync=args.fsync,
        metrics_port=args.metrics_port,
        trace_capacity=args.trace_capacity,
        profile=args.profile,
        mesh_devices=_resolve_mesh_devices(args.mesh_devices, args.torch_device),
        log_format=args.log_format,
        slo_target=args.slo_target,
        slo_latency_target_s=args.slo_latency_target,
        alert_url=args.alert_url or None,
        alert_rules=tuple(args.alert_rule or ()),
        alert_dedup_s=args.alert_dedup,
        drain_timeout_s=args.drain_timeout,
        sentinel_band=args.sentinel_band,
        sentinel_min_samples=args.sentinel_min_samples,
        resource_sample_s=args.resource_sample,
        retrace_storm_threshold=args.retrace_storm,
        dashboard_sample_s=args.dashboard_sample,
        telemetry_dir=args.telemetry_dir,
        telemetry_sample_s=args.telemetry_sample,
        max_rss_frac=args.max_rss_frac,
        deadline_grace_s=args.deadline_grace,
        quarantine_threshold=args.quarantine_threshold,
        fast_admission=args.fast_admission,
        batching=args.batching,
        batch_engine=args.batch_engine,
        prefix_enabled=args.prefix,
        prefix_capacity=args.prefix_capacity,
        prefix_min_ops=args.prefix_min_ops,
        prefix_cuts=args.prefix_cuts,
        prefix_max_segments=args.prefix_max_segments,
        prune=args.prune,
        speculate_depth=args.speculate_depth,
        torch_device=args.torch_device,
    )
    refused: tuple = ()
    if holds_card(cfg):
        # An inline or vmap-batching daemon loads torch anyway: it holds
        # the card, and exits 64 without one.
        from .checker.device import DeviceUnavailable

        refused = (DeviceUnavailable,)
    try:
        daemon = Verifyd(cfg)
    except refused as e:
        log.error("%s", e)
        return USAGE_EXIT

    # Route stdlib-logging diagnostics (this module, scheduler, supervise)
    # through the daemon's structured logger so every line — events and
    # diagnostics alike — shares one format and one stream.
    from .obs.log import StructuredHandler

    pkg_log = logging.getLogger("s2_verification_tpu_torch")
    handler = StructuredHandler(daemon.logger)
    pkg_log.addHandler(handler)
    pkg_log.propagate = False

    import signal as _signal

    def _stop(signum, frame):
        # The flight-recorder marker before teardown (a no-op until the
        # port has a flight recorder, as in a JAX daemon without one).
        daemon.dump_flight("sigterm" if signum == _signal.SIGTERM else "sigint")
        if signum == _signal.SIGTERM and cfg.drain_timeout_s > 0:
            # Rolling-restart contract: finish what was admitted, then exit.
            log.info(
                "signal %d: draining verifyd (up to %.0fs)",
                signum,
                cfg.drain_timeout_s,
            )
            daemon.request_drain()
            return
        log.info("signal %d: stopping verifyd", signum)
        daemon.request_stop()

    for sig in (_signal.SIGINT, _signal.SIGTERM):
        _signal.signal(sig, _stop)
    try:
        return daemon.serve_forever()
    finally:
        pkg_log.removeHandler(handler)
        pkg_log.propagate = True


def _cmd_route_serve(args: argparse.Namespace) -> int:
    from .service.router import BackendSpec, RouterConfig, VerifydRouter

    secret = _read_secret(args)
    is_tcp = ":" in args.listen and not args.listen.startswith(("/", "."))
    if is_tcp and not secret:
        log.error(
            "a TCP --listen requires a shared secret (--secret-file or "
            "VERIFYD_SECRET)"
        )
        return USAGE_EXIT
    if not is_tcp and os.path.exists(args.listen):
        log.error(
            "%s already exists — another router running? (remove the file "
            "if it is stale)",
            args.listen,
        )
        return USAGE_EXIT
    try:
        backends = tuple(BackendSpec.parse(spec) for spec in args.backend)
    except ValueError as e:
        log.error("bad --backend: %s", e)
        return USAGE_EXIT
    try:
        cfg = RouterConfig(
            listen=args.listen,
            backends=backends,
            secret=secret,
            probe_interval_s=args.probe_interval,
            breaker_failures=args.breaker_failures,
            breaker_reset_s=args.breaker_reset,
            steal_depth=args.steal_depth,
            max_failovers=args.max_failovers,
            submit_timeout_s=args.submit_timeout,
            ring_replicas=args.ring_replicas,
            drain_timeout_s=args.drain_timeout,
            cache_capacity=args.cache_capacity,
            metrics_port=args.metrics_port,
            trace_capacity=args.trace_capacity,
            slo_target=args.slo_target,
            slo_latency_target_s=args.slo_latency_target,
            state_dir=args.state_dir,
            distsearch_segments=args.distsearch_segments,
            distsearch_straggler_s=args.distsearch_straggler,
            distsearch_max_regrants=args.distsearch_max_regrants,
            scrape_interval_s=args.scrape_interval,
            telemetry_dir=args.telemetry_dir,
            telemetry_sample_s=args.telemetry_sample,
        )
        router = VerifydRouter(cfg)
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT

    import signal as _signal

    def _stop(signum, frame):
        log.info("signal %d: stopping verifyd-router", signum)
        router.request_stop()

    for sig in (_signal.SIGINT, _signal.SIGTERM):
        _signal.signal(sig, _stop)
    return router.serve_forever()


def _route_client(args: argparse.Namespace):
    from .service.client import VerifydClient

    return VerifydClient(args.socket, secret=_read_secret(args))


def _cmd_route_drain(args: argparse.Namespace) -> int:
    from .service.client import VerifydError, VerifydUnavailable
    from .service.protocol import EXIT_PROTOCOL, EXIT_UNAVAILABLE

    try:
        reply = _route_client(args).drain(
            args.node, drain_timeout_s=args.timeout, timeout=None
        )
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT
    except VerifydUnavailable as e:
        log.error("cannot reach the router on %s: %s", args.socket, e.msg)
        return EXIT_UNAVAILABLE
    except VerifydError as e:
        log.error("drain failed: %s", e)
        return EXIT_PROTOCOL
    log.info(
        "node %s drained (in-flight clear: %s, waited %.2fs); backend "
        "shutdown: %s",
        reply.get("node"),
        reply.get("drained"),
        reply.get("waited_s", 0.0),
        reply.get("shutdown"),
    )
    return 0 if reply.get("drained") else 1


def _cmd_route_undrain(args: argparse.Namespace) -> int:
    from .service.client import VerifydError, VerifydUnavailable
    from .service.protocol import EXIT_PROTOCOL, EXIT_UNAVAILABLE

    try:
        reply = _route_client(args).undrain(args.node)
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT
    except VerifydUnavailable as e:
        log.error("cannot reach the router on %s: %s", args.socket, e.msg)
        return EXIT_UNAVAILABLE
    except VerifydError as e:
        log.error("undrain failed: %s", e)
        return EXIT_PROTOCOL
    log.info("node %s back in the routable set", reply.get("node"))
    return 0


def _cmd_route_fleet(args: argparse.Namespace) -> int:
    import json as _json

    from .service.client import VerifydError, VerifydUnavailable
    from .service.protocol import EXIT_PROTOCOL, EXIT_UNAVAILABLE

    try:
        reply = _route_client(args).fleet()
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT
    except VerifydUnavailable as e:
        log.error("cannot reach the router on %s: %s", args.socket, e.msg)
        return EXIT_UNAVAILABLE
    except VerifydError as e:
        log.error("fleet query failed: %s", e)
        return EXIT_PROTOCOL
    if args.json:
        print(_json.dumps(reply, indent=2, sort_keys=True))
        return 0
    ring = reply.get("ring", {})
    print(
        f"ring: {len(ring.get('nodes', []))} nodes × "
        f"{ring.get('replicas')} replicas"
    )
    for b in reply.get("backends", []):
        up = {True: "up", False: "DOWN", None: "unprobed"}[b.get("up")]
        flags = []
        if b.get("draining"):
            flags.append("draining")
        if b.get("breaker") != "closed":
            flags.append(f"breaker={b.get('breaker')}")
        if b.get("last_error"):
            flags.append(f"last_error={b['last_error']}")
        build = b.get("build") or {}
        build_str = ""
        if build:
            # The scraper captured verifyd_build_info labels off this node.
            build_str = (
                f"  build=v{build.get('version', '?')}"
                f"/{build.get('backend', '?')}"
                f"/py{build.get('python', '?')}"
            )
        print(
            f"  {b.get('name')}: {up}  addr={b.get('address')}  "
            f"in_flight={b.get('in_flight')}"
            + build_str
            + (f"  [{', '.join(flags)}]" if flags else "")
        )
    return 0


def _cmd_submit(args: argparse.Namespace) -> int:
    from .service.client import (
        VerifydBusy,
        VerifydClient,
        VerifydError,
        VerifydRefused,
        VerifydUnavailable,
    )
    from .service.protocol import EXIT_BUSY, EXIT_PROTOCOL, EXIT_UNAVAILABLE

    if args.file == "-":
        text = sys.stdin.read()
    else:
        try:
            with open(args.file, encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            log.error("failed to read history: %s", e)
            return USAGE_EXIT
    try:
        client = VerifydClient(args.socket, secret=_read_secret(args))
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT
    try:
        reply = client.submit_with_retry(
            text,
            client=args.client,
            priority=args.priority,
            no_viz=args.no_viz or None,
            timeout=args.timeout,
            retries=args.retries,
            backoff_s=args.backoff,
            deadline_s=args.deadline,
            distributed=args.distributed,
        )
    except VerifydBusy as e:
        log.error(
            "verifyd is at capacity (%s); retry after ~%.1fs",
            e.msg,
            e.retry_after_s,
        )
        return EXIT_BUSY
    except VerifydUnavailable as e:
        log.error("cannot reach verifyd on %s: %s", args.socket, e.msg)
        return EXIT_UNAVAILABLE
    except VerifydRefused as e:
        log.error("verifyd on %s refused: %s", args.socket, e)
        return EXIT_PROTOCOL
    except VerifydError as e:
        if e.cls == "DecodeError":
            log.error("daemon rejected the history: %s", e.msg)
            return USAGE_EXIT
        # The daemon answered — an internal failure is a refusal, not
        # unavailability (exit 76, not 69).
        log.error("submit failed: %s", e)
        return EXIT_PROTOCOL
    except (OSError, TimeoutError) as e:
        log.error("cannot reach verifyd on %s: %s", args.socket, e)
        return EXIT_UNAVAILABLE

    if args.stats:
        import json as _json

        line = {
            "file": args.file,
            "outcome": reply.get("outcome"),
            "backend": reply.get("backend"),
            "wall_s": reply.get("wall_s"),
            "queue_wait_s": reply.get("queue_wait_s"),
            "ops": reply.get("ops"),
            "cached": reply.get("cached", False),
            "shape": reply.get("shape"),
            "trace_id": reply.get("trace_id"),
        }
        print(_json.dumps(line), flush=True)
    art = reply.get("artifact")
    if art:
        log.info("visualization: %s", art)
    if reply.get("trace_id"):
        log.info("trace_id: %s", reply["trace_id"])
    verdict = reply.get("verdict")
    outcome = reply.get("outcome")
    if verdict == 0:
        log.info(
            "history is linearizable (%s, %ss%s)",
            reply.get("backend"),
            reply.get("wall_s"),
            ", cached" if reply.get("cached") else "",
        )
    elif verdict == 1:
        log.error("history is NOT linearizable (%s)", reply.get("backend"))
    else:
        log.error("check inconclusive (outcome %s)", outcome)
    return verdict if verdict in (0, 1, 2) else USAGE_EXIT


def _cmd_doctor(args: argparse.Namespace) -> int:
    """Read-only post-mortem of a (dead) daemon's --state-dir."""
    from .obs.flight import postmortem, render_postmortem

    if not os.path.isdir(args.state_dir):
        log.error("state dir %s does not exist", args.state_dir)
        return USAGE_EXIT
    pm = postmortem(args.state_dir, tail=max(1, args.tail))
    if args.json:
        import json as _json

        print(_json.dumps(pm, default=str), flush=True)
    else:
        print(render_postmortem(pm, tail=max(1, args.tail)), end="", flush=True)
    # Exit codes mirror the verdict: 0 clean shutdown, 1 unclean death —
    # scriptable ("did the last run die?") without parsing the report.
    return 0 if pm["clean_shutdown"] else 1


def _cmd_tsq(args: argparse.Namespace) -> int:
    """Query telemetry history: live off a daemon/router (--socket, the
    ``tsq`` op) or cold off a telemetry directory — same store, same
    answer, the daemon doesn't even have to be alive."""
    import json as _json

    labels: dict[str, str] = {}
    for spec in args.label or []:
        key, sep, val = spec.partition("=")
        if not sep or not key:
            log.error("bad --label %r: expected KEY=VALUE", spec)
            return USAGE_EXIT
        labels[key] = val

    if args.socket:
        from .service.client import (
            VerifydClient,
            VerifydError,
            VerifydUnavailable,
        )
        from .service.protocol import EXIT_PROTOCOL, EXIT_UNAVAILABLE

        try:
            client = VerifydClient(args.socket, secret=_read_secret(args))
            reply = client.tsq(
                res=args.res,
                metric=args.metric or None,
                labels=labels or None,
                since=args.since,
                until=args.until,
                limit=args.limit,
                info=args.info,
            )
        except ValueError as e:
            log.error("%s", e)
            return USAGE_EXIT
        except VerifydUnavailable as e:
            log.error("cannot reach verifyd on %s: %s", args.socket, e.msg)
            return EXIT_UNAVAILABLE
        except VerifydError as e:
            log.error("tsq refused: %s", e)
            return EXIT_PROTOCOL
    else:
        from .obs.tsdb import default_dir, query, telemetry_info

        tdir = args.telemetry_dir or (
            default_dir(args.state_dir) if args.state_dir else None
        )
        if not tdir:
            log.error(
                "tsq needs --socket (live) or --telemetry-dir / "
                "--state-dir (cold)"
            )
            return USAGE_EXIT
        if not os.path.isdir(tdir):
            log.error("telemetry dir %s does not exist", tdir)
            return USAGE_EXIT
        if args.info:
            reply = telemetry_info(tdir)
        else:
            reply = query(
                tdir,
                res=args.res,
                metric=args.metric or None,
                labels=labels or None,
                since=args.since,
                until=args.until,
                limit=args.limit,
            )

    if args.json:
        print(_json.dumps(reply, sort_keys=True), flush=True)
        return 0

    if args.info:
        print(f"telemetry store: {reply.get('dir', args.socket)}")
        for res, info in sorted((reply.get("resolutions") or {}).items()):
            rec = info.get("recovery") or {}
            print(
                f"  {res:<3s} {info.get('records', 0):>6} record(s) "
                f"{info.get('series', 0):>4} series "
                f"{info.get('bytes', 0):>9}B  "
                f"torn tail {rec.get('torn_tail_bytes', 0)}B, "
                f"{rec.get('bad_segments', 0)} bad segment(s)"
            )
        return 0

    series = reply.get("series") or {}
    if args.rate:
        # Cumulative counters → per-second rates.  Counters reset to 0
        # at every daemon boot, so a negative delta marks a restart, not
        # a decrease — clamp it to 0 instead of plotting nonsense.
        for key, pts in series.items():
            rated = []
            for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
                dt = t1 - t0
                if dt > 0:
                    rated.append([t1, max(0.0, (v1 - v0) / dt)])
            series[key] = rated

    if args.csv:
        import csv as _csv

        w = _csv.writer(sys.stdout)
        w.writerow(["series", "t", "value"])
        for key in sorted(series):
            for t, v in series[key]:
                w.writerow([key, t, v])
        return 0

    rng = reply.get("range") or [None, None]
    span = (
        f"{_fmt_wall(rng[0])} .. {_fmt_wall(rng[1])}"
        if rng[0] is not None
        else "(empty)"
    )
    print(
        f"res={reply.get('res')}  {len(series)} series, "
        f"{reply.get('points', 0)} point(s)  {span}"
        + ("  [rate/s]" if args.rate else "")
    )
    for key in sorted(series):
        vals = [p[1] for p in series[key]]
        if not vals:
            continue
        print(
            f"  {_spark(vals, args.width)}  "
            f"n={len(vals):<4d} min={min(vals):<10.6g} "
            f"max={max(vals):<10.6g} last={vals[-1]:<10.6g} {key}"
        )
    if not series:
        print("  no matching series")
    return 0


def _fmt_wall(t) -> str:
    try:
        return time.strftime("%H:%M:%S", time.localtime(float(t)))
    except (TypeError, ValueError, OverflowError):
        return "?"


def _print_quarantine_entries(entries: list, threshold) -> None:
    if not entries:
        print("quarantine empty", flush=True)
        return
    print(f"{'FINGERPRINT':36.36s} {'CRASHES':>7s} {'SINCE':20s} KINDS")
    import time as _time

    for ent in entries:
        since = ent.get("since")
        when = (
            _time.strftime("%Y-%m-%dT%H:%M:%S", _time.gmtime(float(since)))
            if since
            else "?"
        )
        kinds = ",".join(
            f"{k}={v}" for k, v in sorted((ent.get("kinds") or {}).items())
        )
        print(
            f"{str(ent.get('fingerprint', '?')):36.36s} "
            f"{ent.get('crashes', '?'):>7} {when:20s} {kinds}"
        )
    print(
        f"-- {len(entries)} quarantined (threshold {threshold}); "
        "release with: quarantine release FINGERPRINT",
        flush=True,
    )


def _cmd_quarantine(args: argparse.Namespace) -> int:
    """Poison-job quarantine: list / inspect / release, against a live
    daemon (socket) or a dead one's --state-dir (cold file read; release
    cold requires the daemon to be stopped)."""
    import json as _json

    action = args.quarantine_cmd
    fp = getattr(args, "fingerprint", None)
    if not args.state_dir and not args.socket:
        log.error("quarantine %s needs --socket or --state-dir", action)
        return USAGE_EXIT
    if args.state_dir:
        from .service.overload import QuarantineStore

        store = QuarantineStore(os.path.join(args.state_dir, "quarantine"))
        if action == "list":
            _print_quarantine_entries(store.list(), store.threshold)
            return 0
        if action == "inspect":
            info = store.get(fp)
            if info is None:
                log.error("%s is not quarantined", fp)
                return 1
            print(_json.dumps(info, sort_keys=True), flush=True)
            return 0
        released = store.release(fp)
        print(_json.dumps({"released": released, "fingerprint": fp}), flush=True)
        return 0 if released else 1

    from .service.client import (
        VerifydClient,
        VerifydError,
        VerifydUnavailable,
    )
    from .service.protocol import EXIT_PROTOCOL, EXIT_UNAVAILABLE

    try:
        client = VerifydClient(args.socket, secret=_read_secret(args))
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT
    try:
        reply = client.quarantine(action, fp)
    except VerifydUnavailable as e:
        log.error("cannot reach verifyd on %s: %s", args.socket, e.msg)
        return EXIT_UNAVAILABLE
    except VerifydError as e:
        log.error("quarantine %s refused: %s", action, e)
        return EXIT_PROTOCOL
    except (OSError, TimeoutError) as e:
        log.error("cannot reach verifyd on %s: %s", args.socket, e)
        return EXIT_UNAVAILABLE
    if action == "list":
        _print_quarantine_entries(
            reply.get("entries", []), reply.get("threshold", "?")
        )
        return 0
    print(_json.dumps(reply, sort_keys=True), flush=True)
    if action == "release" and not reply.get("released"):
        return 1
    return 0


#: export column order — stable so downstream scripts can rely on it.
_PROFILE_COLUMNS = (
    "t",
    "job",
    "client",
    "shape",
    "backend",
    "verdict",
    "wall_s",
    "queue_wait_s",
    "lease_wait_s",
    "ops",
    "shards",
    "fp",
)


def _profile_filters(args: argparse.Namespace) -> dict:
    return {
        k: v
        for k, v in {
            "shape": args.shape,
            "backend": args.backend,
            "client": args.client,
            "verdict": args.verdict,
            "since": args.since,
            "slowest": args.slowest,
            "limit": args.limit,
        }.items()
        if v is not None
    }


def _csv_cell(value) -> str:
    """One RFC-4180-safe cell: containers (the ``shards`` summary, op
    breakdowns) become JSON — their Python reprs hold commas and quotes
    that round-trip badly — and everything else is stringified for the
    writer to quote as needed."""
    import json as _json

    if isinstance(value, (dict, list, tuple)):
        return _json.dumps(value, sort_keys=True, default=str)
    if value is None:
        return ""
    return str(value)


def _export_profiles(records: list[dict], path, fmt: str) -> None:
    import json as _json

    if fmt == "jsonl":
        for rec in records:
            path.write(_json.dumps(rec, sort_keys=True))
            path.write("\n")
        return
    import csv as _csv

    # Explicit dialect: QUOTE_MINIMAL wraps any cell holding a comma,
    # quote, or newline (doubling embedded quotes per RFC 4180), and the
    # fixed "\n" terminator keeps stdout export ("-", opened without
    # newline="") from emitting \r\r\n on platforms that translate.
    w = _csv.writer(path, quoting=_csv.QUOTE_MINIMAL, lineterminator="\n")
    w.writerow(_PROFILE_COLUMNS)
    for rec in records:
        w.writerow([_csv_cell(rec.get(col, "")) for col in _PROFILE_COLUMNS])


def _cmd_profiles(args: argparse.Namespace) -> int:
    """Query the durable job-profile archive, live or cold."""
    filters = _profile_filters(args)
    if args.socket:
        from .service.client import (
            VerifydClient,
            VerifydError,
            VerifydUnavailable,
        )
        from .service.protocol import EXIT_PROTOCOL, EXIT_UNAVAILABLE

        try:
            client = VerifydClient(args.socket, secret=_read_secret(args))
        except ValueError as e:
            log.error("%s", e)
            return USAGE_EXIT
        try:
            reply = client.profiles(**filters)
        except VerifydUnavailable as e:
            log.error("cannot reach verifyd on %s: %s", args.socket, e.msg)
            return EXIT_UNAVAILABLE
        except VerifydError as e:
            log.error("profile query refused: %s", e)
            return EXIT_PROTOCOL
        except (OSError, TimeoutError) as e:
            log.error("cannot reach verifyd on %s: %s", args.socket, e)
            return EXIT_UNAVAILABLE
        records = reply.get("records", [])
        total = reply.get("total", len(records))
    elif args.state_dir:
        from .obs.archive import filter_records, read_archive

        if not os.path.isdir(args.state_dir):
            log.error("state dir %s does not exist", args.state_dir)
            return USAGE_EXIT
        archived = read_archive(args.state_dir)
        records = filter_records(archived, **filters)
        total = len(archived)
    else:
        log.error("profiles needs --socket (live) or --state-dir (cold)")
        return USAGE_EXIT

    if args.export:
        fmt = args.format
        if args.export == "-":
            _export_profiles(records, sys.stdout, fmt)
        else:
            newline = "" if fmt == "csv" else None
            with open(
                args.export, "w", encoding="utf-8", newline=newline
            ) as f:
                _export_profiles(records, f, fmt)
            log.info(
                "exported %d of %d archived profiles to %s (%s)",
                len(records),
                total,
                args.export,
                fmt,
            )
        return 0

    if not records:
        print(f"no matching records ({total} archived)", flush=True)
        return 0
    hdr = (
        f"{'when':19s} {'job':>6s} {'client':12s} {'shape':28s} "
        f"{'backend':18s} {'vd':>2s} {'wall_ms':>9s} {'queue_ms':>9s} "
        f"{'lease_ms':>9s}"
    )
    print(hdr)
    for rec in records:
        when = time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(float(rec.get("t", 0.0)))
        )
        wall = float(rec.get("wall_s") or 0.0) * 1e3
        qw = float(rec.get("queue_wait_s") or 0.0) * 1e3
        lw = float(rec.get("lease_wait_s") or 0.0) * 1e3
        print(
            f"{when:19s} {str(rec.get('job', '?')):>6s} "
            f"{str(rec.get('client', '?')):12.12s} "
            f"{str(rec.get('shape', '?')):28.28s} "
            f"{str(rec.get('backend', '?')):18.18s} "
            f"{str(rec.get('verdict', '?')):>2s} {wall:9.1f} {qw:9.1f} "
            f"{lw:9.1f}"
        )
    print(f"-- {len(records)} of {total} archived records", flush=True)
    return 0


def _cmd_trace(args: argparse.Namespace) -> int:
    from .service.client import (
        VerifydClient,
        VerifydError,
        VerifydUnavailable,
    )
    from .service.protocol import EXIT_PROTOCOL, EXIT_UNAVAILABLE

    try:
        client = VerifydClient(args.socket, secret=_read_secret(args))
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT
    try:
        trace = client.trace()
    except VerifydUnavailable as e:
        log.error("cannot reach verifyd on %s: %s", args.socket, e.msg)
        return EXIT_UNAVAILABLE
    except VerifydError as e:
        log.error("trace fetch refused: %s", e)
        return EXIT_PROTOCOL
    except (OSError, TimeoutError) as e:
        log.error("cannot reach verifyd on %s: %s", args.socket, e)
        return EXIT_UNAVAILABLE

    import json as _json

    warning = (trace.get("otherData") or {}).get("warning")
    if warning:
        log.warning("%s", warning)
    text = _json.dumps(trace)
    if args.out == "-":
        print(text, flush=True)
    else:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
            f.write("\n")
        log.info(
            "wrote %d trace events to %s (load in ui.perfetto.dev or "
            "chrome://tracing)",
            len(trace.get("traceEvents", [])),
            args.out,
        )
    return 0


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _spark(values: list[float], width: int = 32) -> str:
    """Unicode sparkline over the last ``width`` values (terminal `top`
    aesthetics; empty history renders as spaces, flat history as ▁s)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return " " * width
    lo, hi = min(vals), max(vals)
    span = hi - lo
    out = []
    for v in vals:
        idx = 0 if span <= 0 else int((v - lo) / span * (len(_SPARK_BLOCKS) - 1))
        out.append(_SPARK_BLOCKS[idx])
    return "".join(out).rjust(width)


def _cmd_dash(args: argparse.Namespace) -> int:
    """`verifyd top`: poll the stats op and render terminal sparklines."""
    from .service.client import (
        VerifydClient,
        VerifydError,
        VerifydUnavailable,
    )
    from .service.protocol import EXIT_PROTOCOL, EXIT_UNAVAILABLE

    try:
        client = VerifydClient(args.socket, secret=_read_secret(args))
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT

    hist: dict[str, list[float]] = {
        "throughput": [],
        "queue": [],
        "active": [],
        "rss_mb": [],
        "compiles": [],
    }
    prev_completed: float | None = None
    prev_compiles: float | None = None
    prev_t: float | None = None
    n = 0
    try:
        while True:
            try:
                snap = client.stats()
            except VerifydUnavailable as e:
                log.error("cannot reach verifyd on %s: %s", args.socket, e.msg)
                return EXIT_UNAVAILABLE
            except VerifydError as e:
                log.error("stats refused: %s", e)
                return EXIT_PROTOCOL
            except (OSError, TimeoutError) as e:
                log.error("cannot reach verifyd on %s: %s", args.socket, e)
                return EXIT_UNAVAILABLE
            now = time.time()
            completed = float(snap.get("completed", 0))
            intro = snap.get("introspection") or {}
            jit = intro.get("jit") or {}
            compiles = float(sum((jit.get("compiles") or {}).values()))
            if prev_t is not None and now > prev_t:
                hist["throughput"].append(
                    max(0.0, completed - (prev_completed or 0.0)) / (now - prev_t)
                )
                hist["compiles"].append(max(0.0, compiles - (prev_compiles or 0.0)))
            prev_completed, prev_compiles, prev_t = completed, compiles, now
            hist["queue"].append(float(snap.get("queue_depth_now", 0)))
            hist["active"].append(float(snap.get("active", 0)))
            res = (intro.get("resources") or {}).get("last") or {}
            hist["rss_mb"].append(float(res.get("rss_bytes", 0) or 0) / (1 << 20))
            for k in hist:
                hist[k] = hist[k][-args.width :]

            lines = [
                "verifyd dash  socket=%s  uptime=%.0fs  completed=%d  "
                "cache_hits=%d  errors=%d"
                % (
                    args.socket,
                    float(snap.get("uptime_s", 0.0)),
                    int(snap.get("completed", 0)),
                    int(snap.get("cache_hits", 0)),
                    int(snap.get("errors", 0)),
                )
            ]
            rows = (
                ("throughput", "jobs/s", hist["throughput"]),
                ("queue", "depth", hist["queue"]),
                ("active", "jobs", hist["active"]),
                ("rss", "MiB", hist["rss_mb"]),
                ("compiles", "per tick", hist["compiles"]),
            )
            for name, unit, series in rows:
                cur = series[-1] if series else 0.0
                lines.append(
                    "  %-10s %s  %10.2f %s"
                    % (name, _spark(series, args.width), cur, unit)
                )
            storms = int(snap.get("retrace_storms", 0))
            if storms:
                lines.append("  !! retrace storms latched: %d" % storms)
            active_searches = [
                r
                for r in (snap.get("progress") or [])
                if isinstance(r, dict) and not r.get("done")
            ]
            for r in active_searches[:8]:
                eta = r.get("eta_s")
                lines.append(
                    "  >> job=%-5s %-11s %5.1f%%  %s/%s ops  eta=%s"
                    % (
                        r.get("job"),
                        r.get("engine") or "?",
                        100.0 * float(r.get("progress_ratio") or 0.0),
                        r.get("ops_committed"),
                        r.get("total_ops"),
                        "%.0fs" % float(eta) if eta is not None else "?",
                    )
                )
            print("\n".join(lines), flush=True)
            n += 1
            if args.iterations and n >= args.iterations:
                return 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


def _cmd_watch(args: argparse.Namespace) -> int:
    """`verifyd watch`: live progress board for running searches.

    Polls the ``watch`` op (daemon or router — the router fans out and
    aggregates distributed partitions) and renders one frame per poll:
    per-job progress ratio with a climbing sparkline, committed/total
    ops, frontier width, ops rate and the EWMA-smoothed ETA.  A named
    selector that was visible and then answers the definite
    ``UnknownJob`` means the job finished — that's a clean exit, not an
    error.
    """
    from .service.client import (
        VerifydClient,
        VerifydError,
        VerifydUnavailable,
    )
    from .service.protocol import (
        ERR_UNKNOWN_JOB,
        EXIT_PROTOCOL,
        EXIT_UNAVAILABLE,
    )

    try:
        client = VerifydClient(args.socket, secret=_read_secret(args))
    except ValueError as e:
        log.error("%s", e)
        return USAGE_EXIT
    import json as _json

    ratios: dict[tuple, list[float]] = {}
    seen = False
    n = 0
    try:
        while True:
            try:
                got = client.watch(
                    job=args.job,
                    fingerprint=args.fingerprint,
                    search=args.search,
                    part=args.part,
                )
            except VerifydUnavailable as e:
                log.error("cannot reach verifyd on %s: %s", args.socket, e.msg)
                return EXIT_UNAVAILABLE
            except VerifydError as e:
                if e.cls == ERR_UNKNOWN_JOB:
                    if seen:
                        # It was on the board and now is not: it finished.
                        log.info("watched job left the progress surface (done)")
                        return 0
                    log.error("nothing to watch: %s", e.msg)
                    return EXIT_PROTOCOL
                log.error("watch refused: %s", e)
                return EXIT_PROTOCOL
            except (OSError, TimeoutError) as e:
                log.error("cannot reach verifyd on %s: %s", args.socket, e)
                return EXIT_UNAVAILABLE

            rows = [r for r in got.get("progress") or [] if isinstance(r, dict)]
            seen = seen or bool(rows)
            if args.json:
                print(_json.dumps(got, sort_keys=True), flush=True)
            else:
                lines = [
                    "verifyd watch  socket=%s  %d job(s)"
                    % (args.socket, len(rows))
                ]
                for r in rows:
                    key = (r.get("node"), r.get("job"))
                    ratio = float(r.get("progress_ratio") or 0.0)
                    ratios.setdefault(key, []).append(ratio)
                    ratios[key] = ratios[key][-args.width :]
                    eta = r.get("eta_s")
                    lines.append(
                        "  job=%-5s %-11s %s %5.1f%%  %s/%s ops  "
                        "width=%-6s rate=%8.1f/s  eta=%s%s"
                        % (
                            r.get("job"),
                            r.get("engine") or "?",
                            _spark(ratios[key], args.width),
                            100.0 * ratio,
                            r.get("ops_committed"),
                            r.get("total_ops"),
                            r.get("frontier_width"),
                            float(r.get("ops_rate") or 0.0),
                            "%.0fs" % float(eta) if eta is not None else "?",
                            "  node=%s" % r["node"] if r.get("node") else "",
                        )
                    )
                dist = got.get("distributed")
                if dist:
                    lines.append(
                        "  distributed %s  epoch=%s  %d partition(s)"
                        % (
                            str(dist.get("search", ""))[:16],
                            dist.get("epoch"),
                            len(dist.get("partitions") or {}),
                        )
                    )
                    for part, row in sorted(
                        (dist.get("partitions") or {}).items()
                    ):
                        lines.append(
                            "    part %s  node=%s  ops=%s  stalled=%.1fs"
                            % (
                                part,
                                row.get("node"),
                                row.get("ops_committed"),
                                float(row.get("stalled_s") or 0.0),
                            )
                        )
                print("\n".join(lines), flush=True)
            n += 1
            if args.iterations and n >= args.iterations:
                return 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


def _iter_follow_windows(lines, window_events: int):
    """Cut a JSONL event stream into prefix-closed windows.

    Yields ``(window_lines, dangling)`` chunks: a window is flushed only
    when every call in the buffer has returned (no op spans the cut) and
    at least ``window_events`` lines accumulated.  The final chunk
    carries whatever remains at EOF — ``dangling`` is the set of op ids
    still open there (a truncated tail the daemon would refuse).
    """
    import json as _json

    from .utils import events as ev

    buf: list = []
    open_ops: set = set()
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        le = ev.decode_obj(_json.loads(line))
        if le.is_start:
            open_ops.add((le.client_id, le.op_id))
        else:
            open_ops.discard((le.client_id, le.op_id))
        buf.append(line)
        if not open_ops and len(buf) >= window_events:
            yield buf, set()
            buf = []
    if buf:
        yield buf, set(open_ops)


def _cmd_follow(args: argparse.Namespace) -> int:
    import json as _json

    from .service.client import (
        VerifydBusy,
        VerifydClient,
        VerifydError,
        VerifydRefused,
        VerifydUnavailable,
    )
    from .service.protocol import (
        ERR_FRONTIER,
        EXIT_BUSY,
        EXIT_PROTOCOL,
        EXIT_UNAVAILABLE,
    )
    from .utils import events as ev

    if args.file == "-":
        source = sys.stdin
        close = False
    else:
        try:
            source = open(args.file, encoding="utf-8")
            close = True
        except OSError as e:
            log.error("failed to read history: %s", e)
            return USAGE_EXIT
    try:
        client = VerifydClient(args.socket, secret=_read_secret(args))
    except ValueError as e:
        log.error("%s", e)
        if close:
            source.close()
        return USAGE_EXIT

    frontier = args.frontier
    committed: list = []  # every line already verified — the resync body
    window = 0
    attempts = 1 + max(0, args.window_retries)
    try:
        for chunk, dangling in _iter_follow_windows(source, args.window):
            if dangling:
                log.warning(
                    "stream tail has %d call(s) with no return — an op "
                    "would span the window cut; skipping the last %d "
                    "line(s)",
                    len(dangling),
                    len(chunk),
                )
                break
            text = "\n".join(chunk) + "\n"
            # A window is only committed once its ops are actually
            # carried into the frontier: an inconclusive verdict (e.g.
            # deadline expiry) or a refused end-of-window snapshot
            # leaves the frontier at the previous cut, and moving on
            # anyway would silently drop this window's ops from the
            # verified lineage — later windows would report OK for a
            # stream-so-far that never included them.  Retry by
            # resyncing (committed + chunk as a fresh lineage); if the
            # window still won't carry, stop with the inconclusive exit
            # code instead of following a broken lineage.
            for attempt in range(attempts):
                resync = attempt > 0
                try:
                    if not resync:
                        try:
                            reply = client.follow(
                                text,
                                stream=args.stream,
                                frontier=frontier,
                                client=args.client,
                                priority=args.priority,
                                timeout=args.timeout,
                                deadline_s=args.deadline,
                            )
                        except VerifydError as e:
                            if e.cls != ERR_FRONTIER:
                                raise
                            # The daemon no longer knows our frontier
                            # (evicted, restarted without state, or a
                            # router moved the stream): resync by
                            # replaying the whole committed stream plus
                            # this window as a fresh lineage.
                            log.warning(
                                "frontier unknown at window %d — "
                                "resyncing with %d committed line(s)",
                                window,
                                len(committed),
                            )
                            resync = True
                    if resync:
                        reply = client.follow(
                            "\n".join(committed + chunk) + "\n",
                            stream=args.stream,
                            frontier=None,
                            client=args.client,
                            priority=args.priority,
                            timeout=args.timeout,
                            deadline_s=args.deadline,
                        )
                except VerifydBusy as e:
                    log.error(
                        "verifyd is at capacity (%s); retry after ~%.1fs",
                        e.msg,
                        e.retry_after_s,
                    )
                    return EXIT_BUSY
                except VerifydUnavailable as e:
                    log.error(
                        "cannot reach verifyd on %s: %s", args.socket, e.msg
                    )
                    return EXIT_UNAVAILABLE
                except VerifydError as e:
                    if e.cls == "DecodeError":
                        log.error("daemon rejected the window: %s", e.msg)
                        return USAGE_EXIT
                    log.error("follow failed: %s", e)
                    return EXIT_PROTOCOL

                verdict = reply.get("verdict")
                if args.stats:
                    print(
                        _json.dumps(
                            {
                                "stream": args.stream,
                                "window": window,
                                "attempt": attempt,
                                "ops": reply.get("ops"),
                                "ops_total": reply.get("ops_total"),
                                "verdict": verdict,
                                "backend": reply.get("backend"),
                                "frontier": reply.get("frontier"),
                                "advanced": reply.get("advanced"),
                                "wall_s": reply.get("wall_s"),
                            }
                        ),
                        flush=True,
                    )
                if verdict == 1:
                    log.error(
                        "stream %s is NOT linearizable at window %d "
                        "(%d ops total)",
                        args.stream,
                        window,
                        reply.get("ops_total") or 0,
                    )
                    return 1
                # Carried: OK with the frontier advanced through this
                # window's ops — or an all-trivial window, which has
                # nothing a frontier could absorb (elided ops cannot
                # change any later verdict).
                if verdict == 0 and (
                    reply.get("advanced") or not reply.get("ops")
                ):
                    break
                log.warning(
                    "window %d not carried (verdict %s, outcome %s, "
                    "advanced=%s)%s",
                    window,
                    verdict,
                    reply.get("outcome"),
                    bool(reply.get("advanced")),
                    "; retrying as a resync" if attempt + 1 < attempts else "",
                )
            else:
                log.error(
                    "window %d never carried into the frontier after %d "
                    "attempt(s) — stopping (%d ops verified so far)",
                    window,
                    attempts,
                    reply.get("ops_total") or len(committed),
                )
                return 2
            log.info(
                "window %d ok: %s ops carried to %s ops total (%s)",
                window,
                reply.get("ops"),
                reply.get("ops_total"),
                reply.get("backend"),
            )
            committed.extend(chunk)
            if reply.get("advanced") and reply.get("frontier"):
                frontier = reply["frontier"]
            window += 1
    except (ev.DecodeError, ValueError) as e:
        log.error("undecodable stream line: %s", e)
        return USAGE_EXIT
    except (OSError, TimeoutError) as e:
        log.error("cannot reach verifyd on %s: %s", args.socket, e)
        return EXIT_UNAVAILABLE
    finally:
        if close:
            source.close()
    if window == 0:
        log.error("stream held no closed window — nothing verified")
        return USAGE_EXIT
    log.info(
        "stream %s: %d window(s) verified, frontier %s",
        args.stream,
        window,
        frontier,
    )
    return 0


def _cmd_soak(args: argparse.Namespace) -> int:
    import json as _json

    from .collector.campaign import get_campaign
    from .service.soak import SoakConfig, SoakRunner, soak_exit_code

    for name in args.campaign or ():
        try:
            get_campaign(name)
        except KeyError as e:
            log.error("%s", e.args[0])
            return USAGE_EXIT
    try:
        secret = _read_secret(args)
    except OSError as e:
        log.error("failed to read secret: %s", e)
        return USAGE_EXIT
    cfg = SoakConfig(
        address=args.socket,
        secret=secret,
        campaigns=tuple(args.campaign or ()),
        seed=args.seed,
        cycles=args.cycles,
        clients=args.num_concurrent_clients,
        ops=args.num_ops_per_client,
        retries=args.retries,
        backoff_s=args.backoff,
        submit_timeout_s=args.timeout,
        deadline_s=args.deadline,
        alert_url=args.alert_url,
        state_dir=args.state_dir,
        mislabel_first=args.mislabel_control,
    )
    runner = SoakRunner(cfg)
    server = None
    if args.metrics_port is not None:
        from .obs.httpd import MetricsServer

        server = MetricsServer(runner.registry, args.metrics_port)
        log.info("soak metrics at %s", server.url)
    try:
        summary = runner.run()
    finally:
        if server is not None:
            server.close()
    code = soak_exit_code(summary)
    if args.json:
        print(_json.dumps(summary, sort_keys=True), flush=True)
    else:
        line = {
            "generated": summary["generated"],
            "submitted": summary["submitted"],
            "ok": summary["ok"],
            "false_verdicts": len(summary["false_verdicts"]),
            "submit_errors": len(summary["submit_errors"]),
            "inconclusive": summary["inconclusive"],
            "unlabeled": summary["unlabeled"],
            "verdict_table": summary["verdict_table"],
            "wall_s": summary["wall_s"],
        }
        print(_json.dumps(line, sort_keys=True), flush=True)
    if code == 0:
        log.info(
            "soak clean: %d/%d verdicts matched ground truth",
            summary["ok"],
            summary["submitted"],
        )
    elif code == 1:
        for fv in summary["false_verdicts"]:
            log.error(
                "false verdict: campaign=%s seed=%d expected=%s actual=%s "
                "fingerprint=%s",
                fv["campaign"],
                fv["seed"],
                fv["expect"],
                fv["actual"],
                fv.get("fingerprint"),
            )
    else:
        log.error(
            "soak inconclusive: %d submit errors, %d UNKNOWN verdicts, "
            "%d unlabeled skips",
            len(summary["submit_errors"]),
            summary["inconclusive"],
            summary["unlabeled"],
        )
    return code


#: the port's own lint records, beside the JAX package's at the repo root
LINT_BASELINE = ".verifylint-torch-baseline.json"
LINT_CACHE = ".verifylint-torch-cache.json"
LINT_EVENTS_MD = "docs/EVENTS_torch.md"
_LINT_PKG = "s2_verification_tpu_torch/"


def _lint_root() -> str:
    """The repo root: the directory holding the package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint_changed_paths(root: str) -> list[str] | None:
    """git-diff-scoped .py paths of the port (worktree + index +
    untracked), or None when git is unavailable — caller falls back to the
    full tree."""
    import subprocess

    try:
        out = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=root,
            capture_output=True,
            text=True,
            timeout=10,
            check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    paths: list[str] = []
    for line in out.splitlines():
        if len(line) < 4:
            continue
        p = line[3:].split(" -> ")[-1].strip().strip('"')
        if p.endswith(".py") and p.startswith(_LINT_PKG):
            if os.path.exists(os.path.join(root, p)):
                paths.append(p)
    return paths


def _cmd_lint(args: argparse.Namespace) -> int:
    from .analysis import LintEngine, load_baseline, write_baseline
    from .analysis.engine import TreeContext, apply_baseline, discover_files
    from .analysis.event_schema import render_events_md

    root = _lint_root()
    baseline_path = args.baseline or os.path.join(root, LINT_BASELINE)
    cache_path = None if args.no_cache else os.path.join(root, LINT_CACHE)

    if args.changed:
        rels = _lint_changed_paths(root)
        if rels is None:
            log.warning("lint --changed: git unavailable, scanning the full tree")
            rels = discover_files(root, args.paths or None)
    else:
        rels = discover_files(root, args.paths or None)

    # --events-md / --check-events-md always read the whole package —
    # a partial scan would render a partial registry.
    if args.events_md is not None or args.check_events_md:
        ctx = TreeContext(root, discover_files(root, None))
        rendered = render_events_md(ctx)
        if args.events_md is not None:
            if args.events_md == "-":
                sys.stdout.write(rendered)
            else:
                out_path = (
                    args.events_md
                    if os.path.isabs(args.events_md)
                    else os.path.join(root, args.events_md)
                )
                with open(out_path, "w", encoding="utf-8") as f:
                    f.write(rendered)
                print(f"wrote {out_path}")
        if args.check_events_md:
            committed = os.path.join(root, LINT_EVENTS_MD)
            try:
                with open(committed, encoding="utf-8") as f:
                    on_disk = f.read()
            except OSError:
                on_disk = ""
            if on_disk != rendered:
                log.error(
                    "%s is stale — regenerate with `lint --events-md %s`",
                    LINT_EVENTS_MD,
                    LINT_EVENTS_MD,
                )
                return 1
            print(f"{LINT_EVENTS_MD} is up to date")
        return 0

    full_tree = not args.changed and not args.paths
    engine = LintEngine(root, cache_path=cache_path)
    res = engine.run(rel_paths=rels)

    if args.write_baseline:
        if not full_tree:
            log.error("--write-baseline needs a full-tree run (no --changed/paths)")
            return USAGE_EXIT
        write_baseline(res.findings, baseline_path)
        print(
            f"wrote {baseline_path} "
            f"({sum(1 for f in res.findings if f.severity == 'error')} errors baselined; "
            "add a justification to every entry)"
        )
        return 0

    baseline = load_baseline(baseline_path)
    ratchet = apply_baseline(res.findings, baseline)

    if args.json:
        doc = {
            "files": res.files,
            "suppressed": res.suppressed,
            "cache_hits": res.cache_hits,
            "findings": [f.to_dict() for f in res.findings],
            "new_errors": [f.to_dict() for f in ratchet.new_errors],
            "baselined": len(ratchet.baselined),
            "stale_baseline_keys": ratchet.stale_keys,
        }
        print(json.dumps(doc, indent=2))
    else:
        baselined_keys = {f.key for f in ratchet.baselined}
        shown = 0
        for f in res.findings:
            tag = " (baselined)" if f.severity == "error" and f.key in baselined_keys else ""
            print(f"{f.path}:{f.line}: {f.severity}: [{f.rule}] {f.message}{tag}")
            shown += 1
        n_err = sum(1 for f in res.findings if f.severity == "error")
        print(
            f"{shown} finding(s) in {res.files} file(s): {n_err} error(s) "
            f"({len(ratchet.new_errors)} new, {len(ratchet.baselined)} baselined), "
            f"{res.suppressed} suppressed, {res.cache_hits} cache hit(s)"
        )
        if full_tree:
            for key in ratchet.stale_keys:
                print(
                    f"stale baseline entry (debt paid down — shrink with "
                    f"--write-baseline): {key}"
                )
    return 1 if ratchet.new_errors else 0


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
    g.set_defaults(fn=_cmd_collect)
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

    s = sub.add_parser(
        "serve", help="run verifyd, the resident verification daemon"
    )
    s.add_argument(
        "-socket", "--socket", required=True, help="unix-domain socket path"
    )
    s.add_argument(
        "--queue-depth",
        type=int,
        default=64,
        help="admission-queue bound; a full queue rejects with retry-after "
        "instead of buffering (default 64)",
    )
    s.add_argument("--workers", type=int, default=1)
    s.add_argument(
        "--batch-max",
        type=int,
        default=16,
        help="max jobs per shape group a worker drains back to back",
    )
    s.add_argument(
        "-time-budget",
        "--time-budget",
        type=float,
        default=10.0,
        help="per-job CPU budget in seconds before device escalation; "
        "0 = unbounded CPU, no escalation (default 10)",
    )
    s.add_argument(
        "--device",
        default="supervised",
        choices=["supervised", "inline", "off"],
        help="device escalation: 'supervised' (bounded child + checkpoint "
        "resume; a wedged or lost card degrades the job to CPU), 'inline' "
        "(in-process: the daemon holds one CUDA context across jobs), 'off'",
    )
    s.add_argument(
        "--torch-device",
        default=None,
        metavar="DEVICE",
        help="torch device of the inline and supervised escalations "
        "(default: the card, cuda; an inline daemon without one exits 64). "
        "'cpu' runs the device search on the CPU",
    )
    s.add_argument("-out-dir", "--out-dir", default="./porcupine-outputs")
    s.add_argument(
        "-no-viz",
        "--no-viz",
        action="store_true",
        help="default jobs to skipping the HTML artifact",
    )
    s.add_argument(
        "--stats-log",
        default="-",
        help="structured per-job event sink: a path, '-' for stderr "
        "(default), or '' to silence",
    )
    s.add_argument(
        "-device-rows",
        "--device-rows",
        type=int,
        default=None,
        help="device-resident frontier cap for escalated jobs",
    )
    s.add_argument(
        "--tcp",
        default=None,
        metavar="HOST:PORT",
        help="also listen on an authenticated TCP address (port 0 = "
        "ephemeral); every frame carries an HMAC under the shared secret "
        "(--secret-file / VERIFYD_SECRET) and unauthenticated frames are "
        "rejected before admission",
    )
    s.add_argument(
        "--secret-file",
        default=None,
        help="file holding the TCP shared secret (whitespace-stripped); "
        "falls back to the VERIFYD_SECRET environment variable",
    )
    s.add_argument(
        "--state-dir",
        default=None,
        help="durable-state directory (verdict-cache segments + admission "
        "journal): a restarted daemon answers previously decided "
        "histories from disk and re-runs jobs that were accepted but "
        "never answered (default: in-memory only).",
    )
    s.add_argument(
        "--fsync",
        action="store_true",
        help="fsync every durable append (survives machine crashes, not "
        "just daemon death; slower)",
    )
    s.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        metavar="PORT",
        help="serve Prometheus text metrics on http://127.0.0.1:PORT/metrics "
        "(0 = ephemeral port, logged at startup; default: off).",
    )
    s.add_argument(
        "--trace-capacity",
        type=int,
        default=8192,
        metavar="SPANS",
        help="in-memory span-ring capacity for the `trace` op (0 disables "
        "tracing; default 8192)",
    )
    s.add_argument(
        "-profile",
        "--profile",
        action="store_true",
        help="attach a per-job search-shape profile (FrontierStats + "
        "per-layer timeline) to every done event and submit reply",
    )
    s.add_argument(
        "-mesh-devices",
        "--mesh-devices",
        default=None,
        metavar="N|auto",
        help="device-pool size for mesh-sharded escalations: escalating "
        "jobs lease a power-of-two card set sized by job shape and run "
        "the frontier search sharded over exactly those cards, reported "
        "as backend device-mesh[N] ('auto' = every visible card, counted "
        "in a probe child; default: off — single-card escalation). With "
        "--torch-device cpu every slot is a CPU shard.",
    )
    s.add_argument(
        "--log-format",
        default="text",
        choices=["text", "json"],
        help="structured-log line format for daemon diagnostics and the "
        "stats-log '-' fallback: human 'text' (default) or one JSON "
        "object per line for log shippers",
    )
    s.add_argument(
        "--slo-target",
        type=float,
        default=0.99,
        metavar="FRACTION",
        help="SLO availability target driving /healthz and slo_breach "
        "events (default 0.99; 1.0 disables burn-rate math)",
    )
    s.add_argument(
        "--slo-latency-target",
        type=float,
        default=5.0,
        metavar="SECONDS",
        help="end-to-end p95 latency target on the 1m window for "
        "/healthz degradation (default 5.0)",
    )
    s.add_argument(
        "--alert-url",
        default=None,
        metavar="URL",
        help="deliver alertmanager-compatible JSON webhooks (slo_breach, "
        "perf_regression, and --alert-rule matches) to this HTTP URL, "
        "with exponential-backoff retries and per-rule dedup windows "
        "(default: off).",
    )
    s.add_argument(
        "--alert-rule",
        action="append",
        default=None,
        metavar="SPEC",
        help="additional alert rule (repeatable): an event name "
        "('slo_breach'), a field threshold ('done.wall_s>30'), or a "
        "metric threshold ('metric:verifyd_job_errors_total>=5'); "
        "named like a builtin, it overrides that builtin.",
    )
    s.add_argument(
        "--alert-dedup",
        type=float,
        default=300.0,
        metavar="SECONDS",
        help="per-rule alert dedup window: repeat fires inside it are "
        "suppressed (counted), not delivered (default 300)",
    )
    s.add_argument(
        "--sentinel-band",
        type=float,
        default=0.75,
        metavar="FRACTION",
        help="perf-regression sentinel drift band: a shape whose wall "
        "time exceeds its EWMA baseline by this fraction on consecutive "
        "jobs emits perf_regression (default 0.75; <=0 disables the "
        "sentinel)",
    )
    s.add_argument(
        "--sentinel-min-samples",
        type=int,
        default=8,
        metavar="N",
        help="jobs per shape before the sentinel judges drift (default 8)",
    )
    s.add_argument(
        "--resource-sample",
        type=float,
        default=1.0,
        metavar="SECONDS",
        help="resource-telemetry sampling interval: host RSS, CPU, fds, "
        "threads, GC pauses into verifyd_resource_* gauges and the "
        "flight recorder (default 1.0; <=0 disables the sampler)",
    )
    s.add_argument(
        "--retrace-storm",
        type=int,
        default=5,
        metavar="N",
        help="emit a latched retrace_storm event when one build site "
        "rebuilds a shape bucket more than N times (default 5; "
        "0 disables)",
    )
    s.add_argument(
        "--dashboard-sample",
        type=float,
        default=2.0,
        metavar="SECONDS",
        help="/dashboard sparkline sampling interval on the metrics "
        "listener (needs --metrics-port; default 2.0; <=0 disables "
        "the dashboard)",
    )
    s.add_argument(
        "--telemetry-dir",
        default=None,
        metavar="DIR",
        help="durable telemetry store root (delta-encoded registry "
        "snapshots at raw/1m/15m resolutions; the tsq command and "
        "sentinel re-seeding read it); default <state-dir>/telemetry, "
        "disabled without a state dir.",
    )
    s.add_argument(
        "--telemetry-sample",
        type=float,
        default=2.0,
        metavar="SECONDS",
        help="telemetry sampling interval for the raw ring (the 1m/15m "
        "rings downsample from it; default 2.0; <=0 disables recording)",
    )
    s.add_argument(
        "--drain-timeout",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="graceful drain budget: on SIGTERM (or a drain-flagged "
        "shutdown op) stop admitting, let queued + in-flight jobs "
        "finish up to this many seconds, close the journal cleanly, "
        "then exit.  0 (default) keeps the immediate-stop behavior; "
        "the router's rolling restart needs this > 0",
    )
    s.add_argument(
        "--max-rss-frac",
        type=float,
        default=0.0,
        metavar="FRACTION",
        help="pressure-aware admission: shed new submits (honest "
        "retry_after, QueueFull) while daemon RSS exceeds this fraction "
        "of MemTotal, and while open fds near RLIMIT_NOFILE "
        "(default 0 = shedding off)",
    )
    s.add_argument(
        "--deadline-grace",
        type=float,
        default=2.0,
        metavar="SECONDS",
        help="SIGTERM-to-SIGKILL grace for supervised children of "
        "cancelled jobs (deadline expiry, client gone, shutdown) "
        "(default 2.0)",
    )
    s.add_argument(
        "--quarantine-threshold",
        type=int,
        default=3,
        metavar="N",
        help="poison-job quarantine: a fingerprint observed in-flight "
        "across this many process deaths or supervised-child kills is "
        "quarantined (definite Quarantined error) instead of replayed; "
        "needs --state-dir (default 3)",
    )
    s.add_argument(
        "--batching",
        action="store_true",
        help="continuous cross-job batching: drain every queued job of a "
        "worker-picked shape group into one mega-launch (late-join at "
        "launch boundaries, per-lane deadlines/cancels honored, per-job "
        "done attribution)",
    )
    s.add_argument(
        "--batch-engine",
        default="auto",
        choices=("auto", "native", "vmap"),
        help="mega-launch engine: native (pre-encoded C lanes, per-lane "
        "early exit) or vmap (one compiled vmapped frontier search per "
        "launch); auto picks native when the C engine is built "
        "(default auto)",
    )
    s.add_argument(
        "--no-fast-admission",
        dest="fast_admission",
        action="store_false",
        default=True,
        help="disable the fused single-pass admission parser and decode "
        "every submission through the layered event decoder",
    )
    s.add_argument(
        "--prune",
        action="store_true",
        help="verdict-exact search pruning on every engine that carries "
        "it: successful appends expand in their forced tail order, inert "
        "ops and state-passing filters commit eagerly, and tail-pinned "
        "dead configurations drop — same verdicts, smaller search "
        "(checker/prune.py; parity gated by `make prune`)",
    )
    s.add_argument(
        "--speculate-depth",
        type=int,
        default=0,
        metavar="K",
        help="speculative multi-layer frontier expansion for device "
        "escalations: one narrow K-layer dive per launch along the "
        "value-ordered beam, accepted only when it reaches a conclusive "
        "accept, wholesale-discarded on misprediction (0 = off; "
        "internally disabled for witness-carrying runs)",
    )
    s.add_argument(
        "--prefix",
        action="store_true",
        help="incremental prefix verification: snapshot the decided "
        "frontier at closed op boundaries of every OK search, keyed by "
        "the chain-hash of the committed prefix, so a resubmission that "
        "extends a verified history resumes at the deepest cached cut "
        "instead of op 0 — and enable the 'follow' op for rolling-window "
        "stream monitoring.  Snapshots persist under --state-dir and "
        "survive restarts.",
    )
    s.add_argument(
        "--prefix-capacity",
        type=int,
        default=2048,
        metavar="N",
        help="in-memory prefix-store entries before LRU eviction "
        "(default 2048)",
    )
    s.add_argument(
        "--prefix-min-ops",
        type=int,
        default=4,
        metavar="N",
        help="histories shorter than this skip the prefix probe — the "
        "cold search is cheaper than the bookkeeping (default 4)",
    )
    s.add_argument(
        "--prefix-cuts",
        type=int,
        default=8,
        metavar="N",
        help="snapshot cuts recorded per OK search (deepest boundary "
        "always included; the rest spread evenly) (default 8)",
    )
    s.add_argument(
        "--prefix-max-segments",
        type=int,
        default=8,
        metavar="N",
        help="on-disk prefix log segments before the oldest rotates out "
        "(default 8)",
    )
    s.set_defaults(fn=_cmd_serve, stats=False)

    r = sub.add_parser(
        "route",
        help="verifyd-router: front N verifyd daemons behind one address "
        "(consistent-hash cache affinity, work stealing, circuit-broken "
        "failover, rolling restarts)",
    )
    rsub = r.add_subparsers(dest="route_cmd", required=True)

    rs = rsub.add_parser(
        "serve", help="run the router daemon in the foreground"
    )
    rs.add_argument(
        "--listen",
        required=True,
        metavar="SOCK|HOST:PORT",
        help="router address clients dial: a unix-socket path, or "
        "HOST:PORT for the authenticated TCP transport (needs "
        "--secret-file / VERIFYD_SECRET; port 0 = ephemeral)",
    )
    rs.add_argument(
        "--backend",
        action="append",
        required=True,
        metavar="NAME=ADDR[@HEALTHZ_URL]",
        help="fleet member (repeatable): NAME names the node in metrics "
        "and drain commands; ADDR is its unix socket or HOST:PORT "
        "(TCP backends share the router's secret); the optional "
        "HEALTHZ_URL switches probing from TCP ping to the daemon's "
        "HTTP /healthz (real 200/503 SLO state)",
    )
    rs.add_argument(
        "--secret-file",
        default=None,
        help="file holding the shared secret for the TCP listener and "
        "TCP backends; falls back to VERIFYD_SECRET",
    )
    rs.add_argument(
        "--probe-interval",
        type=float,
        default=1.0,
        metavar="SECONDS",
        help="health-probe period per backend (default 1.0)",
    )
    rs.add_argument(
        "--breaker-failures",
        type=int,
        default=3,
        metavar="N",
        help="consecutive transport failures before a backend's circuit "
        "breaker opens (default 3)",
    )
    rs.add_argument(
        "--breaker-reset",
        type=float,
        default=5.0,
        metavar="SECONDS",
        help="open-breaker wait before admitting one half-open probe "
        "request (default 5.0)",
    )
    rs.add_argument(
        "--steal-depth",
        type=int,
        default=4,
        metavar="N",
        help="router-side in-flight on the home node at which a cold "
        "job is work-stolen to the least loaded healthy node "
        "(default 4)",
    )
    rs.add_argument(
        "--max-failovers",
        type=int,
        default=3,
        metavar="N",
        help="failover hops after the first attempt before answering "
        "NoBackend (default 3)",
    )
    rs.add_argument(
        "--submit-timeout",
        type=float,
        default=None,
        metavar="SECONDS",
        help="per-attempt verdict wait against one backend "
        "(default: wait)",
    )
    rs.add_argument(
        "--ring-replicas",
        type=int,
        default=64,
        metavar="N",
        help="virtual nodes per backend on the consistent-hash ring "
        "(default 64)",
    )
    rs.add_argument(
        "--drain-timeout",
        type=float,
        default=30.0,
        metavar="SECONDS",
        help="default budget a `route drain` waits for in-flight work "
        "(default 30)",
    )
    rs.add_argument(
        "--cache-capacity",
        type=int,
        default=4096,
        metavar="N",
        help="router edge cache: decided verdicts answered at the "
        "router with no backend hop (entries; 0 disables; default 4096)",
    )
    rs.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        metavar="PORT",
        help="router /metrics + /healthz + /slo listener "
        "(0 = ephemeral; default: off)",
    )
    rs.add_argument(
        "--trace-capacity",
        type=int,
        default=4096,
        metavar="SPANS",
        help="router span-ring capacity for the stitched `trace` op "
        "(0 disables; default 4096)",
    )
    rs.add_argument(
        "--slo-target",
        type=float,
        default=0.99,
        metavar="FRACTION",
        help="router availability SLO target for /healthz (default 0.99)",
    )
    rs.add_argument(
        "--slo-latency-target",
        type=float,
        default=5.0,
        metavar="SECONDS",
        help="routed-submit p95 latency target (default 5.0)",
    )
    rs.add_argument(
        "--state-dir",
        default=None,
        metavar="DIR",
        help="router durable state: the distributed-search grant ledger "
        "lands in DIR/distsearch/ (grant-before-ship partition "
        "ownership; replayed at boot to fence a dead coordinator's "
        "epochs and surface orphan ranges).  Default: no ledger",
    )
    rs.add_argument(
        "--distsearch-segments",
        type=int,
        default=3,
        metavar="N",
        help="distributed search: target segment count the coordinator "
        "slices a submitted history into (default 3)",
    )
    rs.add_argument(
        "--distsearch-straggler",
        type=float,
        default=10.0,
        metavar="SECONDS",
        help="distributed search: partition runtime after which an idle "
        "healthy node steals the range under a new epoch (0 disables; "
        "default 10)",
    )
    rs.add_argument(
        "--distsearch-max-regrants",
        type=int,
        default=3,
        metavar="N",
        help="distributed search: re-grants per partition (failover or "
        "inconclusive owner) before the merged verdict degrades to "
        "UNKNOWN (default 3)",
    )
    rs.add_argument(
        "--scrape-interval",
        type=float,
        default=2.0,
        metavar="SECONDS",
        help="fleet-metrics scrape period: every backend's families "
        "polled and merged under a node label onto /fleet/metrics and "
        "the fleet dashboard (default 2.0; <=0 disables the scraper)",
    )
    rs.add_argument(
        "--telemetry-dir",
        default=None,
        metavar="DIR",
        help="durable telemetry store root for the router's registry "
        "(which carries the merged per-node fleet gauges); default "
        "<state-dir>/telemetry, disabled without a state dir",
    )
    rs.add_argument(
        "--telemetry-sample",
        type=float,
        default=2.0,
        metavar="SECONDS",
        help="telemetry sampling interval for the raw ring (default "
        "2.0; <=0 disables recording)",
    )
    rs.set_defaults(fn=_cmd_route_serve)

    def _route_op_parser(name: str, help_text: str):
        rp = rsub.add_parser(name, help=help_text)
        rp.add_argument(
            "-socket",
            "--socket",
            required=True,
            help="the router's unix-socket path or HOST:PORT",
        )
        rp.add_argument(
            "--secret-file",
            default=None,
            help="shared secret for a TCP router address; falls back to "
            "VERIFYD_SECRET",
        )
        return rp

    rd = _route_op_parser(
        "drain",
        "rolling restart, step 1: stop routing to NODE, wait for its "
        "in-flight, then send it a drain-aware shutdown (the restarted "
        "node replays its journal and rejoins via the health probe)",
    )
    rd.add_argument("node", help="backend name (as given to --backend)")
    rd.add_argument(
        "--timeout",
        type=float,
        default=None,
        metavar="SECONDS",
        help="drain budget override (default: the router's "
        "--drain-timeout)",
    )
    rd.set_defaults(fn=_cmd_route_drain)

    ru = _route_op_parser(
        "undrain", "return a drained node to the routable set"
    )
    ru.add_argument("node", help="backend name (as given to --backend)")
    ru.set_defaults(fn=_cmd_route_undrain)

    rf = _route_op_parser(
        "fleet", "show ring membership + per-backend health/drain state"
    )
    rf.add_argument(
        "--json", action="store_true", help="emit the raw fleet JSON"
    )
    rf.set_defaults(fn=_cmd_route_fleet)

    t = sub.add_parser(
        "trace",
        help="export a running verifyd's span ring as Chrome trace_event "
        "JSON (loads in Perfetto / chrome://tracing)",
    )
    t.add_argument(
        "-socket",
        "--socket",
        required=True,
        help="the daemon's unix-socket path, or HOST:PORT for the "
        "authenticated TCP transport (needs --secret-file or "
        "VERIFYD_SECRET)",
    )
    t.add_argument(
        "--secret-file",
        default=None,
        help="file holding the TCP shared secret (whitespace-stripped); "
        "falls back to the VERIFYD_SECRET environment variable",
    )
    t.add_argument(
        "-out",
        "--out",
        default="-",
        help="output path for the trace JSON ('-' = stdout, the default)",
    )
    t.set_defaults(fn=_cmd_trace)

    da = sub.add_parser(
        "dash",
        help="live terminal dashboard over a running verifyd: sparkline "
        "history of throughput, queue depth, active jobs, RSS, and JIT "
        "compile activity from the stats op (the HTML twin lives at "
        "/dashboard on --metrics-port)",
    )
    da.add_argument(
        "-socket",
        "--socket",
        required=True,
        help="the daemon's unix-socket path, or HOST:PORT for the "
        "authenticated TCP transport (needs --secret-file or "
        "VERIFYD_SECRET)",
    )
    da.add_argument(
        "--secret-file",
        default=None,
        help="file holding the TCP shared secret (whitespace-stripped); "
        "falls back to the VERIFYD_SECRET environment variable",
    )
    da.add_argument(
        "--interval",
        type=float,
        default=2.0,
        metavar="SECONDS",
        help="seconds between polls (default 2.0)",
    )
    da.add_argument(
        "--iterations",
        type=int,
        default=0,
        metavar="N",
        help="stop after N frames (default 0 = run until interrupted)",
    )
    da.add_argument(
        "--width",
        type=int,
        default=32,
        metavar="COLS",
        help="sparkline width in characters (default 32)",
    )
    da.set_defaults(fn=_cmd_dash)

    w = sub.add_parser(
        "watch",
        help="live progress board for running searches: per-job progress "
        "ratio, committed/total ops, frontier width and ETA from the "
        "watch op (point it at a daemon, or at a router to watch the "
        "whole fleet including distributed partitions)",
    )
    w.add_argument(
        "-socket",
        "--socket",
        required=True,
        help="the daemon's (or router's) unix-socket path, or HOST:PORT "
        "for the authenticated TCP transport (needs --secret-file or "
        "VERIFYD_SECRET)",
    )
    w.add_argument(
        "--secret-file",
        default=None,
        help="file holding the TCP shared secret (whitespace-stripped); "
        "falls back to the VERIFYD_SECRET environment variable",
    )
    w.add_argument(
        "--job",
        type=int,
        default=None,
        metavar="ID",
        help="watch one job id (definite UnknownJob when it is not "
        "running; after it was visible, that means it finished)",
    )
    w.add_argument(
        "--fingerprint",
        default=None,
        metavar="FP",
        help="watch by verdict-cache fingerprint (e.g. the ppart:… key "
        "of a distributed partition job)",
    )
    w.add_argument(
        "--search",
        default=None,
        metavar="SEARCH",
        help="watch every partition of a distributed search (the search "
        "id from submit --distributed); against a router this also "
        "shows the coordinator's per-partition aggregate",
    )
    w.add_argument(
        "--part",
        default=None,
        metavar="RANGE",
        help="narrow --search to one partition range",
    )
    w.add_argument(
        "--json",
        action="store_true",
        help="emit one JSON object per poll instead of the board",
    )
    w.add_argument(
        "--interval",
        type=float,
        default=1.0,
        metavar="SECONDS",
        help="seconds between polls (default 1.0)",
    )
    w.add_argument(
        "--iterations",
        type=int,
        default=0,
        metavar="N",
        help="stop after N frames (default 0 = run until the watched "
        "job finishes or interrupted)",
    )
    w.add_argument(
        "--width",
        type=int,
        default=32,
        metavar="COLS",
        help="sparkline width in characters (default 32)",
    )
    w.set_defaults(fn=_cmd_watch)

    u = sub.add_parser("submit", help="submit one history to a running verifyd")
    u.add_argument(
        "-file", "--file", required=True, help="history JSONL path, '-' for stdin"
    )
    u.add_argument(
        "-socket",
        "--socket",
        required=True,
        help="the daemon's unix-socket path, or HOST:PORT for the "
        "authenticated TCP transport (needs --secret-file or "
        "VERIFYD_SECRET)",
    )
    u.add_argument(
        "--secret-file",
        default=None,
        help="file holding the TCP shared secret (whitespace-stripped); "
        "falls back to the VERIFYD_SECRET environment variable",
    )
    u.add_argument("--client", default="cli", help="client identity for the queue")
    u.add_argument(
        "--priority",
        type=int,
        default=10,
        help="admission priority (lower = scheduled sooner; default 10)",
    )
    u.add_argument(
        "--timeout",
        type=float,
        default=None,
        help="seconds to wait for the verdict (default: wait)",
    )
    u.add_argument(
        "--retries",
        type=int,
        default=0,
        help="re-submissions after a transient failure.  Queue-full "
        "rejects sleep the daemon's retry-after hint; connect failures "
        "and transport noise sleep exponential backoff with jitter "
        "(--backoff).  Default 0: fail fast.  Exhausted retries exit "
        "75 (still busy), 69 (no daemon ever answered), or 76 (a "
        "daemon was reached but refused)",
    )
    u.add_argument(
        "--backoff",
        type=float,
        default=0.5,
        metavar="SECONDS",
        help="base of the exponential retry backoff: attempt n sleeps "
        "uniform(0, SECONDS * 2^n), capped at 30s (default 0.5)",
    )
    u.add_argument(
        "--deadline",
        type=float,
        default=None,
        metavar="SECONDS",
        help="total wall-clock budget across all attempts and retry "
        "sleeps: per-attempt timeouts are clamped to what remains, and "
        "a spent budget exits 69 with 'deadline exceeded after N "
        "attempts' — bounds a retry loop against a flapping node "
        "(default: unbounded)",
    )
    u.add_argument(
        "-no-viz", "--no-viz", action="store_true", help="skip the HTML artifact"
    )
    u.add_argument(
        "-distributed",
        "--distributed",
        action="store_true",
        help="ask a verifyd-router to run the search fleet-distributed: "
        "the frontier is partitioned by state-hash range across healthy "
        "backends and the merged verdict carries partition/epoch "
        "telemetry.  Plain daemons (and routers without >= 2 healthy "
        "backends) serve the submit single-node — the flag degrades, "
        "never fails",
    )
    u.add_argument(
        "-stats",
        "--stats",
        action="store_true",
        help="print one machine-readable JSON line (verdict, backend, "
        "queue wait, cache hit) on stdout",
    )
    u.set_defaults(fn=_cmd_submit)

    fo = sub.add_parser(
        "follow",
        help="verify a growing event stream window-by-window against a "
        "--prefix daemon (the decided frontier is carried forward, so "
        "each window costs its own ops)",
    )
    fo.add_argument(
        "-file",
        "--file",
        required=True,
        help="history JSONL path, '-' for stdin (pipe a live collector "
        "into it)",
    )
    fo.add_argument(
        "-socket",
        "--socket",
        required=True,
        help="the daemon's unix-socket path, or HOST:PORT for the "
        "authenticated TCP transport (needs --secret-file or "
        "VERIFYD_SECRET); a router address works — streams route by "
        "stream id",
    )
    fo.add_argument(
        "--secret-file",
        default=None,
        help="file holding the TCP shared secret (whitespace-stripped); "
        "falls back to the VERIFYD_SECRET environment variable",
    )
    fo.add_argument(
        "--stream",
        required=True,
        help="stream identity: scopes the frontier lineage and (behind a "
        "router) pins every window to one backend",
    )
    fo.add_argument(
        "--frontier",
        default=None,
        help="resume from a frontier token printed by an earlier run "
        "(default: start a fresh lineage at window 0)",
    )
    fo.add_argument(
        "--window",
        type=int,
        default=256,
        metavar="EVENTS",
        help="events per window: a window is cut at the first point at "
        "or after this many lines where no call is still open "
        "(default 256)",
    )
    fo.add_argument("--client", default="cli", help="client identity for the queue")
    fo.add_argument(
        "--priority",
        type=int,
        default=10,
        help="admission priority (lower = scheduled sooner; default 10)",
    )
    fo.add_argument(
        "--timeout",
        type=float,
        default=None,
        help="seconds to wait for each window's verdict (default: wait)",
    )
    fo.add_argument(
        "--deadline",
        type=float,
        default=None,
        metavar="SECONDS",
        help="per-window end-to-end deadline forwarded to the daemon "
        "(default: unbounded)",
    )
    fo.add_argument(
        "--window-retries",
        type=int,
        default=2,
        metavar="N",
        help="resync retries for a window whose ops were not carried "
        "into the frontier (inconclusive verdict, refused snapshot) "
        "before exiting 2 — moving on without a carry would silently "
        "drop the window from the verified lineage (default 2)",
    )
    fo.add_argument(
        "-stats",
        "--stats",
        action="store_true",
        help="print one machine-readable JSON line per window (verdict, "
        "backend, frontier token, ops carried) on stdout",
    )
    fo.set_defaults(fn=_cmd_follow)

    k = sub.add_parser(
        "soak",
        help="closed-loop soak: generate labeled fault-campaign histories, "
        "submit them to a live daemon/fleet, and score every verdict "
        "against its ground-truth label",
    )
    k.add_argument(
        "socket",
        help="daemon or router address (unix-socket path, or HOST:PORT "
        "with --secret-file / VERIFYD_SECRET)",
    )
    k.add_argument(
        "--campaign",
        action="append",
        metavar="NAME",
        help="campaign to run (repeatable; default: the full builtin "
        "matrix — see `collect --list-campaigns`)",
    )
    k.add_argument("--seed", type=int, default=0, help="schedule seed base")
    k.add_argument(
        "--cycles",
        type=int,
        default=1,
        help="passes over the campaign list, each with fresh derived seeds",
    )
    k.add_argument(
        "--num-concurrent-clients",
        type=int,
        default=None,
        help="override each campaign's client sizing",
    )
    k.add_argument(
        "--num-ops-per-client",
        type=int,
        default=None,
        help="override each campaign's per-client op count",
    )
    k.add_argument(
        "--retries",
        type=int,
        default=8,
        help="per-history re-submissions riding out fleet failovers "
        "(default 8)",
    )
    k.add_argument("--backoff", type=float, default=0.25, metavar="SECONDS")
    k.add_argument(
        "--timeout",
        type=float,
        default=120.0,
        help="per-attempt verdict wait (default 120s)",
    )
    k.add_argument(
        "--deadline",
        type=float,
        default=None,
        metavar="SECONDS",
        help="total wall-clock budget per submission across retries",
    )
    k.add_argument(
        "--alert-url",
        default=None,
        help="webhook for checker_false_verdict alert delivery",
    )
    k.add_argument(
        "--state-dir",
        default=None,
        help="flight-recorder ring + offending-history dumps land here",
    )
    k.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="serve verifyd_soak_* families on /metrics (0 = ephemeral port)",
    )
    k.add_argument(
        "--mislabel-control",
        action="store_true",
        help="deliberately flip the first history's label — a control case "
        "proving the checker_false_verdict alert + nonzero exit fire",
    )
    k.add_argument("--secret-file", default=None)
    k.add_argument(
        "--json",
        action="store_true",
        help="print the full machine-readable summary (default: one "
        "compact summary line)",
    )
    k.set_defaults(fn=_cmd_soak)

    d = sub.add_parser(
        "doctor",
        help="post-mortem a dead verifyd's --state-dir: flight-recorder "
        "tail, orphaned journal entries, open device leases, slowest "
        "spans, and the SLO picture at death",
    )
    d.add_argument(
        "--state-dir",
        required=True,
        help="the dead daemon's durable-state directory",
    )
    d.add_argument(
        "--tail",
        type=int,
        default=20,
        help="flight-recorder records to show (default 20)",
    )
    d.add_argument(
        "--json",
        action="store_true",
        help="emit the full post-mortem as JSON instead of the report",
    )
    d.set_defaults(fn=_cmd_doctor)

    tq = sub.add_parser(
        "tsq",
        help="query durable telemetry history: per-series points with "
        "sparklines, live off a daemon/router socket or cold off a "
        "telemetry directory (same store, same answer)",
    )
    tq.add_argument(
        "-socket",
        "--socket",
        default=None,
        help="live path: a running daemon/router (unix-socket path, or "
        "HOST:PORT with --secret-file / VERIFYD_SECRET)",
    )
    tq.add_argument(
        "--secret-file",
        default=None,
        help="shared-secret file for a TCP --socket",
    )
    tq.add_argument(
        "--telemetry-dir",
        default=None,
        metavar="DIR",
        help="cold path: read the rings straight from a telemetry dir "
        "(works while the daemon is dead)",
    )
    tq.add_argument(
        "--state-dir",
        default=None,
        metavar="DIR",
        help="cold-path shorthand: DIR/telemetry",
    )
    tq.add_argument(
        "--res",
        choices=("raw", "1m", "15m"),
        default="raw",
        help="resolution ring to read (default raw)",
    )
    tq.add_argument(
        "--metric",
        default=None,
        metavar="SUBSTR",
        help="series-name substring filter (e.g. queue_depth)",
    )
    tq.add_argument(
        "--label",
        action="append",
        default=None,
        metavar="KEY=VALUE",
        help="label equality filter (repeatable; all must match)",
    )
    tq.add_argument(
        "--since",
        type=float,
        default=None,
        metavar="EPOCH",
        help="range start (unix seconds)",
    )
    tq.add_argument(
        "--until",
        type=float,
        default=None,
        metavar="EPOCH",
        help="range end (unix seconds)",
    )
    tq.add_argument(
        "--limit",
        type=int,
        default=None,
        metavar="N",
        help="points kept per series, from the tail (default 360 live, "
        "720 cold)",
    )
    tq.add_argument(
        "--rate",
        action="store_true",
        help="render cumulative counters as per-second rates (negative "
        "deltas from restarts clamp to 0)",
    )
    tq.add_argument(
        "--info",
        action="store_true",
        help="ring inventory (records, series, bytes, recovery) instead "
        "of points",
    )
    tq.add_argument(
        "--width",
        type=int,
        default=48,
        metavar="COLS",
        help="sparkline width (default 48)",
    )
    tq.add_argument(
        "--json", action="store_true", help="emit the raw reply JSON"
    )
    tq.add_argument(
        "--csv",
        action="store_true",
        help="emit series,t,value rows instead of the sparkline table",
    )
    tq.set_defaults(fn=_cmd_tsq)

    qp = sub.add_parser(
        "quarantine",
        help="poison-job quarantine: list / inspect / release fingerprints "
        "a live daemon (--socket) or a dead one's --state-dir holds",
    )
    qsub = qp.add_subparsers(dest="quarantine_cmd", required=True)

    def _quarantine_common(p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "-socket",
            "--socket",
            default=None,
            help="a running daemon: unix-socket path, or HOST:PORT for "
            "the authenticated TCP transport (needs --secret-file or "
            "VERIFYD_SECRET)",
        )
        p.add_argument(
            "--state-dir",
            default=None,
            help="cold path: read the quarantine ledger straight from a "
            "state dir (release this way only with the daemon stopped)",
        )
        p.add_argument(
            "--secret-file",
            default=None,
            help="shared-secret file for the TCP transport",
        )
        p.set_defaults(fn=_cmd_quarantine)

    ql = qsub.add_parser("list", help="show quarantined fingerprints")
    _quarantine_common(ql)
    qi = qsub.add_parser(
        "inspect", help="full crash ledger for one fingerprint"
    )
    qi.add_argument("fingerprint", help="fingerprint to inspect")
    _quarantine_common(qi)
    qr = qsub.add_parser(
        "release",
        help="operator override: un-quarantine a fingerprint and reset "
        "its crash count (the next submit runs it again)",
    )
    qr.add_argument("fingerprint", help="fingerprint to release")
    _quarantine_common(qr)

    pr = sub.add_parser(
        "profiles",
        help="query the durable job-profile archive (live --socket or "
        "cold --state-dir): filter, rank by wall time, export CSV/JSONL",
    )
    pr.add_argument(
        "-socket",
        "--socket",
        default=None,
        help="query a running daemon: unix-socket path, or HOST:PORT for "
        "the authenticated TCP transport (needs --secret-file or "
        "VERIFYD_SECRET)",
    )
    pr.add_argument(
        "--state-dir",
        default=None,
        help="read a (dead) daemon's archive cold from its durable-state "
        "directory — no daemon needed",
    )
    pr.add_argument(
        "--secret-file",
        default=None,
        help="file holding the TCP shared secret (whitespace-stripped); "
        "falls back to the VERIFYD_SECRET environment variable",
    )
    pr.add_argument("--shape", default=None, help="exact shape_key match")
    pr.add_argument(
        "--backend",
        default=None,
        help="backend prefix match (e.g. 'device' matches device-mesh[4])",
    )
    pr.add_argument("--client", default=None, help="exact client identity")
    pr.add_argument(
        "--verdict",
        type=int,
        default=None,
        help="verdict exit code (0 linearizable / 1 illegal / 2 unknown)",
    )
    pr.add_argument(
        "--since",
        type=float,
        default=None,
        metavar="EPOCH_S",
        help="records at or after this epoch-seconds timestamp",
    )
    pr.add_argument(
        "--slowest",
        type=int,
        default=None,
        metavar="N",
        help="N slowest by wall time (overrides --limit)",
    )
    pr.add_argument(
        "--limit",
        type=int,
        default=None,
        metavar="N",
        help="newest N records (default 100 when neither --slowest nor "
        "--limit is given)",
    )
    pr.add_argument(
        "--export",
        default=None,
        metavar="FILE",
        help="write matching records to FILE ('-' = stdout) instead of "
        "the table",
    )
    pr.add_argument(
        "--format",
        default="jsonl",
        choices=["jsonl", "csv"],
        help="--export format (default jsonl)",
    )
    pr.set_defaults(fn=_cmd_profiles)

    li = sub.add_parser(
        "lint",
        help="run verifylint, the domain-aware static-analysis suite "
        "(torch-hygiene, event-schema, metrics-cardinality, concurrency, "
        "protocol-compat), over the port's tree",
    )
    li.add_argument(
        "paths",
        nargs="*",
        help="files/directories to scan (default: the whole package)",
    )
    li.add_argument(
        "--json", action="store_true", help="machine-readable findings + ratchet state"
    )
    li.add_argument(
        "--baseline",
        default=None,
        metavar="PATH",
        help=f"baseline ratchet file (default: <repo>/{LINT_BASELINE})",
    )
    li.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite the baseline from this run's error findings "
        "(full-tree runs only; justify every kept entry)",
    )
    li.add_argument(
        "--changed",
        action="store_true",
        help="scan only git-modified/untracked package files (sub-second "
        "incremental gate)",
    )
    li.add_argument(
        "--events-md",
        default=None,
        metavar="PATH",
        help="render the event-schema registry as markdown to PATH "
        "('-' = stdout) and exit",
    )
    li.add_argument(
        "--check-events-md",
        action="store_true",
        help=f"fail if the committed {LINT_EVENTS_MD} is stale",
    )
    li.add_argument(
        "--no-cache", action="store_true", help="ignore and skip the per-file cache"
    )
    li.set_defaults(fn=_cmd_lint)

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
    if args.cmd == "check":
        return _cmd_check(args, on_result=on_result)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
