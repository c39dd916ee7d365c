"""The port stands alone: no JAX, no JAX package, no ``xxhash``, no silent
CPU fallback.

- importing every port module (in a fresh interpreter) leaves ``jax``,
  ``xxhash`` and every ``s2_verification_tpu`` module out of
  ``sys.modules``, and so do a small ``collect_history`` run, a launch
  of batched lanes and a search sharded over a mesh;
- the supervising side of the device escalation (``checker.resilient``,
  ``service``, ``obs``) leaves ``torch`` out of ``sys.modules`` too, and so
  does a daemon under ``device="off"`` or ``"supervised"`` that answers
  submits (the supervised one through a real escalation), one with
  native batching and the prefix store that answers a burst and a follow
  window, and ``route serve`` over two daemons answering a routed, a
  distributed and a soaked submit, ``route fleet`` and ``route drain``,
  and ``lint`` and ``lint --check-events-md``;
- no port source (nor chip_smoke.py) imports them;
- the entry points refuse to run when CUDA is asked for and absent, and
  so does the CLI's ``auto`` ladder when it escalates (exit 64, never a
  CPU run in the card's place);
- the native engine builds from the port's own source alone;
- the CLI's exit codes (0 / 1 / 64) with ``-device cpu``;
- chip_smoke.py exits nonzero without a GPU and prints no result.
"""

import ast
import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from s2_verification_tpu_torch import cli
from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, CheckResult
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.utils import events as ev

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "s2_verification_tpu_torch"


def _modules() -> list[str]:
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


FORBIDDEN = ("jax", "jaxlib", "s2_verification_tpu", "xxhash")


def _is_jax_name(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _fresh_interpreter(body: str) -> subprocess.CompletedProcess:
    """Run ``body`` in a new interpreter that sees only the repo, and fail
    (exit 1) if it loaded any forbidden module."""
    code = (
        "import importlib, sys\n"
        + body
        + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )


def test_importing_the_port_loads_no_jax():
    mods = _modules()
    for m in (
        "checker.batched",
        "checker.device",
        "checker.diagnostics",
        "checker.frontier",
        "checker.native",
        "checker.prune",
        "checker.progress",
        "checker.profile",
        "collector.collect",
        "parallel",
        "parallel.distributed",
        "collector.campaign",
        "collector.socket_s2",
        "viz",
        "checker.resilient",
        "obs",
        "obs.context",
        "obs.trace",
        "obs.metrics",
        "obs.introspect",
        "service",
        "service.stats",
        "service.devicepool",
        "service.scheduler",
        "service.supervise",
        "version",
        "utils.seglog",
        "obs.log",
        "obs.health",
        "obs.sentinel",
        "service.protocol",
        "service.overload",
        "service.queue",
        "service.cache",
        "service.progress",
        "service.fastprep",
        "service.client",
        "service.daemon",
        "service.journal",
        "obs.flight",
        "obs.archive",
        "obs.tsdb",
        "obs.alerts",
        "obs.httpd",
        "obs.dashboard",
        "checker.prefix",
        "service.prefixstore",
        "service.batcher",
        "obs.probe",
        "obs.federate",
        "service.router",
        "service.distsearch",
        "service.chaosproxy",
        "service.soak",
        "analysis",
        "analysis.engine",
        "analysis.torch_hygiene",
        "analysis.event_schema",
        "analysis.protocol_compat",
        "analysis.concurrency",
        "analysis.metrics_cardinality",
    ):
        assert f"s2_verification_tpu_torch.{m}" in mods
    proc = _fresh_interpreter(f"for m in {mods!r}:\n    importlib.import_module(m)\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_supervising_side_loads_no_torch():
    # The supervising process never holds a CUDA context: the bounded-child loop, the
    # supervisor, the pool, the scheduler's key, the stats and the obs
    # modules import neither torch nor jax (only the supervised child does).
    proc = _fresh_interpreter(
        "for m in ('checker.resilient', 'service', 'service.supervise', 'obs'):\n"
        "    importlib.import_module('s2_verification_tpu_torch.' + m)\n"
        "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if m.startswith('torch'))\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_daemon_loads_no_torch_unless_it_escalates_inline(tmp_path):
    # A device-off daemon and a supervised one answer submits — the
    # supervised one through a real escalation whose child runs the search
    # on the CPU — with their durable state, metrics listener and
    # telemetry on, and the daemon's own process never loads torch; the
    # CLI's serve, submit and cold doctor entry points don't either.
    sock = tmp_path / "v.sock"
    proc = _fresh_interpreter(
        "import io\n"
        "from s2_verification_tpu_torch import cli\n"
        "from s2_verification_tpu_torch.checker.oracle import CheckOutcome, CheckResult\n"
        "from s2_verification_tpu_torch.collector.adversarial import adversarial_events\n"
        "from s2_verification_tpu_torch.service import scheduler\n"
        "from s2_verification_tpu_torch.service.client import VerifydClient\n"
        "from s2_verification_tpu_torch.service.daemon import Verifyd, VerifydConfig\n"
        "from s2_verification_tpu_torch.utils import events as ev\n"
        "buf = io.StringIO()\n"
        "ev.write_history(adversarial_events(5, batch=3, seed=1), buf)\n"
        f"sock = {str(sock)!r}\n"
        "for mode in ('off', 'supervised'):\n"
        "    if mode == 'supervised':\n"
        "        scheduler._cpu_check = lambda h, b, **kw: (CheckResult(CheckOutcome.UNKNOWN), 'native')\n"
        "    cfg = VerifydConfig(socket_path=sock, device=mode, torch_device='cpu', no_viz=True,\n"
        f"                        spool_dir={str(tmp_path / 'spool')!r},\n"
        f"                        state_dir={str(tmp_path / 'state')!r} + mode, metrics_port=0)\n"
        "    with Verifyd(cfg):\n"
        "        r = VerifydClient(sock, timeout=120).submit(buf.getvalue())\n"
        "    assert r['verdict'] == 0, r\n"
        "    assert r['backend'] == ('native' if mode == 'off' else 'device-supervised'), r\n"
        "assert cli.main(['submit', '-file', '/nonexistent.jsonl', '-socket', sock]) == 64\n"
        f"assert cli.main(['doctor', '--state-dir', {str(tmp_path / 'state')!r} + 'off']) == 0\n"
        "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if m.startswith('torch'))\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_native_batching_prefix_daemon_loads_no_torch(tmp_path):
    # ``--batching`` with the auto engine (native, since the C++ engine
    # builds here) and ``--prefix`` under the supervised escalation: a
    # burst runs as one native launch, a follow window is answered,
    # and the daemon's process never loads torch.
    sock = tmp_path / "v.sock"
    proc = _fresh_interpreter(
        "import io, threading, time\n"
        "from s2_verification_tpu_torch.collector.adversarial import adversarial_events\n"
        "from s2_verification_tpu_torch.service.client import VerifydClient\n"
        "from s2_verification_tpu_torch.service.daemon import Verifyd, VerifydConfig\n"
        "from s2_verification_tpu_torch.utils import events as ev\n"
        "texts = []\n"
        "for s in range(3):\n"
        "    buf = io.StringIO()\n"
        "    ev.write_history(adversarial_events(3, batch=2, seed=s), buf)\n"
        "    texts.append(buf.getvalue())\n"
        f"sock = {str(sock)!r}\n"
        "cfg = VerifydConfig(socket_path=sock, device='supervised', workers=0, no_viz=True, batching=True,\n"
        "                    prefix_enabled=True, prefix_min_ops=1000,\n"
        f"                    spool_dir={str(tmp_path / 'spool')!r}, state_dir={str(tmp_path / 'state')!r})\n"
        "with Verifyd(cfg) as d:\n"
        "    c = VerifydClient(sock, timeout=120)\n"
        "    replies = []\n"
        "    ths = [threading.Thread(target=lambda t=t: replies.append(c.submit(t, no_viz=True))) for t in texts]\n"
        "    [t.start() for t in ths]\n"
        "    while len(d.queue) < 3:\n"
        "        time.sleep(0.01)\n"
        "    d.scheduler.start(1)\n"
        "    [t.join() for t in ths]\n"
        "    w = c.follow(texts[0], stream='s')\n"
        "    launches = c.stats()['batch_launches']\n"
        "assert sorted(r['backend'] for r in replies) == ['batch-native'] * 3, replies\n"
        "assert launches == 1 and (w['verdict'], w['scope']) == (0, 'window'), (launches, w)\n"
        "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if m.startswith('torch'))\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_route_serve_loads_no_torch(tmp_path):
    # The router tier: ``route serve`` (the CLI entry point) over two
    # device-off daemons answers a routed submit, a distributed
    # search and a soak, and ``route fleet`` / ``route drain`` answer;
    # the process never loads torch.
    rsock = tmp_path / "r.sock"
    proc = _fresh_interpreter(
        "import io, os, threading, time\n"
        "from s2_verification_tpu_torch import cli\n"
        "from s2_verification_tpu_torch.collector.adversarial import adversarial_events\n"
        "from s2_verification_tpu_torch.service.client import VerifydClient\n"
        "from s2_verification_tpu_torch.service.daemon import Verifyd, VerifydConfig\n"
        "from s2_verification_tpu_torch.service.soak import SoakConfig, SoakRunner, soak_exit_code\n"
        "from s2_verification_tpu_torch.utils import events as ev\n"
        f"tmp, rsock = {str(tmp_path)!r}, {str(rsock)!r}\n"
        "ds = [Verifyd(VerifydConfig(socket_path=f'{tmp}/{n}.sock', device='off', no_viz=True,\n"
        "                            out_dir=f'{tmp}/viz')).__enter__() for n in 'ab']\n"
        "said = []\n"
        "def drive():\n"
        "    while not os.path.exists(rsock):\n"
        "        time.sleep(0.05)\n"
        "    try:\n"
        "        buf = io.StringIO()\n"
        "        ev.write_history(adversarial_events(4, batch=3, seed=1), buf)\n"
        "        c = VerifydClient(rsock, timeout=120)\n"
        "        said.append(c.submit(buf.getvalue(), no_viz=True)['verdict'])\n"
        "        said.append(c.submit(buf.getvalue() + ' ', no_viz=True, distributed=True)['verdict'])\n"
        "        s = SoakRunner(SoakConfig(address=rsock, campaigns=('steady', 'drop-acked'), seed=11)).run()\n"
        "        said.append(soak_exit_code(s))\n"
        "        said.append(cli.main(['route', 'fleet', '-socket', rsock]))\n"
        "        said.append(cli.main(['route', 'drain', 'a', '-socket', rsock]))\n"
        "    finally:\n"
        "        VerifydClient(rsock, timeout=60).shutdown()\n"
        "th = threading.Thread(target=drive)\n"
        "th.start()\n"
        "rc = cli.main(['route', 'serve', '--listen', rsock, '--backend', f'a={tmp}/a.sock',\n"
        "               '--backend', f'b={tmp}/b.sock', '--state-dir', f'{tmp}/rs', '--metrics-port', '0'])\n"
        "th.join(timeout=60)\n"
        "assert (rc, said) == (0, [0, 0, 0, 0, 0]), (rc, said)\n"
        "for d in ds:\n"
        "    d.__exit__(None, None, None)\n"
        "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if m.startswith('torch'))\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lint_loads_no_torch(tmp_path):
    # ``lint`` (the full tree against the port's baseline) and ``lint
    # --check-events-md`` through the CLI; the cache goes to tmp_path.
    proc = _fresh_interpreter(
        "from s2_verification_tpu_torch import cli\n"
        f"cli.LINT_CACHE = {str(tmp_path / 'cache.json')!r}\n"
        "assert cli.main(['lint']) == 0\n"
        "assert cli.main(['lint', '--check-events-md']) == 0\n"
        "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if m.startswith('torch'))\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "cache.json").exists()


def test_collecting_loads_no_xxhash_and_no_jax():
    proc = _fresh_interpreter(
        "from s2_verification_tpu_torch.collector.collect import CollectConfig, collect_history\n"
        "from s2_verification_tpu_torch.checker.oracle import check_events\n"
        "events = collect_history(CollectConfig(3, 20, 'match-seq-num', seed=1))\n"
        "assert len(events) > 40 and check_events(events).ok\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_mesh_search_loads_no_jax():
    proc = _fresh_interpreter(
        "from s2_verification_tpu_torch.checker.device import check_device\n"
        "from s2_verification_tpu_torch.checker.entries import prepare\n"
        "from s2_verification_tpu_torch.collector.adversarial import adversarial_events\n"
        "from s2_verification_tpu_torch.parallel import frontier_mesh\n"
        "res = check_device(prepare(adversarial_events(4, batch=2, seed=1)), beam=False, collect_stats=True,\n"
        "                   mesh=frontier_mesh(devices=['cpu'] * 4))\n"
        "assert res.outcome.value == 'ok' and len(res.stats.shards) == 4, res\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_batched_lanes_load_no_jax():
    proc = _fresh_interpreter(
        "from s2_verification_tpu_torch.checker.batched import BatchLane, check_batch_native, check_batch_vmap\n"
        "from s2_verification_tpu_torch.checker.entries import prepare\n"
        "from s2_verification_tpu_torch.collector.adversarial import adversarial_events\n"
        "from s2_verification_tpu_torch.models.encode import encode_batch\n"
        "hists = [prepare(adversarial_events(4, batch=2, seed=s, unsatisfiable=s == 1)) for s in range(3)]\n"
        "lanes = [BatchLane(h, e) for h, e in zip(hists, encode_batch(hists))]\n"
        "got = [v.result.outcome.value for v in check_batch_vmap(lanes, capacity=1024, device='cpu')]\n"
        "assert got == ['ok', 'illegal', 'ok'], got\n"
        "assert [v.result.outcome.value for v in check_batch_native(lanes)] == got\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_engine_builds_from_the_port_alone(tmp_path):
    # A fresh build, in a fresh interpreter: the library comes from the
    # port's csrc/s2check.cpp, lands in the build directory it is given,
    # decides a history, and neither JAX nor the JAX package's native
    # library directory is touched.
    jax_native = ROOT / "s2_verification_tpu" / "_native"
    before = sorted((p.name, p.stat().st_mtime_ns) for p in jax_native.iterdir()) if jax_native.exists() else []
    proc = _fresh_interpreter(
        "from pathlib import Path\n"
        "from s2_verification_tpu_torch.checker import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "from s2_verification_tpu_torch.checker.entries import prepare\n"
        "from s2_verification_tpu_torch.collector.adversarial import adversarial_events\n"
        "assert native.check_native(prepare(adversarial_events(4, batch=2, seed=0))).ok\n"
        "assert Path(native.BUILD['path']).parent == native.BUILD_DIR and native.BUILD['seconds'] > 0\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
    after = sorted((p.name, p.stat().st_mtime_ns) for p in jax_native.iterdir()) if jax_native.exists() else []
    assert after == before


@pytest.mark.parametrize(
    "path",
    [str(p.relative_to(ROOT)) for p in sorted(PKG.rglob("*.py"))] + ["chip_smoke.py"],
)
def test_no_source_imports_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_is_jax_name(n) for n in names), (path, node.lineno, names)


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hist = prepare(adversarial_events(3, batch=2, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        pdev.check_device(hist)
    with pytest.raises(RuntimeError, match="CUDA"):
        pdev.check_device_auto(hist)
    with pytest.raises(RuntimeError, match="CUDA"):
        pdev.check_device(hist, device="cuda")
    assert pdev.check_device(hist, device="cpu").ok


def _write(tmp_path, events, name):
    path = tmp_path / name
    with open(path, "w", encoding="utf-8") as f:
        ev.write_history(events, f)
    return str(path)


@pytest.mark.parametrize(
    "unsat,backend,want",
    [(False, "device", 0), (True, "device", 1), (False, "oracle", 0), (True, "oracle", 1)],
)
def test_cli_verdict_exit_codes(tmp_path, capsys, unsat, backend, want):
    path = _write(tmp_path, adversarial_events(5, batch=3, seed=4, unsatisfiable=unsat), "h.jsonl")
    seen = {}
    rc = cli.main(
        ["check", f"-file={path}", f"-backend={backend}", "-no-viz", "-device", "cpu", "-stats"],
        on_result=lambda p, res, hist: seen.update(res=res),
    )
    assert rc == want
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert ('"outcome": "ok"' if want == 0 else '"outcome": "illegal"') in line
    if want == 0:
        assert seen["res"].linearization is not None


def test_cli_usage_and_parse_errors_exit_64(tmp_path, monkeypatch):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"event": {"Start": "Nope"}, "client_id": 1, "op_id": 0}\n')
    assert cli.main(["check", f"-file={bad}", "-device", "cpu"]) == 64
    assert cli.main(["check", f"-file={tmp_path / 'missing.jsonl'}", "-device", "cpu"]) == 64
    with pytest.raises(SystemExit) as e:
        cli.main(["check", "-file=x", "-backend=bogus"])
    assert e.value.code == 64
    path = _write(tmp_path, adversarial_events(3, batch=2, seed=0), "h.jsonl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["check", f"-file={path}", "-backend=device", "-no-viz"]) == 64  # default -device cuda


def test_cli_auto_escalation_without_a_gpu_exits_64(tmp_path, monkeypatch):
    # The default ladder: the CPU rung concedes, and the device rung, on
    # the default -device cuda, finds no card — exit 64, never a CPU run in
    # the card's place.
    path = _write(tmp_path, adversarial_events(3, batch=2, seed=0), "h.jsonl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    unbounded = []

    def cpu(hist, budget, **kw):
        if budget is None:
            unbounded.append(hist)
        return CheckResult(CheckOutcome.UNKNOWN)

    monkeypatch.setattr(cli, "_cpu_check", cpu)
    assert cli.main(["check", f"-file={path}", "-no-viz"]) == 64
    assert not unbounded


def test_cli_unported_tier_exits_64_and_says_so(tmp_path, capsys, monkeypatch):
    # A search that needs a tier the port lacks is a 64 whose -stats line
    # says "unported" and names it.  Every tier of the JAX engine is ported,
    # so a stub of the device search stands in for one that is not.
    def unported(hist, **kw):
        raise NotImplementedError("the stub tier is not in s2_verification_tpu_torch")

    monkeypatch.setattr(cli, "check_device_auto", unported)
    path = _write(tmp_path, adversarial_events(6, batch=2, seed=3, unsatisfiable=True), "h.jsonl")
    rc = cli.main(["check", f"-file={path}", "-backend=device", "-no-viz", "-device", "cpu", "-stats"])
    assert rc == 64
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"outcome": "unported"' in line and "stub tier" in line


def test_cli_decides_past_the_bucket_through_the_spill_like_jax(tmp_path, capsys, monkeypatch):
    # Caps small enough that the exhaustive phase outgrows its bucket; on
    # the CPU the device-resident tier is off by default, so both CLIs go on
    # in the host-RAM spill and exit 1 (ILLEGAL) with the same statistics.
    jcli = importlib.import_module("s2_verification_tpu.cli")
    jdev = importlib.import_module("s2_verification_tpu.checker.device")
    path = _write(tmp_path, adversarial_events(6, batch=2, seed=3, unsatisfiable=True), "h.jsonl")
    lines = {}
    for main, mod, args in (
        (jcli.main, jdev, ["-backend=device", "-no-viz"]),
        (cli.main, cli, ["-backend=device", "-no-viz", "-device", "cpu"]),
    ):
        real = mod.check_device_auto
        with monkeypatch.context() as m:
            m.setattr(mod, "check_device_auto",
                      lambda hist, real=real, **kw: real(hist, beam_width=32, exhaustive_cap=64, **kw))
            rc = main(["check", f"-file={path}", "-stats", *args])
        lines[main] = (rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    (rc_j, line_j), (rc_p, line_p) = lines[jcli.main], lines[cli.main]
    assert rc_p == rc_j == 1
    for f in ("outcome", "layers", "max_frontier", "expanded", "auto_closed", "pruned"):
        assert line_p[f] == line_j[f], f


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the no-GPU refusal is not reachable")
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", lone / "chip_smoke.py")
    for cwd in (ROOT, lone):
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
            timeout=120,
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
