"""Crash-resilience of long device runs in the port (checker/resilient.py).

The port's copy of ``tests/test_resilient.py``: the six unit tests drive
fake children through the crash / hang / success shapes over
``s2_verification_tpu_torch.checker.resilient.drive``; the probe test runs
the port's real probe child (``default_probe_cmd(device="cpu")``); and the
integration test kills a real supervised child (``service/supervise.py``,
``device=cpu``) with SIGKILL after its second checkpoint save — through
``chip_smoke.py``'s wrapper script, as the card's phase 14 does — and
requires the relaunch to resume from that checkpoint to OK in exactly two
attempts, leaving no snapshot behind.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import sys
import textwrap

import torch

from s2_verification_tpu_torch.checker.device import check_device_auto
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.checker.resilient import DriveOutcome, default_probe_cmd, drive
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.utils import events as ev

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: Thread budget.  Each pytest-xdist worker, and each child it spawns
#: (through ``OMP_NUM_THREADS``), gets an intra-op pool sized to its share
#: of the cores.  A pool as wide as the machine in every worker
#: oversubscribes the host: torch's OpenMP threads spin-wait for their
#: siblings, and a CPU search that takes seconds alone runs past the
#: limits here.  Collection imports this module in every worker, and a
#: run without xdist keeps the full pool.
_THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
os.environ.setdefault("OMP_NUM_THREADS", str(_THREADS))
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script(tmp_path, body: str) -> list[str]:
    p = tmp_path / "child.py"
    p.write_text(textwrap.dedent(body))
    return [sys.executable, str(p)]


def _crash_once(tmp_path, marker, result) -> list[str]:
    return _script(
        tmp_path,
        f"""
        import os, signal
        if not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").close()   # "checkpoint"
            os.kill(os.getpid(), signal.SIGKILL)
        open({str(result)!r}, "w").close()
        """,
    )


def test_drive_crash_once_then_resume(tmp_path):
    """First attempt dies before writing the result; second concludes."""
    marker = tmp_path / "progress"
    result = tmp_path / "result"
    cmd = _crash_once(tmp_path, marker, result)
    out = drive(cmd, done=result.exists, attempt_timeout_s=60, probe_cmd=None)
    assert out == DriveOutcome(True, 2, 0, "conclusive")


def test_drive_hang_is_killed_then_resume(tmp_path):
    """A mid-run hang is bounded by the attempt timeout."""
    marker = tmp_path / "progress"
    result = tmp_path / "result"
    cmd = _script(
        tmp_path,
        f"""
        import os, time
        if not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").close()
            time.sleep(3600)
        open({str(result)!r}, "w").close()
        """,
    )
    # Big enough that interpreter startup on a loaded machine cannot kill
    # the child before its marker, small enough not to dominate the suite.
    out = drive(cmd, done=result.exists, attempt_timeout_s=10, probe_cmd=None)
    assert out.ok and out.attempts == 2 and out.last_rc == 0


def test_drive_restart_budget_exhausted(tmp_path):
    """A child that always dies fails conclusively, never loops forever."""
    result = tmp_path / "result"
    cmd = _script(tmp_path, "raise SystemExit(3)")
    out = drive(cmd, done=result.exists, attempt_timeout_s=60, max_restarts=2, probe_cmd=None)
    assert not out.ok and out.attempts == 3 and out.last_rc == 3
    assert out.note == "restart budget exhausted"


def test_drive_zero_exit_without_result_is_a_failed_attempt(tmp_path):
    """rc 0 is not success — only done() is."""
    result = tmp_path / "result"
    cmd = _script(tmp_path, "pass")
    out = drive(cmd, done=result.exists, attempt_timeout_s=60, max_restarts=1, probe_cmd=None)
    assert not out.ok and out.attempts == 2


def test_drive_probe_gates_relaunch(tmp_path):
    """Between attempts the backend probe must answer before relaunch; a
    probe that never answers fails the drive with its own note."""
    result = tmp_path / "result"
    cmd = _script(tmp_path, "raise SystemExit(1)")
    out = drive(
        cmd,
        done=result.exists,
        attempt_timeout_s=60,
        max_restarts=3,
        probe_cmd=[sys.executable, "-c", "raise SystemExit(1)"],
        probe_interval_s=0.01,
        max_probes=2,
    )
    assert not out.ok and out.attempts == 1
    assert out.note == "backend never answered between attempts"


def test_default_probe_cmd_gates_and_passes_on_cpu(tmp_path):
    """The real probe child, told ``device="cpu"``, answers, so a relaunch
    is gated on a live backend, not a fake."""
    marker = tmp_path / "progress"
    result = tmp_path / "result"
    cmd = _crash_once(tmp_path, marker, result)
    out = drive(
        cmd,
        done=result.exists,
        attempt_timeout_s=60,
        probe_cmd=default_probe_cmd(device="cpu"),
        probe_timeout_s=120,
        probe_interval_s=0.01,
        max_probes=2,
    )
    assert out == DriveOutcome(True, 2, 0, "conclusive")


def test_supervised_child_resumes_through_a_kill_after_its_second_save(tmp_path, monkeypatch):
    """End to end: the supervised child (adversarial k=7 on the CPU) is
    SIGKILLed right after its second checkpoint save, and the relaunch
    resumes from that snapshot to OK in exactly two attempts; the
    conclusive run removes its snapshot.  The counts equal an uninterrupted
    run's, with fewer host syncs: the relaunch did not start over."""
    smoke = _chip_smoke()
    hist_path, ckpt, out_path = tmp_path / "h.jsonl", tmp_path / "job.ckpt.npz", tmp_path / "out.json"
    marker = tmp_path / "killed"
    events = adversarial_events(7, batch=100, seed=0)
    with open(hist_path, "w", encoding="utf-8") as f:
        ev.write_history(events, f)
    wrapper = tmp_path / "crash_after_saves.py"
    wrapper.write_text(smoke.CRASH_AFTER_SAVES)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    cmd = [sys.executable, str(wrapper), str(marker), "2", "2",
           str(hist_path), str(ckpt), str(out_path), "device=cpu", "profile=1"]
    said = []
    out = drive(cmd, done=out_path.exists, attempt_timeout_s=300, max_restarts=2, probe_cmd=None,
                log=said.append)
    assert out == DriveOutcome(True, 2, 0, "conclusive"), said
    assert marker.exists()
    res = json.loads(out_path.read_text())
    assert res["outcome"] == "ok" and res["linearization"]
    assert not [p.name for p in tmp_path.iterdir() if p.name.startswith(ckpt.name)]
    whole = check_device_auto(prepare(events), device="cpu", checkpoint_path=str(tmp_path / "whole.npz"),
                              checkpoint_every=2, profile=True)
    assert res["steps"] == whole.steps
    for f in ("layers", "max_frontier", "expanded", "auto_closed", "pruned"):
        assert res["stats"][f] == getattr(whole.stats, f), f
    assert whole.stats.layers > 2
    assert 0 < res["stats"]["host_syncs"] < whole.stats.host_syncs
