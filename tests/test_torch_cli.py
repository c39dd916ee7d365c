"""Port parity: the ``check`` command, held against the JAX package's CLI.

- every backend (``oracle``, ``native``, ``frontier``, ``device``, the
  default ``auto``) on the same files through both CLIs: the exit codes and
  the ``-stats`` fields both print;
- the ``auto`` ladder's rungs with the CPU rung stubbed (as the JAX
  package's own tests stub it): escalation to the device search, the
  unbounded CPU run after a conceded device search, an explicit budget that
  stands, ``-time-budget 0`` that never starts the device search, the
  Python-oracle fallback for a native engine that cannot be built, and
  ``-backend=native`` without one (exit 64);
- corpus mode: one line per file and the worst exit code, as the JAX CLI
  prints them, an empty glob (64), and ``-checkpoint``/``-profile`` ignored;
- the artifacts: ``-out-dir`` gets the JAX CLI's HTML byte for byte, and
  ``-no-viz`` writes none; ``-profile`` with the native engine carries its
  phases as the JAX CLI's does;
- the operator commands against a live port daemon (the cases of
  ``tests/test_cli.py`` and ``tests/test_obs_v3.py``): ``trace`` exports
  the span ring (exit 69 with no daemon), one ``dash`` frame a poll, and
  ``watch`` on a live job, as JSON frames and as the board.
"""

import json
import logging
import os
import time

import pytest

from s2_verification_tpu import cli as jcli
from s2_verification_tpu.collector.campaign import builtin_campaigns, collect_labeled
from s2_verification_tpu_torch import cli as pcli
from s2_verification_tpu_torch.checker import native as pna
from s2_verification_tpu_torch.checker.oracle import CheckOutcome, CheckResult

from test_torch_device import jax_adversarial
from test_torch_encode import collected, jax_text

SHARED = ("outcome", "backend", "ops", "witness", "layers", "max_frontier", "expanded", "auto_closed", "pruned",
          "steps")


def _write(directory, name, events):
    path = directory / name
    path.write_text(jax_text(events))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("histories")
    return {
        "ok-collected": _write(d, "ok.jsonl", collected("match-seq-num")),
        "illegal-reorder": _write(d, "reorder.jsonl", collect_labeled(builtin_campaigns()["reorder"], seed=11)[0]),
        "ok-adv5": _write(d, "adv5.jsonl", jax_adversarial(5, batch=3, seed=5)),
        "illegal-adv5": _write(d, "adv5u.jsonl", jax_adversarial(5, batch=3, seed=5, unsatisfiable=True)),
    }


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, out


def _both(files, name, args, capsys):
    path = files[name]
    rc_j, out_j = _run(jcli.main, ["check", f"-file={path}", "-no-viz", "-stats", *args], capsys)
    rc_p, out_p = _run(pcli.main, ["check", f"-file={path}", "-no-viz", "-stats", "-device", "cpu", *args], capsys)
    return (rc_j, json.loads(out_j[-1])), (rc_p, json.loads(out_p[-1]))


CASES = [(b, n) for b in ("oracle", "native", "frontier", "auto") for n in ("ok-collected", "illegal-reorder",
                                                                              "ok-adv5", "illegal-adv5")]
CASES += [("device", "ok-adv5"), ("device", "illegal-adv5")]


@pytest.mark.parametrize("backend,name", CASES, ids=[f"{b}-{n}" for b, n in CASES])
def test_backends_exit_and_stats_equal_jax(files, capsys, backend, name):
    args = [] if backend == "auto" else [f"-backend={backend}"]
    (rc_j, line_j), (rc_p, line_p) = _both(files, name, args, capsys)
    assert rc_p == rc_j == (0 if name.startswith("ok") else 1)
    for f in SHARED:
        assert line_p.get(f) == line_j.get(f), f
    assert line_p["backend"] == (backend if args else "auto")
    # host_syncs and the device are the port's own keys, where the device
    # search decided
    assert ("host_syncs" in line_p) == (backend == "device")


def test_check_defaults_equal_jax():
    keys = ("backend", "out_dir", "no_viz", "time_budget")
    args = pcli.build_parser().parse_args(["check", "-file=x"])
    jargs = jcli.build_parser().parse_args(["check", "-file=x"])
    assert [getattr(args, k) for k in keys] == [getattr(jargs, k) for k in keys]
    assert args.backend == "auto"


def _stub_cpu(monkeypatch, budgeted, unbounded=None):
    """``_cpu_check`` answering ``budgeted`` under a budget and running the
    real engine (or answering ``unbounded``) without one; returns the
    budgets it saw."""
    real = pcli._cpu_check
    seen = []

    def cpu(hist, budget, **kw):
        seen.append(budget)
        if budget is not None:
            return CheckResult(budgeted)
        return real(hist, None, **kw) if unbounded is None else CheckResult(unbounded)

    monkeypatch.setattr(pcli, "_cpu_check", cpu)
    return seen


def _stub_device(monkeypatch, outcome=None):
    """Count device searches; answer ``outcome`` or run the real one."""
    real = pcli.check_device_auto
    calls = []

    def dev(hist, **kw):
        calls.append(kw)
        return real(hist, **kw) if outcome is None else CheckResult(outcome)

    monkeypatch.setattr(pcli, "check_device_auto", dev)
    return calls


def test_ladder_escalates_to_the_device(files, monkeypatch):
    seen = _stub_cpu(monkeypatch, CheckOutcome.UNKNOWN)
    calls = _stub_device(monkeypatch)
    assert pcli.main(["check", f"-file={files['ok-adv5']}", "-device", "cpu", "-no-viz"]) == 0
    assert seen == [10.0] and len(calls) == 1 and calls[0]["device"] == "cpu"


def test_ladder_closes_with_an_unbounded_cpu_run(files, monkeypatch):
    seen = _stub_cpu(monkeypatch, CheckOutcome.UNKNOWN)
    calls = _stub_device(monkeypatch, CheckOutcome.UNKNOWN)
    assert pcli.main(["check", f"-file={files['illegal-reorder']}", "-device", "cpu", "-no-viz"]) == 1
    assert seen == [10.0, None] and len(calls) == 1


def test_ladder_keeps_an_explicit_budget(files, monkeypatch):
    seen = _stub_cpu(monkeypatch, CheckOutcome.UNKNOWN, unbounded=CheckOutcome.OK)
    calls = _stub_device(monkeypatch, CheckOutcome.UNKNOWN)
    rc = pcli.main(["check", f"-file={files['ok-adv5']}", "-device", "cpu", "-no-viz", "-time-budget", "5"])
    assert rc == 2 and seen == [5.0] and len(calls) == 1


def test_time_budget_zero_never_starts_the_device(files, monkeypatch, caplog):
    calls = _stub_device(monkeypatch, CheckOutcome.UNKNOWN)
    with caplog.at_level(logging.WARNING):
        rc = pcli.main(["check", f"-file={files['ok-collected']}", "-no-viz", "-time-budget", "0",
                        "-checkpoint", "x.ck", "-device-rows", "8"])
    assert rc == 0 and not calls
    msgs = [r.getMessage() for r in caplog.records]
    assert any("-checkpoint only applies" in m and "auto (unbounded CPU)" in m for m in msgs)
    assert any("-device-rows only applies" in m for m in msgs)


def test_unbuildable_native_engine(files, monkeypatch, caplog):
    def unavailable():
        raise pna.NativeUnavailable("no compiler here")

    monkeypatch.setattr(pna, "_load", unavailable)
    calls = _stub_device(monkeypatch)
    # auto: the Python oracle takes the CPU rung, as in the JAX package
    assert pcli.main(["check", f"-file={files['illegal-reorder']}", "-no-viz"]) == 1
    assert not calls
    with caplog.at_level(logging.ERROR):
        assert pcli.main(["check", f"-file={files['ok-collected']}", "-backend=native", "-no-viz"]) == 64
    assert any("native backend unavailable" in r.getMessage() for r in caplog.records)


def test_corpus_mode_equals_jax(files, tmp_path, capsys, caplog):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name in ("ok-collected", "illegal-reorder", "ok-adv5"):
        (corpus / os.path.basename(files[name])).write_text(open(files[name]).read())
    (corpus / "broken.jsonl").write_text('{"event": {"Start": "Nope"}, "client_id": 1, "op_id": 0}\n')
    (corpus / "notes.txt").write_text("not a history")
    for target in (str(corpus), str(corpus / "*.jsonl")):
        rc_j, out_j = _run(jcli.main, ["check", f"-file={target}", "-no-viz", "-backend=native"], capsys)
        with caplog.at_level(logging.WARNING):
            rc_p, out_p = _run(pcli.main, ["check", f"-file={target}", "-no-viz", "-checkpoint", "c.ck",
                                           "-profile", str(tmp_path / "p.json")], capsys)
        assert rc_p == rc_j == 1
        assert out_p == out_j
        assert [line.rsplit(": ", 1)[1] for line in out_p] == ["OK", "ERROR", "OK", "ILLEGAL"]
    msgs = [r.getMessage() for r in caplog.records]
    assert "-checkpoint is ignored in corpus mode" in msgs and "--profile is ignored in corpus mode" in msgs
    assert not (tmp_path / "p.json").exists()
    (corpus / "reorder.jsonl").unlink()
    assert _run(pcli.main, ["check", f"-file={corpus}", "-no-viz"], capsys)[0] == 64  # the unreadable file
    assert pcli.main(["check", f"-file={tmp_path / 'none' / '*.jsonl'}", "-no-viz"]) == 64


@pytest.mark.parametrize("name", ["ok-collected", "illegal-reorder"])
def test_out_dir_html_equals_jax(files, tmp_path, capsys, name):
    out = {}
    for who, main in (("jax", jcli.main), ("port", pcli.main)):
        d = tmp_path / who
        rc = main(["check", f"-file={files[name]}", "-backend=oracle", "-out-dir", str(d)])
        capsys.readouterr()
        (html,) = list(d.iterdir())
        assert html.name.startswith(os.path.basename(files[name]) + "-") and html.suffix == ".html"
        out[who] = (rc, html.read_bytes())
    assert out["port"] == out["jax"]
    if name.startswith("illegal"):
        assert b"refusing to linearize" in out["port"][1]
    nothing = tmp_path / "none"
    assert pcli.main(["check", f"-file={files[name]}", "-backend=oracle", "-no-viz", "-out-dir", str(nothing)]) in (0, 1)
    assert not nothing.exists()


def test_native_profile_has_the_jax_schema(files, tmp_path, capsys):
    prof = {}
    for who, main in (("jax", jcli.main), ("port", pcli.main)):
        path = tmp_path / f"{who}.json"
        assert main(["check", f"-file={files['ok-adv5']}", "-backend=native", "-no-viz", f"-profile={path}"]) == 0
        prof[who] = json.loads(path.read_text())
    assert set(prof["port"]) == set(prof["jax"])
    assert set(prof["port"]["phases"]) == set(prof["jax"]["phases"]) == {"encode_s", "search_s", "steps", "cache_hits"}
    for k in ("steps", "cache_hits", "outcome", "backend", "ops"):
        assert prof["port"][k] == prof["jax"][k], k


# -- the operator commands: trace, dash and watch against a live daemon --------------


def _port_daemon(tmp_path, **kw):
    from s2_verification_tpu_torch.service.daemon import Verifyd, VerifydConfig

    cfg = VerifydConfig(socket_path=str(tmp_path / "v.sock"), out_dir=str(tmp_path / "viz"), no_viz=True,
                        stats_log=None, device="off", **kw)
    return cfg, Verifyd(cfg)


def test_trace_subcommand_unavailable_exit69(tmp_path):
    from s2_verification_tpu_torch.service.protocol import EXIT_UNAVAILABLE

    assert pcli.main(["trace", "-socket", str(tmp_path / "nope.sock"), "-out", "-"]) == EXIT_UNAVAILABLE


def test_trace_subcommand_exports_daemon_spans(files, tmp_path):
    from s2_verification_tpu_torch.service.client import VerifydClient

    from test_torch_service import time_limit

    cfg, daemon = _port_daemon(tmp_path)
    with time_limit(60), daemon:
        with open(files["ok-collected"], encoding="utf-8") as f:
            VerifydClient(cfg.socket_path).submit(f.read(), client="cli-test")
        out = tmp_path / "trace.json"
        assert pcli.main(["trace", "-socket", cfg.socket_path, "-out", str(out)]) == 0
        trace = json.loads(out.read_text(encoding="utf-8"))
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"admit", "search"} <= names
        # The JAX package's trace command reads the port's daemon alike.
        assert jcli.main(["trace", "-socket", cfg.socket_path, "-out", str(tmp_path / "j.json")]) == 0


def test_dash_frame_over_a_live_daemon(files, tmp_path, capsys):
    from s2_verification_tpu_torch.service.client import VerifydClient

    from test_torch_service import time_limit

    cfg, daemon = _port_daemon(tmp_path, metrics_port=0, resource_sample_s=0.1, dashboard_sample_s=0.1)
    with time_limit(60), daemon:
        with open(files["ok-collected"], encoding="utf-8") as f:
            assert VerifydClient(cfg.socket_path).submit(f.read(), client="v3")["verdict"] == 0
        capsys.readouterr()
        rc = pcli.main(["dash", "--socket", cfg.socket_path, "--iterations", "2", "--interval", "0.1"])
        out = capsys.readouterr().out
    assert rc == 0
    assert out.count("verifyd dash") == 2 and "completed=1" in out
    assert "throughput" in out and "rss" in out


def test_watch_through_the_cli_on_a_live_job(tmp_path, capsys, monkeypatch):
    import threading

    from s2_verification_tpu_torch.service import scheduler
    from s2_verification_tpu_torch.service.client import VerifydClient

    from test_torch_service import _slow_engine, good_history, port_pkg, time_limit

    monkeypatch.setattr(scheduler, "_cpu_check", _slow_engine(port_pkg, total=60, step_s=0.02))
    cfg, daemon = _port_daemon(tmp_path, progress_interval_s=0.05)
    with time_limit(60), daemon:
        reply: dict = {}
        t = threading.Thread(target=lambda: reply.update(VerifydClient(cfg.socket_path).submit(good_history())))
        t.start()
        client = VerifydClient(cfg.socket_path)
        while not client.watch().get("progress"):
            time.sleep(0.01)
        capsys.readouterr()
        rc = pcli.main(["watch", "-socket", cfg.socket_path, "--json", "--interval", "0.1", "--iterations", "3"])
        frames = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.strip()]
        board = pcli.main(["watch", "-socket", cfg.socket_path, "--job", "1", "--iterations", "1"])
        text = capsys.readouterr().out
        t.join()
    assert rc == 0 and board == 0 and reply["verdict"] == 0
    rows = [r for f in frames for r in f["progress"]]
    assert len(frames) == 3 and rows and {r["job"] for r in rows} == {1}
    ops = [r["ops_committed"] for r in rows]
    assert ops == sorted(ops)
    assert "verifyd watch" in text and "job=1" in text
    assert pcli.main(["watch", "-socket", str(tmp_path / "nope.sock"), "--iterations", "1"]) == 69
