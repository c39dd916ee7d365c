"""The closed-loop soak in the port (``service/soak.py``) beside the JAX
package's.

- The cases of ``tests/test_soak.py``, run over both packages against
  that package's daemon: scoring every label, the seeded schedule, the
  exit-code taxonomy, a lost submit, the mislabeled control (the
  ``checker_false_verdict`` webhook, the flight marker, the saved
  history), the repro command, and adversarial histories through submit.
  The full builtin matrix stays ``slow``, as in the JAX package.
- Side by side: the same schedule scores the same rows (campaign, seed,
  label, fingerprint, verdict) in each package, and through the port's
  router both packages' runners score the fleet alike.
- The ``soak`` command: ``python -m s2_verification_tpu_torch soak``
  over the port's router exits 0 on a clean run, and 1 with
  ``--mislabel-control``, whose ``checker_false_verdict`` webhook reaches
  a receiver; its flags and defaults are the JAX command's.
"""

from __future__ import annotations

import contextlib
import http.server
import importlib
import io
import json
import os
import threading
from types import SimpleNamespace

import pytest

from test_torch_service import time_limit

JAX, PORT = "s2_verification_tpu", "s2_verification_tpu_torch"
PACKAGES = (JAX, PORT)

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    "prepare": ("checker.entries", "prepare"),
    "adversarial_events": ("collector.adversarial", "adversarial_events"),
    "collect_labeled": ("collector.campaign", "collect_labeled"),
    "get_campaign": ("collector.campaign", "get_campaign"),
    "read_flight": ("obs.flight", "read_flight"),
    "history_fingerprint": ("service.cache", "history_fingerprint"),
    "VerifydClient": ("service.client", "VerifydClient"),
    "Verifyd": ("service.daemon", "Verifyd"),
    "VerifydConfig": ("service.daemon", "VerifydConfig"),
    "SoakConfig": ("service.soak", "SoakConfig"),
    "SoakRunner": ("service.soak", "SoakRunner"),
    "repro_command": ("service.soak", "repro_command"),
    "soak_exit_code": ("service.soak", "soak_exit_code"),
    "BackendSpec": ("service.router", "BackendSpec"),
    "RouterConfig": ("service.router", "RouterConfig"),
    "VerifydRouter": ("service.router", "VerifydRouter"),
    "ev": ("utils.events", None),
    "cli": ("cli", None),
}


def names(pkg: str) -> SimpleNamespace:
    """The names of :data:`_NAMES` from package ``pkg``."""
    ns = SimpleNamespace()
    for name, (mod, attr) in _NAMES.items():
        m = importlib.import_module(f"{pkg}.{mod}")
        setattr(ns, name, getattr(m, attr) if attr else m)
    return ns


J, T = names(JAX), names(PORT)


@pytest.fixture(params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    P.__dict__.update(vars(names(request.param)))
    yield request.param


#: a case of ``tests/test_soak.py``, run once for each package
both = pytest.mark.usefixtures("package")


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Each case fails at its limit instead of hanging the run."""
    limit = 600 if request.node.get_closest_marker("slow") else 120
    with time_limit(limit):
        yield


@pytest.fixture(scope="module")
def daemons(tmp_path_factory):
    """One daemon of each package (device off, one worker) for the module."""
    out = {}
    with contextlib.ExitStack() as stack:
        for pkg, ns in ((JAX, J), (PORT, T)):
            tmp = tmp_path_factory.mktemp(f"soak-daemon-{pkg}")
            cfg = ns.VerifydConfig(
                socket_path=str(tmp / "verifyd.sock"),
                workers=1,
                device="off",
                time_budget_s=30.0,
                out_dir=str(tmp / "viz"),
                stats_log=str(tmp / "stats.jsonl"),
            )
            stack.enter_context(ns.Verifyd(cfg))
            out[pkg] = cfg
        yield out


@pytest.fixture
def daemon(daemons, package):
    """The config of the package under test's daemon."""
    return daemons[package]


def _scfg(daemon, ns=None, **kw):
    base = dict(address=daemon.socket_path, seed=11, retries=3, backoff_s=0.05)
    base.update(kw)
    return (ns or P).SoakConfig(**base)


# -- scoring -----------------------------------------------------------------


@both
def test_clean_run_scores_every_label(daemon):
    runner = P.SoakRunner(_scfg(daemon, campaigns=("steady", "drop-acked")))
    summary = runner.run()
    assert P.soak_exit_code(summary) == 0
    assert summary["verdict_table"] == {
        "legal->legal": 1,
        "illegal->illegal": 1,
    }
    assert summary["ok"] == summary["submitted"] == 2
    assert not summary["false_verdicts"] and not summary["submit_errors"]
    assert runner._m_verdicts.value(expected="illegal", actual="illegal") == 1


@both
def test_schedule_is_deterministic_and_cycle_spread():
    cfg = P.SoakConfig(address="ignored", campaigns=("a", "b"), seed=5, cycles=2)
    sched = P.SoakRunner(cfg).schedule()
    assert sched == P.SoakRunner(cfg).schedule()
    assert len(sched) == 4
    assert len({s for _, s in sched}) == 4, "every run gets a distinct seed"


@both
def test_soak_exit_code_taxonomy():
    clean = dict(false_verdicts=[], submit_errors=[], inconclusive=0, unlabeled=0)
    assert P.soak_exit_code(clean) == 0
    assert P.soak_exit_code({**clean, "false_verdicts": [{}]}) == 1
    assert P.soak_exit_code({**clean, "submit_errors": [{}]}) == 3
    assert P.soak_exit_code({**clean, "inconclusive": 1}) == 3
    assert P.soak_exit_code({**clean, "unlabeled": 1}) == 3


@both
def test_unreachable_daemon_is_a_lost_submit_not_a_crash(tmp_path):
    cfg = P.SoakConfig(
        address=str(tmp_path / "nobody-home.sock"),
        campaigns=("steady",),
        seed=11,
        retries=1,
        backoff_s=0.01,
    )
    summary = P.SoakRunner(cfg).run()
    assert P.soak_exit_code(summary) == 3
    assert len(summary["submit_errors"]) == 1
    assert summary["results"][0]["outcome"] == "submit_error"


# -- the sentinel ------------------------------------------------------------


class _Sink(http.server.ThreadingHTTPServer):
    def __init__(self):
        self.alerts = []
        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                # Alertmanager v1 webhook shape: a JSON list of alerts.
                sink.alerts.extend(body if isinstance(body, list) else [])
                self.send_response(200)
                self.end_headers()

            def log_message(self, *_):
                pass

        super().__init__(("127.0.0.1", 0), Handler)
        self.daemon_threads = True
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server_address[1]}/alerts"


@both
def test_mislabeled_control_fires_the_false_verdict_path(daemon, tmp_path, package):
    sink = _Sink()
    try:
        state = str(tmp_path / "state")
        runner = P.SoakRunner(
            _scfg(
                daemon,
                campaigns=("steady",),
                mislabel_first=True,
                alert_url=sink.url,
                state_dir=state,
            )
        )
        summary = runner.run()
        assert P.soak_exit_code(summary) == 1
        (row,) = summary["false_verdicts"]
        assert row["control"] and row["expect"] == "illegal"
        assert row["actual"] == "legal"
        assert runner._m_false.value(campaign="steady") == 1
        # Webhook: the builtin checker_false_verdict alert was delivered.
        names_ = [a.get("labels", {}).get("alertname") for a in sink.alerts]
        assert "checker_false_verdict" in names_
        # Flight marker: fingerprint + repro for one-command reproduction.
        marks = [
            m
            for m in P.read_flight(state)
            if m.get("k") == "dump" and m.get("reason") == "checker_false_verdict"
        ]
        assert len(marks) == 1
        assert marks[0]["fingerprint"] == row["fingerprint"]
        assert "--campaign steady --seed" in marks[0]["repro"]
        assert marks[0]["repro"].startswith(f"python -m {package} collect")
        # The offending history + label landed on disk.
        d = os.path.join(state, "false_verdicts")
        saved = sorted(os.listdir(d))
        assert any(p.endswith(".jsonl") for p in saved)
        assert any(p.endswith(".label.json") for p in saved)
    finally:
        sink.shutdown()
        sink.server_close()


@both
def test_repro_command_regenerates_the_flagged_bytes():
    events, label = P.collect_labeled(P.get_campaign("reorder"), seed=11)
    fp = P.history_fingerprint(P.prepare(events))
    cmd = P.repro_command(label)
    assert "--campaign reorder --seed 11" in cmd
    # Replaying the label's (campaign, seed, sizing) reproduces the exact
    # fingerprint the sentinel flagged.
    again, _ = P.collect_labeled(
        P.get_campaign(label["campaign"]),
        label["seed"],
        clients=label["clients"],
        ops=label["ops"],
    )
    assert P.history_fingerprint(P.prepare(again)) == fp


# -- adversarial histories through the live daemon ---------------------------


@both
def test_unsatisfiable_adversarial_history_is_illegal_via_submit(daemon):
    events = P.adversarial_events(5, batch=4, seed=2, unsatisfiable=True)
    buf = io.StringIO()
    P.ev.write_history(events, buf)
    client = P.VerifydClient(daemon.socket_path, timeout=60)
    reply = client.submit_with_retry(buf.getvalue(), client="test", no_viz=True)
    assert int(reply["verdict"]) == 1, reply  # ILLEGAL


@both
def test_satisfiable_adversarial_history_is_legal_via_submit(daemon):
    events = P.adversarial_events(5, batch=4, seed=2)
    buf = io.StringIO()
    P.ev.write_history(events, buf)
    client = P.VerifydClient(daemon.socket_path, timeout=60)
    reply = client.submit_with_retry(buf.getvalue(), client="test", no_viz=True)
    assert int(reply["verdict"]) == 0, reply  # OK


# -- the full matrix (slow, as in the JAX package) ---------------------------


@both
@pytest.mark.slow
def test_full_builtin_matrix_clean_against_daemon(daemon, tmp_path):
    runner = P.SoakRunner(
        _scfg(daemon, state_dir=str(tmp_path / "state"))
    )
    summary = runner.run()
    assert P.soak_exit_code(summary) == 0, summary["verdict_table"]
    assert summary["verdict_table"].get("illegal->illegal") == 4


# -- side by side ---------------------------------------------------------------

#: the fields of a scored row that two runs of one schedule share
ROW = ("campaign", "seed", "expect", "events", "control", "fingerprint", "actual", "outcome")
CAMPAIGNS = ("steady", "drop-acked", "reorder", "stale-read")


def _rows(summary) -> list:
    return [tuple(r.get(k) for k in ROW) for r in summary["results"]]


def test_soak_scores_the_same_rows_as_jax(daemons):
    got = {}
    for pkg, ns in ((JAX, J), (PORT, T)):
        got[pkg] = ns.SoakRunner(_scfg(daemons[pkg], ns, campaigns=CAMPAIGNS, cycles=2)).run()
    assert _rows(got[PORT]) == _rows(got[JAX])
    for key in ("schedule", "generated", "submitted", "ok", "inconclusive", "unlabeled", "verdict_table"):
        assert got[PORT][key] == got[JAX][key], key
    assert T.soak_exit_code(got[PORT]) == J.soak_exit_code(got[JAX]) == 0


@pytest.fixture
def fleet(tmp_path):
    """The port's router over two of the port's daemons (device off)."""
    with contextlib.ExitStack() as stack:
        for n in "ab":
            stack.enter_context(T.Verifyd(T.VerifydConfig(
                socket_path=str(tmp_path / f"{n}.sock"), workers=1, device="off", no_viz=True,
                out_dir=str(tmp_path / "viz"))))
        router = stack.enter_context(T.VerifydRouter(T.RouterConfig(
            listen=str(tmp_path / "router.sock"),
            backends=tuple(T.BackendSpec(n, str(tmp_path / f"{n}.sock")) for n in "ab"),
            probe_interval_s=30.0)))
        yield router


def test_both_runners_score_the_ports_fleet_alike(daemons, fleet):
    """Through the port's router, each package's runner scores the rows a
    lone daemon of its package scores."""
    addr = fleet.cfg.listen
    alone = T.SoakRunner(_scfg(daemons[PORT], T, campaigns=CAMPAIGNS)).run()
    for ns in (T, J):
        summary = ns.SoakRunner(ns.SoakConfig(address=addr, campaigns=CAMPAIGNS, seed=11, retries=3,
                                              backoff_s=0.05)).run()
        assert _rows(summary) == _rows(alone)
        assert ns.soak_exit_code(summary) == 0


def test_soak_command_exits_0_then_1_with_the_mislabeled_control(fleet, tmp_path, capsys):
    addr = fleet.cfg.listen
    argv = ["soak", addr, "--campaign", "steady", "--campaign", "drop-acked", "--seed", "11"]
    assert T.cli.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["ok"], line["false_verdicts"], line["verdict_table"]) == (
        2, 0, {"legal->legal": 1, "illegal->illegal": 1})
    sink = _Sink()
    try:
        state = tmp_path / "soak-state"
        rc = T.cli.main([*argv, "--mislabel-control", "--alert-url", sink.url, "--state-dir", str(state),
                         "--json"])
        assert rc == 1
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert len(summary["false_verdicts"]) == 1 and summary["false_verdicts"][0]["control"]
        assert "checker_false_verdict" in [a.get("labels", {}).get("alertname") for a in sink.alerts]
        assert os.listdir(state / "false_verdicts")
    finally:
        sink.shutdown()
        sink.server_close()
    assert T.cli.main(["soak", addr, "--campaign", "no-such-campaign"]) == 64


def test_soak_command_takes_the_jax_flags_and_defaults():
    argv = ["soak", "S"]
    jargs = vars(J.cli.build_parser().parse_args(argv))
    pargs = vars(T.cli.build_parser().parse_args(argv))
    assert (jargs.pop("fn").__name__, pargs.pop("fn").__name__) == ("_cmd_soak",) * 2
    assert pargs == jargs
