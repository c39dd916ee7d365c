"""The fault-injecting frame proxy in the port (``service/chaosproxy.py``)
beside the JAX package's, and the chaos contract over the port's
processes.

- The cases of ``tests/test_chaos.py``, run over both packages: verdicts
  survive each fault (truncate, garble, delay, duplicate) through the
  proxy in front of that package's TCP daemon, a fault-free proxy is
  transparent, and an unknown fault is refused.
- Across packages: each package's proxy in front of the other's daemon,
  with the same deterministic fault schedule (the same frames faulted).
- ``slow``, as the JAX package's two harness cases are (they run its
  ``scripts/``; these drive the port's processes): the fault matrix, the
  auth probes and a SIGKILL mid-job across three boots of the port's
  ``serve``; and two ``serve`` backends behind the port's ``route serve``
  with one SIGKILLed mid-load — no accepted job lost, verdicts right
  throughout, the victim's rejoin and a clean rolling drain.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import pytest

from helpers import H, fold
from s2_verification_tpu.utils import events as jev
from test_torch_service import time_limit

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = "s2_verification_tpu", "s2_verification_tpu_torch"
PACKAGES = (JAX, PORT)
SECRET = b"chaos-test-secret"

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    "ChaosProxy": ("service.chaosproxy", "ChaosProxy"),
    "VerifydClient": ("service.client", "VerifydClient"),
    "VerifydError": ("service.client", "VerifydError"),
    "Verifyd": ("service.daemon", "Verifyd"),
    "VerifydConfig": ("service.daemon", "VerifydConfig"),
}


def names(pkg: str) -> SimpleNamespace:
    """The names of :data:`_NAMES` from package ``pkg``."""
    ns = SimpleNamespace()
    for name, (mod, attr) in _NAMES.items():
        setattr(ns, name, getattr(importlib.import_module(f"{pkg}.{mod}"), attr))
    return ns


J, T = names(JAX), names(PORT)


@pytest.fixture(params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    P.__dict__.update(vars(names(request.param)))
    yield request.param


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Each case fails at its limit instead of hanging the run."""
    limit = 600 if request.node.get_closest_marker("slow") else 90
    with time_limit(limit):
        yield


def _text(h: H) -> str:
    buf = io.StringIO()
    jev.write_history(h.events, buf)
    return buf.getvalue()


def good_history(base: int = 111) -> str:
    h = H()
    h.append_ok(1, [base], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([base]))
    return _text(h)


def bad_history(base: int = 111) -> str:
    h = H()
    h.append_ok(1, [base], tail=1)
    h.read_ok(2, tail=1, stream_hash=12345)
    return _text(h)


@pytest.fixture(scope="module")
def tcp_daemons(tmp_path_factory):
    """One TCP daemon of each package (device off, one worker)."""
    out, stack = {}, []
    try:
        for pkg, ns in ((JAX, J), (PORT, T)):
            tmp = tmp_path_factory.mktemp(f"chaos-{pkg}")
            cfg = ns.VerifydConfig(
                socket_path=str(tmp / "verifyd.sock"),
                workers=1,
                device="off",
                no_viz=True,
                out_dir=str(tmp / "viz"),
                tcp="127.0.0.1:0",
                secret=SECRET,
            )
            d = ns.Verifyd(cfg).__enter__()
            stack.append(d)
            out[pkg] = d
        yield out
    finally:
        for d in stack:
            d.__exit__(None, None, None)


@pytest.fixture
def tcp_daemon(tcp_daemons, package):
    return tcp_daemons[package]


@pytest.mark.usefixtures("package")
@pytest.mark.parametrize("fault", ["truncate", "garble", "delay", "duplicate"])
def test_verdicts_survive_fault(tcp_daemon, fault):
    with P.ChaosProxy(
        ("127.0.0.1", tcp_daemon.tcp_port), fault=fault, every=2, delay_s=0.05
    ) as proxy:
        client = P.VerifydClient(
            f"127.0.0.1:{proxy.port}", timeout=60, secret=SECRET
        )
        # every=2 and two calls per loop guarantee the fault fires, and
        # the deterministic schedule guarantees a retry lands clean
        for _ in range(2):
            good = client.submit_with_retry(
                good_history(), client=f"chaos-{fault}", retries=6,
                backoff_s=0.01, no_viz=True,
            )
            bad = client.submit_with_retry(
                bad_history(), client=f"chaos-{fault}", retries=6,
                backoff_s=0.01, no_viz=True,
            )
            assert good["verdict"] == 0
            assert bad["verdict"] == 1
        assert proxy.faulted >= 1, "matrix would be vacuous"


@pytest.mark.usefixtures("package")
def test_proxy_passthrough_is_transparent(tcp_daemon):
    with P.ChaosProxy(("127.0.0.1", tcp_daemon.tcp_port), fault="none") as proxy:
        client = P.VerifydClient(
            f"127.0.0.1:{proxy.port}", timeout=60, secret=SECRET
        )
        assert client.ping()["server"] == "verifyd"
        assert proxy.faulted == 0


@pytest.mark.usefixtures("package")
def test_proxy_rejects_unknown_fault():
    with pytest.raises(ValueError):
        P.ChaosProxy(("127.0.0.1", 1), fault="explode")


# -- across packages -----------------------------------------------------------


def _schedule(proxy_ns, daemon, fault: str) -> tuple:
    """Four submits through ``proxy_ns``'s proxy in front of ``daemon``:
    the verdicts, frames seen and frames faulted."""
    with proxy_ns.ChaosProxy(("127.0.0.1", daemon.tcp_port), fault=fault, every=3, delay_s=0.02) as proxy:
        client = T.VerifydClient(f"127.0.0.1:{proxy.port}", timeout=60, secret=SECRET)
        verdicts = [
            client.submit_with_retry(text, client="x", retries=6, backoff_s=0.01, no_viz=True)["verdict"]
            for text in (good_history(5), bad_history(5), good_history(6), bad_history(6))
        ]
        return verdicts, proxy._frames, proxy.faulted


@pytest.mark.parametrize("fault", ["truncate", "garble", "delay", "duplicate"])
def test_each_proxy_fronts_the_other_packages_daemon_alike(tcp_daemons, fault):
    jax_over_port = _schedule(J, tcp_daemons[PORT], fault)
    port_over_jax = _schedule(T, tcp_daemons[JAX], fault)
    assert port_over_jax == jax_over_port
    assert jax_over_port[0] == [0, 1, 0, 1] and jax_over_port[2] >= 1


# -- the chaos contract over the port's processes (slow) ----------------------


def _env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))


class _Procs:
    """The port's CLI processes of one case, killed at its end."""

    def __init__(self, tmp: Path) -> None:
        self.tmp, self.procs = tmp, []

    def start(self, tag: str, *argv, sock: str | None = None) -> subprocess.Popen:
        err = open(self.tmp / f"{tag}.stderr", "a", encoding="utf-8")
        p = subprocess.Popen([sys.executable, "-m", PORT, *argv], env=_env(), cwd=str(self.tmp),
                             stdout=subprocess.DEVNULL, stderr=err)
        err.close()
        self.procs.append(p)
        deadline = time.monotonic() + 120
        while sock is not None and not os.path.exists(sock):
            assert p.poll() is None, (self.tmp / f"{tag}.stderr").read_text()[-3000:]
            assert time.monotonic() < deadline, f"{tag}: no socket"
            time.sleep(0.05)
        return p

    def kill_all(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _corpus(n: int) -> list[tuple[str, int]]:
    """Linearizable and violating histories, distinct bytes each."""
    return [(good_history(1000 + i), 0) if i % 2 == 0 else (bad_history(1000 + i), 1) for i in range(n)]


@pytest.mark.slow
def test_full_chaos_harness(tmp_path):
    """The whole contract over the port's ``serve``: the fault matrix and
    the auth probes against a TCP daemon, then crash recovery over three
    boots on one state dir — boot 1 admits with no worker and is
    SIGKILLed holding every job, boot 2 replays each orphan to its
    verdict, boot 3 answers them all from the verdict segments with no
    checker run."""
    procs = _Procs(tmp_path)
    (tmp_path / "secret").write_bytes(SECRET)
    corpus = _corpus(8)
    try:
        sock, tcp = str(tmp_path / "tcp.sock"), _free_port()
        procs.start("tcp", "serve", "-socket", sock, "--device", "off", "--tcp", f"127.0.0.1:{tcp}",
                    "--secret-file", str(tmp_path / "secret"), "--no-viz", sock=sock)
        for fault in ("truncate", "garble", "delay", "duplicate"):
            with T.ChaosProxy(("127.0.0.1", tcp), fault=fault, every=2, delay_s=0.05) as proxy:
                c = T.VerifydClient(f"127.0.0.1:{proxy.port}", timeout=60, secret=SECRET)
                for text, want in corpus:
                    assert c.submit_with_retry(text, client="chaos", retries=6, backoff_s=0.01,
                                               no_viz=True)["verdict"] == want
                assert proxy.faulted >= 1
        # Auth probes: a wrong secret and no secret are refused before
        # admission, and the daemon still answers.
        with pytest.raises(T.VerifydError) as ei:
            T.VerifydClient(f"127.0.0.1:{tcp}", timeout=30, secret=b"wrong-secret").submit(good_history(),
                                                                                        no_viz=True)
        assert ei.value.cls == "AuthError"
        protocol = importlib.import_module(f"{PORT}.service.protocol")
        with socket.create_connection(("127.0.0.1", tcp), timeout=30) as conn:
            conn.sendall(protocol.encode_frame({"op": "submit", "history": good_history()}))
            assert json.loads(conn.makefile("rb").readline())["err"]["class"] == "AuthError"
        assert T.VerifydClient(f"127.0.0.1:{tcp}", timeout=30, secret=SECRET).ping()["server"] == "verifyd"

        state, csock = str(tmp_path / "state"), str(tmp_path / "crash.sock")

        def boot(tag, workers):
            return procs.start(tag, "serve", "-socket", csock, "--device", "off", "--state-dir", state,
                               "--no-viz", "--workers", str(workers), sock=csock)

        p1 = boot("boot1", 0)
        c1 = T.VerifydClient(csock, timeout=0.5)
        for text, _want in corpus:
            with pytest.raises((T.VerifydError, OSError)):
                c1.submit(text, client="chaos-crash", no_viz=True)  # accepted, never answered
        p1.send_signal(signal.SIGKILL)
        p1.wait(timeout=60)
        os.remove(csock)  # SIGKILL leaves the socket file; serve refuses it
        p2 = boot("boot2", 1)
        c2 = T.VerifydClient(csock, timeout=120)
        deadline = time.monotonic() + 120
        while not (c2.stats()["orphans_recovered"] >= len(corpus) and c2.stats()["completed"] >= len(corpus)):
            assert time.monotonic() < deadline, c2.stats()
            time.sleep(0.1)
        for text, want in corpus:
            got = c2.submit(text, client="chaos-verify", no_viz=True)
            assert got["verdict"] == want and got["cached"]
        c2.shutdown()
        assert p2.wait(timeout=60) == 0
        p3 = boot("boot3", 1)
        c3 = T.VerifydClient(csock, timeout=120)
        for text, want in corpus:
            got = c3.submit(text, client="chaos-warm", no_viz=True)
            assert got["verdict"] == want and got["cached"]
        snap = c3.stats()
        assert snap["completed"] == 0 and snap["cache_loaded"] >= len(corpus)
        c3.shutdown()
        assert p3.wait(timeout=60) == 0
    finally:
        procs.kill_all()


@pytest.mark.slow
def test_fleet_node_kill_loses_no_accepted_jobs(tmp_path):
    """Two of the port's ``serve`` backends behind its ``route serve``:
    one SIGKILLed mid-load loses no accepted job, every verdict is right,
    the router's ``/healthz`` stays 200, the victim rejoins on its state
    dir, and a rolling drain exits the survivor 0 while the fleet keeps
    answering."""
    procs = _Procs(tmp_path)
    try:
        healthz = {n: _free_port() for n in "ab"}

        def backend(n):
            sock = str(tmp_path / f"{n}.sock")
            if os.path.exists(sock):
                os.remove(sock)  # SIGKILL leaves the socket file; serve refuses it
            return procs.start(n, "serve", "-socket", sock, "--device", "off", "--state-dir",
                               str(tmp_path / f"state-{n}"), "--drain-timeout", "10", "--no-viz",
                               "--metrics-port", str(healthz[n]), sock=sock)

        nodes = {n: backend(n) for n in "ab"}
        rsock = str(tmp_path / "r.sock")
        router = procs.start(
            "router", "route", "serve", "--listen", rsock, "--probe-interval", "0.2", "--metrics-port", "0",
            "--breaker-reset", "0.5",
            *[x for n in "ab" for x in ("--backend",
                                        f"{n}={tmp_path / f'{n}.sock'}@http://127.0.0.1:{healthz[n]}/healthz")],
            sock=rsock)
        rc = T.VerifydClient(rsock, timeout=120)
        rport = rc.stats()["metrics_port"]
        corpus = _corpus(40)
        failures, answered = [], []
        health: list[int] = []
        stop = threading.Event()

        def load(i):
            c = T.VerifydClient(rsock, timeout=120)
            for j, (text, want) in enumerate(corpus[i::4] * 3):
                try:
                    got = c.submit_with_retry(text, client=f"load-{i}", retries=20, backoff_s=0.1, no_viz=True)
                    answered.append(1)
                    if got["verdict"] != want:
                        failures.append(("verdict", got))
                except Exception as e:  # noqa: BLE001 - every loss is a failure
                    failures.append(("lost", repr(e)))

        def watch_health():
            while not stop.is_set():
                with urllib.request.urlopen(f"http://127.0.0.1:{rport}/healthz", timeout=10) as resp:
                    health.append(resp.status)
                time.sleep(0.05)

        threads = [threading.Thread(target=load, args=(i,)) for i in range(4)]
        hw = threading.Thread(target=watch_health, daemon=True)
        hw.start()
        [t.start() for t in threads]
        deadline = time.monotonic() + 60
        while len(answered) < len(corpus) // 2:  # mid-load: a quarter of the submits answered
            assert time.monotonic() < deadline and not failures, failures[:5]
            time.sleep(0.005)
        nodes["a"].send_signal(signal.SIGKILL)
        nodes["a"].wait(timeout=60)
        [t.join(timeout=300) for t in threads]
        stop.set()
        hw.join(timeout=30)
        assert not failures, failures[:5]
        assert len(answered) == len(corpus) * 3
        assert rc.stats()["failovers"] >= 1
        assert health and set(health) == {200}
        deadline = time.monotonic() + 30
        while {b["name"]: b["up"] for b in rc.fleet()["backends"]}["a"] is not False:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        # Rejoin on the same state dir.
        nodes["a"] = backend("a")
        deadline = time.monotonic() + 30
        while {b["name"]: b["up"] for b in rc.fleet()["backends"]}["a"] is not True:
            assert time.monotonic() < deadline, rc.fleet()
            time.sleep(0.1)
        # Rolling drain of the survivor: it exits 0, the fleet answers on a.
        drain = subprocess.run([sys.executable, "-m", PORT, "route", "drain", "b", "-socket", rsock], env=_env(),
                               capture_output=True, text=True, timeout=120)
        assert drain.returncode == 0, drain.stderr
        assert nodes["b"].wait(timeout=60) == 0
        for i in range(10):  # fresh histories: the edge cache keeps the old ones' provenance
            got = rc.submit(good_history(9000 + i), no_viz=True)
            assert got["verdict"] == 0 and got["node"] == "a"
        router.terminate()
        assert router.wait(timeout=60) == 0
    finally:
        procs.kill_all()
