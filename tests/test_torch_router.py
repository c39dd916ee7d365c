"""The router tier in the port — ``obs/probe.py``, ``obs/federate.py`` and
``service/router.py`` — beside the JAX package's.

- The cases of ``tests/test_router.py``, run over both packages: the hash
  ring, the circuit breaker, the health prober, ``BackendSpec``, and two
  in-process backends behind an in-process router (affinity, the edge
  cache, failover off a dead home node, drain and undrain, NoBackend,
  the decode errors at the edge), and the client's ``--deadline``.
- Side by side, exact: ring placement (``_ring_hash``, lookups and
  preference lists over seeded keys and node sets) and the reply and
  fleet-view fields of one routed sequence.
- Across packages: the port's router fronts JAX daemons, and the JAX
  router fronts the port's, with affinity, the edge cache, failover and
  drain.
- The fleet plane: ``/fleet/metrics`` carries each backend's
  ``verifyd_kernel_launches_total`` under its ``node`` label and no other
  change, and ``/fleet/slo``, ``/fleet/dashboard`` and the stitched
  ``trace`` answer.
- The cases of ``tests/test_obs_v4.py`` on the fleet plane (the
  ``FleetScraper`` merge under the closed ``node`` label, dead-node gaps,
  the HTTP scrape with its ``stats`` fallback, the SLO rollup, the
  ``/fleet/*`` endpoints with and without a federator) and of
  ``tests/test_progress.py`` on ``watch`` through the router, over both
  packages; the merged exposition equals the JAX scraper's byte for byte.
- The ``route`` CLI as processes: ``route serve`` over two ``serve``
  backends, ``route fleet`` (text and ``--json``), ``submit`` through it,
  ``route drain`` (the backend exits 0) and ``route undrain``.
- ``chip_smoke.run_fleet_phase`` rehearsed on the CPU with stand-ins.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.error
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

#: the names the cases use, from the package under test (filled per case)
P = SimpleNamespace()
_NAMES = {
    "CircuitBreaker": ("obs.probe", "CircuitBreaker"),
    "HealthProber": ("obs.probe", "HealthProber"),
    "history_fingerprint": ("service.cache", "history_fingerprint"),
    "prepare": ("checker.entries", "prepare"),
    "VerifydClient": ("service.client", "VerifydClient"),
    "VerifydDeadlineExceeded": ("service.client", "VerifydDeadlineExceeded"),
    "VerifydError": ("service.client", "VerifydError"),
    "VerifydUnavailable": ("service.client", "VerifydUnavailable"),
    "Verifyd": ("service.daemon", "Verifyd"),
    "VerifydConfig": ("service.daemon", "VerifydConfig"),
    "BackendSpec": ("service.router", "BackendSpec"),
    "HashRing": ("service.router", "HashRing"),
    "RouterConfig": ("service.router", "RouterConfig"),
    "VerifydRouter": ("service.router", "VerifydRouter"),
    "ev": ("utils.events", None),
    "FleetScraper": ("obs.federate", "FleetScraper"),
    "ScrapeTarget": ("obs.federate", "ScrapeTarget"),
    "parse_exposition": ("obs.federate", "parse_exposition"),
    "MetricsServer": ("obs.httpd", "MetricsServer"),
    "MetricsRegistry": ("obs.metrics", "MetricsRegistry"),
    "CheckOutcome": ("checker.oracle", "CheckOutcome"),
    "CheckResult": ("checker.oracle", "CheckResult"),
    "scheduler": ("service.scheduler", None),
}


def names(pkg: str) -> SimpleNamespace:
    """The names of :data:`_NAMES` from package ``pkg``."""
    ns = SimpleNamespace()
    for name, (mod, attr) in _NAMES.items():
        m = importlib.import_module(f"{pkg}.{mod}")
        setattr(ns, name, getattr(m, attr) if attr else m)
    return ns


@pytest.fixture(params=PACKAGES)
def package(request):
    """The package under test's name; fills :data:`P` with its names."""
    P.__dict__.update(vars(names(request.param)))
    yield request.param


#: a case of ``tests/test_router.py``, run once for each package
both = pytest.mark.usefixtures("package")

#: the time limits of the cases that need more than 60 s
LIMITS = {
    "test_route_cli_serves_drains_and_undrains_over_serve_processes": 180,
    "test_fleet_phase_rehearses_on_the_cpu": 600,
}


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Each case fails at its limit instead of hanging the run."""
    with time_limit(LIMITS.get(request.function.__name__, 60)):
        yield


def _text(h: H) -> str:
    buf = io.StringIO()
    jev.write_history(h.events, buf)
    return buf.getvalue()


def good_history(base: int = 100) -> str:
    h = H()
    h.append_ok(1, [base + 1], tail=1)
    h.read_ok(2, tail=1, stream_hash=fold([base + 1]))
    return _text(h)


def bad_history(base: int = 100) -> str:
    h = H()
    h.append_ok(1, [base + 1], tail=1)
    h.read_ok(2, tail=1, stream_hash=base)  # impossible stream hash
    return _text(h)


# -- hash ring ----------------------------------------------------------------


@both
def test_ring_deterministic_and_complete():
    ring = P.HashRing(["a", "b", "c"], replicas=64)
    keys = [f"v1:{i:016x}:4" for i in range(200)]
    owners = {k: ring.lookup(k) for k in keys}
    assert set(owners.values()) == {"a", "b", "c"}  # all nodes own keys
    again = P.HashRing(["c", "a", "b"], replicas=64)  # order-independent
    assert {k: again.lookup(k) for k in keys} == owners


@both
def test_ring_remove_remaps_only_the_lost_nodes_keys():
    ring = P.HashRing(["a", "b", "c"], replicas=64)
    keys = [f"v1:{i:016x}:4" for i in range(300)]
    before = {k: ring.lookup(k) for k in keys}
    ring.remove("b")
    after = {k: ring.lookup(k) for k in keys}
    for k in keys:
        if before[k] != "b":
            # Stability: a surviving node's keys never move.
            assert after[k] == before[k]
        else:
            assert after[k] in ("a", "c")


@both
def test_ring_add_restores_ownership():
    ring = P.HashRing(["a", "b", "c"], replicas=64)
    keys = [f"v1:{i:016x}:4" for i in range(300)]
    before = {k: ring.lookup(k) for k in keys}
    ring.remove("b")
    ring.add("b")
    assert {k: ring.lookup(k) for k in keys} == before


@both
def test_ring_preference_is_home_first_all_distinct():
    ring = P.HashRing(["a", "b", "c"], replicas=64)
    pref = ring.preference("some-fingerprint")
    assert sorted(pref) == ["a", "b", "c"]
    assert pref[0] == ring.lookup("some-fingerprint")


@both
def test_ring_empty_and_bad_replicas():
    assert P.HashRing().lookup("x") is None
    assert P.HashRing().preference("x") == []
    with pytest.raises(ValueError):
        P.HashRing(replicas=0)


# -- circuit breaker (injected clock — no sleeping) ---------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@both
def test_breaker_opens_after_consecutive_failures():
    clk = _Clock()
    br = P.CircuitBreaker(failures=3, reset_s=5.0, time_fn=clk)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"  # under threshold
    br.record_success()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"  # success reset the streak
    br.record_failure()
    assert br.state == "open"
    assert not br.allow()


@both
def test_breaker_half_open_probe_single_slot():
    clk = _Clock()
    br = P.CircuitBreaker(failures=1, reset_s=5.0, time_fn=clk)
    br.record_failure()
    assert br.state == "open"
    clk.t = 4.9
    assert not br.allow()
    clk.t = 5.1
    assert br.allow()  # the single half-open probe
    assert br.state == "half_open"
    assert not br.allow()  # concurrent caller refused
    br.record_success()
    assert br.state == "closed"
    assert br.allow()


@both
def test_breaker_failed_probe_reopens_with_fresh_window():
    clk = _Clock()
    br = P.CircuitBreaker(failures=1, reset_s=5.0, time_fn=clk)
    br.record_failure()
    clk.t = 6.0
    assert br.allow()
    br.record_failure()  # probe failed
    assert br.state == "open"
    clk.t = 10.0  # 4s into the NEW window
    assert not br.allow()
    clk.t = 11.1
    assert br.allow()
    br.record_success()
    assert br.state == "closed"


@both
def test_breaker_reset_forces_closed():
    br = P.CircuitBreaker(failures=1, reset_s=1000.0, time_fn=lambda: 0.0)
    br.record_failure()
    assert br.state == "open"
    br.reset()
    assert br.state == "closed" and br.allow()
    with pytest.raises(ValueError):
        P.CircuitBreaker(failures=0)


# -- health prober (synchronous ticks, fake probes) ---------------------------


@both
def test_prober_reports_first_observation_and_transitions():
    up = {"a": True, "b": False}
    changes = []
    prober = P.HealthProber(
        {n: (lambda n=n: up[n]) for n in up},
        on_change=lambda name, ok: changes.append((name, ok)),
    )
    assert prober.probe_once() == {"a": True, "b": False}
    assert sorted(changes) == [("a", True), ("b", False)]  # first obs fires
    changes.clear()
    prober.probe_once()
    assert changes == []  # steady state is silent
    up["b"] = True
    prober.probe_once()
    assert changes == [("b", True)]
    assert prober.status == {"a": True, "b": True}


@both
def test_prober_raising_probe_reads_down():
    def boom():
        raise OSError("probe exploded")

    prober = P.HealthProber({"x": boom})
    assert prober.probe_once() == {"x": False}
    assert prober.status["x"] is False


# -- backend spec -------------------------------------------------------------


@both
def test_backend_spec_parse():
    s = P.BackendSpec.parse("a=/tmp/a.sock")
    assert (s.name, s.address, s.healthz_url) == ("a", "/tmp/a.sock", None)
    s = P.BackendSpec.parse("b=127.0.0.1:7000@http://127.0.0.1:9000/healthz")
    assert s.address == "127.0.0.1:7000"
    assert s.healthz_url == "http://127.0.0.1:9000/healthz"
    for bad in ("no-equals", "=addr", "name="):
        with pytest.raises(ValueError):
            P.BackendSpec.parse(bad)


# -- end-to-end topology helpers ----------------------------------------------


def _backend_cfg(tmp_path, name: str, ns=P, **overrides):
    kw = dict(
        socket_path=str(tmp_path / f"{name}.sock"),
        workers=1,
        device="off",
        no_viz=True,
        stats_log=None,
        out_dir=str(tmp_path / f"viz-{name}"),
    )
    kw.update(overrides)
    return ns.VerifydConfig(**kw)


def _router_cfg(tmp_path, names_, ns=P, **overrides):
    kw = dict(
        listen=str(tmp_path / "router.sock"),
        backends=tuple(
            ns.BackendSpec(n, str(tmp_path / f"{n}.sock")) for n in names_
        ),
        probe_interval_s=30.0,  # tests drive probe_once() themselves
        breaker_failures=2,
        breaker_reset_s=0.2,
        max_failovers=2,
    )
    kw.update(overrides)
    return ns.RouterConfig(**kw)


def _ring_key(text: str, ns=P) -> str:
    """The router's placement key: prefix affinity, not fingerprint."""
    hist = ns.prepare(list(ns.ev.iter_history(text)), elide_trivial=True)
    return ns.VerifydRouter._affinity_key(hist, ns.history_fingerprint(hist))


def _homed_at(router, node: str, base: int = 10_000, ns=P) -> str:
    """A fresh linearizable history whose ring home is ``node``."""
    while True:
        base += 1000
        text = good_history(base)
        if router.ring.preference(_ring_key(text, ns))[0] == node:
            return text


@both
def test_router_affinity_cache_and_fleet_view(tmp_path):
    with P.Verifyd(_backend_cfg(tmp_path, "a")), P.Verifyd(
        _backend_cfg(tmp_path, "b")
    ), P.VerifydRouter(_router_cfg(tmp_path, ("a", "b"))) as router:
        client = P.VerifydClient(router.cfg.listen)
        assert client.ping()["server"] == "verifyd-router"

        texts = {0: good_history(100), 1: bad_history(200)}
        first = {v: client.submit(t, no_viz=True) for v, t in texts.items()}
        for verdict, reply in first.items():
            assert reply["verdict"] == verdict
            assert reply["node"] == router.ring.lookup(_ring_key(texts[verdict]))
            assert not reply.get("cached")
        # Duplicate: answered from the router's edge cache, provenance
        # (the home node) preserved.
        for verdict, text in texts.items():
            again = client.submit(text, no_viz=True)
            assert again["verdict"] == verdict
            assert again["cached"] and again["router_cached"]
            assert again["node"] == first[verdict]["node"]

        fleet = client.fleet()
        assert fleet["ring"]["nodes"] == ["a", "b"]
        assert [b["name"] for b in fleet["backends"]] == ["a", "b"]
        assert all(not b["draining"] for b in fleet["backends"])

        snap = client.stats()
        assert snap["routed"] == 2 and snap["cache_hits"] == 2
        assert "slo" in snap and "metrics" in snap


@both
def test_router_failover_when_home_dies(tmp_path):
    backend_a = P.Verifyd(_backend_cfg(tmp_path, "a")).__enter__()
    try:
        with P.Verifyd(_backend_cfg(tmp_path, "b")), P.VerifydRouter(
            _router_cfg(tmp_path, ("a", "b"))
        ) as router:
            client = P.VerifydClient(router.cfg.listen)
            text = _homed_at(router, "a")
            backend_a.__exit__(None, None, None)  # the home node dies
            reply = client.submit(text, no_viz=True)
            assert reply["verdict"] == 0
            assert reply["node"] == "b"  # failed over, job not lost
            assert client.stats()["failovers"] >= 1
    finally:
        # Idempotent: already exited inside the happy path.
        backend_a.request_stop()


@both
def test_router_drain_undrain_protocol(tmp_path):
    with P.Verifyd(_backend_cfg(tmp_path, "a")), P.Verifyd(
        _backend_cfg(tmp_path, "b")
    ), P.VerifydRouter(_router_cfg(tmp_path, ("a", "b"))) as router:
        client = P.VerifydClient(router.cfg.listen)
        text = _homed_at(router, "a")
        drain = client.drain("a", drain_timeout_s=5.0, timeout=None)
        assert drain["node"] == "a" and drain["drained"]
        fleet = {b["name"]: b for b in client.fleet()["backends"]}
        assert fleet["a"]["draining"]
        # A fresh history homed at the drained node routes around it.
        reply = client.submit(text, no_viz=True)
        assert reply["verdict"] == 0 and reply["node"] == "b"
        # Unknown node: a semantic error, not a crash.
        with pytest.raises(P.VerifydError):
            client.drain("nope")
        client.undrain("a")
        fleet = {b["name"]: b for b in client.fleet()["backends"]}
        assert not fleet["a"]["draining"]


@both
def test_router_no_backend_when_fleet_is_gone(tmp_path):
    cfg = _backend_cfg(tmp_path, "a")
    with P.Verifyd(cfg):
        pass  # boots and exits: the socket path is gone
    with P.VerifydRouter(_router_cfg(tmp_path, ("a",))) as router:
        router.prober.probe_once()
        client = P.VerifydClient(router.cfg.listen)
        with pytest.raises(P.VerifydError) as ei:
            client.submit(good_history(300), no_viz=True)
        assert ei.value.cls == "NoBackend"
        assert client.stats()["no_backend"] == 1


@both
def test_router_decode_error_answered_at_the_edge(tmp_path):
    with P.Verifyd(_backend_cfg(tmp_path, "a")), P.VerifydRouter(
        _router_cfg(tmp_path, ("a",))
    ) as router:
        client = P.VerifydClient(router.cfg.listen)
        with pytest.raises(P.VerifydError) as ei:
            client.submit("not json at all\n", no_viz=True)
        assert ei.value.cls == "DecodeError"
        assert client.stats()["decode_errors"] == 1
        assert client.stats()["routed"] == 0  # no backend burned a slot


@both
def test_router_bad_priority_is_decode_error_not_internal(tmp_path):
    """A non-numeric client-supplied priority answers ``DecodeError`` at
    the edge — the daemon's contract for the same input — instead of a
    ``ValueError`` escaping the route and surfacing as InternalError
    from the dispatch catch-all."""
    with P.VerifydRouter(_router_cfg(tmp_path, ("a",))) as router:
        for route in (router._route_submit, router._route_follow):
            reply = route(
                {
                    "history": good_history(7),
                    "stream": "s",
                    "priority": "urgent",
                }
            )
            e = reply.get("err")
            assert e is not None and e["class"] == "DecodeError", reply
            assert "priority" in e["msg"]


# -- submit --deadline --------------------------------------------------------


@both
def test_deadline_exceeded_raises_with_budget_and_attempts(tmp_path):
    client = P.VerifydClient(str(tmp_path / "nothing-listens-here.sock"))
    with pytest.raises(P.VerifydDeadlineExceeded) as ei:
        client.submit_with_retry(
            good_history(), retries=50, backoff_s=0.05, deadline_s=0.4
        )
    e = ei.value
    assert e.deadline_s == 0.4
    assert e.attempts >= 1
    assert f"deadline exceeded after {e.attempts} attempts" in str(e)
    # The budget is honored as a VerifydUnavailable subtype: exit 69.
    assert isinstance(e, P.VerifydUnavailable)


@both
def test_deadline_none_keeps_plain_unavailable(tmp_path):
    client = P.VerifydClient(str(tmp_path / "nothing-listens-here.sock"))
    with pytest.raises(P.VerifydUnavailable) as ei:
        client.submit_with_retry(good_history(), retries=1, backoff_s=0.01)
    assert not isinstance(ei.value, P.VerifydDeadlineExceeded)


# -- the fleet plane: tests/test_obs_v4.py's federation cases ------------------


def _node_registry(jobs=10, queue=2.0, healthy=1.0, version="0.2.0", ns=P):
    """A fake backend registry carrying the families the plane reads."""
    reg = ns.MetricsRegistry()
    reg.counter("verifyd_jobs_completed_total", "done").inc(jobs)
    reg.gauge("verifyd_queue_depth", "depth").set(queue)
    reg.gauge("verifyd_slo_healthy", "ok").set(healthy)
    reg.gauge(
        "verifyd_slo_availability", "avail", labelnames=("window",)
    ).set(0.99, window="fast")
    reg.gauge(
        "verifyd_build_info",
        "identity",
        labelnames=("version", "backend", "python"),
    ).set(1.0, version=version, backend="off", python="3.10")
    return reg


def _stats_target(reg, ns=P):
    return ns.ScrapeTarget(stats_fn=lambda: {"metrics": reg.snapshot()})


def _scraper(targets, ns=P, **kw):
    kw.setdefault("interval_s", 60.0)  # tests drive scrape_once() directly
    return ns.FleetScraper(ns.MetricsRegistry(), targets, **kw)


@both
def test_merge_injects_node_label_over_every_sample():
    ra = _node_registry(jobs=10, version="0.2.0")
    rb = _node_registry(jobs=20, version="0.3.0")
    sc = _scraper({"a": _stats_target(ra), "b": _stats_target(rb)})
    assert sc.scrape_once() == {"a": True, "b": True}

    text = sc.render()
    assert 'verifyd_jobs_completed_total{node="a"} 10' in text
    assert 'verifyd_jobs_completed_total{node="b"} 20' in text
    # node is the FIRST label even on already-labeled series
    assert 'verifyd_slo_availability{node="a",window="fast"}' in text
    # one TYPE line per family, not one per node
    assert text.count("# TYPE verifyd_jobs_completed_total") == 1
    # every sample carries a node value drawn from the closed member set
    samples, _types, _helps = P.parse_exposition(text)
    assert {s[1]["node"] for s in samples} == {"a", "b"}

    # the merged view also lands on the scraper's own registry, which is
    # what the router's TelemetryStore records for durable fleet history
    own = sc.registry.render()
    assert 'verifyd_fleet_node_up{node="a"} 1' in own
    assert "verifyd_fleet_nodes 2" in own

    # build identity is captured per node for `route fleet`
    build = sc.build_info()
    assert build["a"]["version"] == "0.2.0"
    assert build["b"]["version"] == "0.3.0"


@both
def test_dead_backend_is_a_gap_not_a_zero():
    ra = _node_registry()

    def boom():
        raise OSError("connection refused")

    sc = _scraper({"a": _stats_target(ra), "b": P.ScrapeTarget(stats_fn=boom)})
    assert sc.scrape_once() == {"a": True, "b": False}

    text = sc.render()
    # the dead node contributes NO samples for real families — a gap —
    # but the synthetic up family still reports every configured member
    assert 'node="b"' not in text.replace(
        'verifyd_fleet_node_up{node="b"} 0', ""
    )
    assert 'verifyd_fleet_node_up{node="a"} 1' in text
    assert 'verifyd_fleet_node_up{node="b"} 0' in text
    assert sc.registry.get("verifyd_fleet_scrape_errors_total").value(
        node="b"
    ) == 1.0


@both
def test_http_scrape_with_stats_fallback():
    ra = _node_registry(jobs=7)
    srv = P.MetricsServer(ra, 0)
    try:
        sc = _scraper(
            {
                "web": P.ScrapeTarget(metrics_url=srv.url),
                "op": _stats_target(_node_registry(jobs=9)),
            }
        )
        assert sc.scrape_once() == {"web": True, "op": True}
        text = sc.render()
        assert 'verifyd_jobs_completed_total{node="web"} 7' in text
        assert 'verifyd_jobs_completed_total{node="op"} 9' in text
        snap = sc.payload()
        assert snap["nodes"]["web"]["source"] == "http"
        assert snap["nodes"]["op"]["source"] == "stats"
    finally:
        srv.close()


@both
def test_fleet_slo_rollup_extremes_and_gaps():
    clock = [1000.0]
    ra = _node_registry(healthy=1.0)
    rb = _node_registry(healthy=0.0)

    def boom():
        raise OSError("dead")

    sc = P.FleetScraper(
        P.MetricsRegistry(),
        {
            "a": _stats_target(ra),
            "b": _stats_target(rb),
            "c": P.ScrapeTarget(stats_fn=boom),
        },
        interval_s=60.0,
        time_fn=lambda: clock[0],
    )
    sc.scrape_once()
    rollup = sc.slo_rollup()
    assert rollup["fleet"]["members"] == 3
    assert rollup["fleet"]["up"] == 2
    assert rollup["fleet"]["healthy_nodes"] == 1
    assert rollup["fleet"]["healthy"] is False  # one live node unhealthy
    assert rollup["nodes"]["a"]["healthy"] is True
    assert rollup["nodes"]["b"]["healthy"] is False
    assert rollup["nodes"]["c"] == {"up": False, "last_error": "dead"}
    assert rollup["fleet"]["availability_min"] == pytest.approx(0.99)

    # time passing without scrapes turns live nodes stale: gaps, not zeros
    clock[0] += 10_000.0
    rollup = sc.slo_rollup()
    assert rollup["fleet"]["up"] == 0
    assert rollup["nodes"]["a"]["up"] is False
    assert "jobs_per_sec" not in rollup["nodes"]["a"]


def _get5(url):
    with urllib.request.urlopen(url, timeout=5.0) as resp:
        return resp.status, resp.read().decode("utf-8")


@both
def test_fleet_endpoints_served_by_obs_httpd():
    sc = _scraper(
        {"a": _stats_target(_node_registry()), "b": _stats_target(_node_registry())}
    )
    sc.scrape_once()
    srv = P.MetricsServer(sc.registry, 0, federator=sc)
    try:
        base = f"http://{srv.host}:{srv.port}"
        status, text = _get5(base + "/fleet/metrics")
        assert status == 200 and 'node="a"' in text and 'node="b"' in text
        status, text = _get5(base + "/fleet/slo")
        assert status == 200
        assert json.loads(text)["fleet"]["members"] == 2
        status, text = _get5(base + "/fleet/dashboard")
        assert status == 200 and "<svg" in text and "verifyd fleet" in text
        status, text = _get5(base + "/fleet/dashboard.json")
        assert status == 200 and set(json.loads(text)["nodes"]) == {"a", "b"}
    finally:
        srv.close()


@both
def test_fleet_endpoints_absent_without_federator():
    reg = P.MetricsRegistry()
    srv = P.MetricsServer(reg, 0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get5(f"http://{srv.host}:{srv.port}/fleet/metrics")
        assert ei.value.code == 404
    finally:
        srv.close()


# -- tests/test_progress.py: watch through the router ---------------------------


def _slow_engine(total: int = 30, step_s: float = 0.02):
    """A stand-in CPU engine that reports per-layer progress the way
    check_frontier does, slow enough for a watcher to sample it live."""

    def run(hist, budget, profile=False, progress=None):
        for i in range(1, total + 1):
            if progress is not None:
                progress.update(
                    ops_committed=i,
                    total_ops=total,
                    frontier_width=3 + (i % 5),
                    states_expanded=i * 7,
                    layer=i,
                    engine="frontier",
                    final=(i == total),
                )
            time.sleep(step_s)
        return P.CheckResult(P.CheckOutcome.OK), "frontier"

    return run


@both
def test_watch_through_router_tags_nodes(tmp_path, monkeypatch):
    monkeypatch.setattr(P.scheduler, "_cpu_check", _slow_engine())
    with P.Verifyd(_backend_cfg(tmp_path, "a", progress_interval_s=0.05)), \
            P.VerifydRouter(_router_cfg(tmp_path, ("a",))) as router:
        client = P.VerifydClient(router.cfg.listen)
        reply: dict = {}
        t = threading.Thread(
            target=lambda: reply.update(
                P.VerifydClient(router.cfg.listen).submit(good_history(400), timeout=60)
            ),
            daemon=True,
        )
        t.start()
        rows: list[dict] = []
        deadline = time.monotonic() + 30
        while t.is_alive() and time.monotonic() < deadline:
            rows.extend(client.watch().get("progress") or [])
            time.sleep(0.02)
        t.join(timeout=30)
        assert reply.get("verdict") == 0
        assert rows and all(r["node"] == "a" for r in rows)
        ops = [r["ops_committed"] for r in rows]
        assert ops == sorted(ops) and ops[-1] > ops[0]


@both
def test_watch_through_router_unknown_job_is_definite(tmp_path):
    with P.Verifyd(_backend_cfg(tmp_path, "a")), P.VerifydRouter(
        _router_cfg(tmp_path, ("a",))
    ) as router:
        client = P.VerifydClient(router.cfg.listen)
        with pytest.raises(P.VerifydError) as exc:
            client.watch(job=424242)
        assert exc.value.cls == "UnknownJob"
        assert client.watch()["progress"] == []


# -- side by side: ring placement and the fleet view ---------------------------

J, T = names(JAX), names(PORT)
jrouter = importlib.import_module("s2_verification_tpu.service.router")
prouter = importlib.import_module("s2_verification_tpu_torch.service.router")


def _seeded_keys(seed: int, n: int) -> list[str]:
    """Ring keys as the router makes them (affinity keys of seeded
    histories) and arbitrary strings, unicode included."""
    rng = random.Random(seed)
    keys = [_ring_key(good_history(rng.randrange(1 << 40)), T) for _ in range(n // 2)]
    keys += ["".join(chr(rng.randrange(32, 0x2FF)) for _ in range(rng.randrange(1, 40))) for _ in range(n // 2)]
    return keys


def test_merged_exposition_equals_jax():
    """The same backend registries give the JAX scraper's merged
    ``/fleet/metrics`` text, rollup and board feed, byte for byte."""
    out = []
    for ns in (J, T):
        clock = [1000.0]
        regs = {"a": _node_registry(jobs=10, ns=ns), "b": _node_registry(jobs=3, healthy=0.0, ns=ns)}
        regs["a"].counter("verifyd_kernel_launches_total", "launches", labelnames=("kernel", "where")).inc(
            7, kernel="fold_lanes", where="inline")
        sc = ns.FleetScraper(ns.MetricsRegistry(), {n: _stats_target(r, ns) for n, r in regs.items()},
                             interval_s=60.0, time_fn=lambda: clock[0])
        sc.scrape_once()
        clock[0] += 1.0
        sc.scrape_once()
        out.append((sc.render(), json.dumps(sc.slo_rollup(), sort_keys=True), sc.registry.render()))
    assert out[1] == out[0]
    assert 'verifyd_kernel_launches_total{node="a",kernel="fold_lanes",where="inline"} 7' in out[1][0]


def test_ring_hash_equals_jax():
    keys = _seeded_keys(0, 400) + [f"{node}#{r}" for node in ("a", "b", "node-7") for r in range(64)]
    assert [prouter._ring_hash(k) for k in keys] == [jrouter._ring_hash(k) for k in keys]


@pytest.mark.parametrize("nodes,replicas", [(["a"], 1), (["a", "b"], 64), (["a", "b", "c", "d", "e"], 16),
                                            (["n%d" % i for i in range(9)], 64)])
def test_ring_placement_equals_jax(nodes, replicas):
    """Lookups and preference lists equal the JAX ring's for seeded keys,
    also after a node leaves and comes back."""
    keys = _seeded_keys(len(nodes), 200)
    rings = [ns.HashRing(nodes, replicas=replicas) for ns in (J, T)]

    def view():
        return [[(r.lookup(k), r.preference(k)) for k in keys] for r in rings]

    jv, pv = view()
    assert pv == jv
    for r in rings:
        r.remove(nodes[0])
    jv, pv = view()
    assert pv == jv
    for r in rings:
        r.add(nodes[0])
    assert rings[1].nodes() == rings[0].nodes()
    jv, pv = view()
    assert pv == jv


def test_affinity_keys_equal_jax():
    texts = [good_history(b) for b in range(100, 2100, 100)] + [bad_history(b) for b in range(100, 600, 100)]
    assert [_ring_key(t, T) for t in texts] == [_ring_key(t, J) for t in texts]


#: reply and fleet-view fields that differ between two runs of one sequence
VOLATILE = {"wall_s", "job", "trace_id", "queue_wait_s", "backend_wall_s", "pid", "route_s", "html"}


def _routed_sequence(tmp_path, ns) -> tuple[list, dict]:
    """One submit sequence through a router of package ``ns`` over its own
    daemons: the replies' fields and the fleet view."""
    with ns.Verifyd(_backend_cfg(tmp_path, "a", ns)), ns.Verifyd(_backend_cfg(tmp_path, "b", ns)), \
            ns.VerifydRouter(_router_cfg(tmp_path, ("a", "b"), ns)) as router:
        client = ns.VerifydClient(router.cfg.listen)
        texts = [good_history(100), bad_history(200), good_history(300), good_history(100)]
        replies = [client.submit(t, no_viz=True) for t in texts]
        fleet = client.fleet()
    for b in fleet["backends"]:
        b["address"] = os.path.basename(b["address"])
    return [{k: v for k, v in r.items() if k not in VOLATILE} for r in replies], fleet


def test_routed_replies_and_fleet_view_equal_jax(tmp_path):
    (tmp_path / "j").mkdir(), (tmp_path / "p").mkdir()
    jrep, jfleet = _routed_sequence(tmp_path / "j", J)
    prep, pfleet = _routed_sequence(tmp_path / "p", T)
    assert [sorted(r) for r in prep] == [sorted(r) for r in jrep]
    for key in ("verdict", "outcome", "node", "cached", "router_cached", "fingerprint"):
        assert [r.get(key) for r in prep] == [r.get(key) for r in jrep], key
    # The build labels name each package's own build; the rest is equal.
    for b in jfleet["backends"] + pfleet["backends"]:
        b.pop("build")
    assert pfleet == jfleet


# -- across packages -----------------------------------------------------------


@pytest.mark.parametrize("router_pkg,daemon_pkg", [(PORT, JAX), (JAX, PORT)], ids=["port-over-jax", "jax-over-port"])
def test_router_fronts_the_other_packages_daemons(tmp_path, router_pkg, daemon_pkg):
    """Affinity, the edge cache, failover off a dead home node and drain,
    with the router of one package over the daemons of the other."""
    R, D = names(router_pkg), names(daemon_pkg)
    backend_a = D.Verifyd(_backend_cfg(tmp_path, "a", D)).__enter__()
    try:
        with D.Verifyd(_backend_cfg(tmp_path, "b", D)), D.Verifyd(_backend_cfg(tmp_path, "c", D)), \
                R.VerifydRouter(_router_cfg(tmp_path, ("a", "b", "c"), R)) as router:
            client = R.VerifydClient(router.cfg.listen)
            texts = {0: good_history(100), 1: bad_history(200)}
            for verdict, text in texts.items():
                reply = client.submit(text, no_viz=True)
                assert reply["verdict"] == verdict
                assert reply["node"] == router.ring.lookup(_ring_key(text, R))
                again = client.submit(text, no_viz=True)
                assert again["router_cached"] and again["node"] == reply["node"]
            # The other package's client reads the same router.
            other = D.VerifydClient(router.cfg.listen)
            assert other.fleet()["ring"]["nodes"] == ["a", "b", "c"]
            text = _homed_at(router, "a", ns=R)
            backend_a.__exit__(None, None, None)
            reply = other.submit(text, no_viz=True)
            assert reply["verdict"] == 0 and reply["node"] == router.ring.preference(_ring_key(text, R))[1]
            drained = client.drain("b", drain_timeout_s=5.0, timeout=None)
            assert drained["drained"]
            reply = client.submit(_homed_at(router, "b", 50_000, ns=R), no_viz=True)
            assert reply["verdict"] == 0 and reply["node"] == "c"
    finally:
        backend_a.request_stop()


# -- the fleet plane -----------------------------------------------------------


def _get(url: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, ""


def test_fleet_metrics_carry_each_nodes_kernel_launches(tmp_path):
    """Each backend's ``verifyd_kernel_launches_total`` comes through the
    router's ``/fleet/metrics`` under its ``node`` label, the sample
    otherwise unchanged; ``/fleet/slo``, the fleet dashboard and the
    stitched ``trace`` answer, and a backend's own listener has no fleet
    plane."""
    counts = {"a": {"inline": {"fold_lanes": 7}, "children": {}},
              "b": {"inline": {}, "children": {"fold_lanes": 3}}}
    daemons = {n: T.Verifyd(_backend_cfg(tmp_path, n, T, metrics_port=0)) for n in "ab"}
    for n, d in daemons.items():
        d.launch_counts = lambda n=n: counts[n]
    with daemons["a"] as da, daemons["b"] as db:
        backends = tuple(
            T.BackendSpec(n, d.cfg.socket_path, f"http://127.0.0.1:{d.metrics_port}/healthz")
            for n, d in (("a", da), ("b", db))
        )
        cfg = _router_cfg(tmp_path, (), T, backends=backends, metrics_port=0, scrape_interval_s=0.2)
        with T.VerifydRouter(cfg) as router:
            client = T.VerifydClient(router.cfg.listen)
            assert client.submit(good_history(100), no_viz=True)["verdict"] == 0
            port = client.stats()["metrics_port"]
            want = {
                "a": 'verifyd_kernel_launches_total{kernel="fold_lanes",where="inline"} 7',
                "b": 'verifyd_kernel_launches_total{kernel="fold_lanes",where="children"} 3',
            }
            for n, d in (("a", da), ("b", db)):
                assert want[n] in _get(f"http://127.0.0.1:{d.metrics_port}/metrics")[1]
                assert _get(f"http://127.0.0.1:{d.metrics_port}/fleet/metrics")[0] == 404
            fleet_lines: list[str] = []
            deadline = time.monotonic() + 30
            merged = {n: w.replace("{", f'{{node="{n}",', 1) for n, w in want.items()}
            while not all(m in fleet_lines for m in merged.values()):
                assert time.monotonic() < deadline, "\n".join(fleet_lines)
                time.sleep(0.1)
                status, body = _get(f"http://127.0.0.1:{port}/fleet/metrics")
                assert status == 200
                fleet_lines = body.splitlines()
            status, slo = _get(f"http://127.0.0.1:{port}/fleet/slo")
            assert status == 200 and sorted(json.loads(slo)["nodes"]) == ["a", "b"]
            status, page = _get(f"http://127.0.0.1:{port}/fleet/dashboard")
            assert status == 200 and "<svg" in page
            status, feed = _get(f"http://127.0.0.1:{port}/fleet/dashboard.json")
            assert status == 200 and json.loads(feed)
            trace = client.trace()
            procs = {e["args"]["name"] for e in trace["traceEvents"] if e.get("ph") == "M"
                     and e.get("name") == "process_name"}
            assert {"verifyd[a]", "verifyd[b]"} <= procs
            assert any(e.get("cat") == "router" for e in trace["traceEvents"] if e.get("ph") == "X")
            assert sorted(trace["otherData"]["router_backends"]) == ["a", "b"]


# -- the route CLI as processes ------------------------------------------------


def _env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))


def _popen(tmp_path, tag: str, *argv) -> subprocess.Popen:
    err = open(tmp_path / f"{tag}.stderr", "w", encoding="utf-8")
    return subprocess.Popen([sys.executable, "-m", PORT, *argv], env=_env(), cwd=str(tmp_path),
                            stdout=subprocess.DEVNULL, stderr=err)


def _wait_sock(proc: subprocess.Popen, sock: str, tag: str, tmp_path) -> None:
    deadline = time.monotonic() + 120
    while not os.path.exists(sock):
        assert proc.poll() is None, (tmp_path / f"{tag}.stderr").read_text()[-3000:]
        assert time.monotonic() < deadline, f"{tag}: no socket"
        time.sleep(0.05)


def _cli(*argv) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", PORT, *argv], env=_env(), capture_output=True, text=True,
                          timeout=120)


def test_route_cli_serves_drains_and_undrains_over_serve_processes(tmp_path):
    procs = {}
    try:
        for n in "ab":
            procs[n] = _popen(tmp_path, n, "serve", "-socket", str(tmp_path / f"{n}.sock"), "--device", "off",
                              "--state-dir", str(tmp_path / f"state-{n}"), "--drain-timeout", "10", "--no-viz")
        for n in "ab":
            _wait_sock(procs[n], str(tmp_path / f"{n}.sock"), n, tmp_path)
        rsock = str(tmp_path / "r.sock")
        procs["r"] = _popen(tmp_path, "r", "route", "serve", "--listen", rsock,
                            "--backend", f"a={tmp_path / 'a.sock'}", "--backend", f"b={tmp_path / 'b.sock'}",
                            "--state-dir", str(tmp_path / "state-r"), "--probe-interval", "0.2")
        _wait_sock(procs["r"], rsock, "r", tmp_path)
        fleet = _cli("route", "fleet", "-socket", rsock)
        assert fleet.returncode == 0, fleet.stderr
        assert fleet.stdout.splitlines()[0] == "ring: 2 nodes × 64 replicas"
        assert [line.split(":")[0].strip() for line in fleet.stdout.splitlines()[1:]] == ["a", "b"]
        view = json.loads(_cli("route", "fleet", "-socket", rsock, "--json").stdout)
        assert [b["name"] for b in view["backends"]] == ["a", "b"]
        for verdict, text in ((0, good_history(100)), (1, bad_history(100))):
            path = tmp_path / f"h{verdict}.jsonl"
            path.write_text(text)
            got = _cli("submit", "-socket", rsock, "-file", str(path), "--deadline", "30", "-stats")
            assert got.returncode == verdict, got.stderr
            line = json.loads(got.stdout.strip().splitlines()[-1])
            assert line["outcome"] == ("ok", "illegal")[verdict]
        drain = _cli("route", "drain", "a", "-socket", rsock)
        assert drain.returncode == 0, drain.stderr
        assert procs["a"].wait(timeout=60) == 0
        view = json.loads(_cli("route", "fleet", "-socket", rsock, "--json").stdout)
        assert {b["name"]: b["draining"] for b in view["backends"]} == {"a": True, "b": False}
        path = tmp_path / "h2.jsonl"
        path.write_text(good_history(5000))
        assert _cli("submit", "-socket", rsock, "-file", str(path)).returncode == 0
        assert _cli("route", "undrain", "a", "-socket", rsock).returncode == 0
        view = json.loads(_cli("route", "fleet", "-socket", rsock, "--json").stdout)
        assert not any(b["draining"] for b in view["backends"])
        assert _cli("route", "drain", "nope", "-socket", rsock).returncode == 76
        assert _cli("route", "fleet", "-socket", str(tmp_path / "none.sock")).returncode == 69
        procs["r"].terminate()
        assert procs["r"].wait(timeout=60) == 0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# -- chip_smoke's phase 18 on the CPU -----------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleet_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.run_fleet_phase`` end to end with ``device="cpu"``: the
    backends escalate inline on the CPU (``--torch-device cpu``), a
    stand-in for the card's name, a plain re-check of the recorded fold
    calls, and adversarial k=9, batch=4 in place of k=10 (it outlasts a
    0.5 s CPU budget), so every step (a)–(f) runs as on the card."""
    smoke = _chip_smoke()
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    dev_mod = importlib.import_module(f"{PORT}.checker.device")
    adversarial_events = importlib.import_module(f"{PORT}.collector.adversarial").adversarial_events
    rechecked = []

    def recheck(calls, what):
        rechecked.append((len(calls), what))
        return [0] * len(calls)

    out = smoke.run_fleet_phase(dev_mod, SimpleNamespace(card=lambda: "a CPU rehearsal"), T.prepare, recheck,
                                adversarial_events(9, batch=4, seed=0), device="cpu", budget_s=0.5)
    assert rechecked and rechecked[0][0] > 0 and rechecked[0][1] == "the fleet (phase 18)"
    walls = set(out["walls"])
    assert {"(a) routed k=10", "(b) orphan replay in the daemon", "(d) distributed search", "(e) drain a",
            "(f) soak"} <= walls
    assert out["walls"]["(b) orphan replay in the daemon"] > 0
    assert len(out["launches_by_path"]) == 4
