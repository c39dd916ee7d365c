"""Stdlib-only HTTP listener: /metrics, /healthz, /slo, /dashboard.

One ThreadingHTTPServer on a daemon thread per daemon process.  Port 0
binds an ephemeral port (the bound port is readable via ``.port``).
There is deliberately no write surface here.

The port's copy of the JAX package's ``obs/httpd.py``.  It adds
``refresh``: a callable run before every ``/metrics`` render, through
which the daemon copies its kernel launch counts into
``verifyd_kernel_launches_total``.

Endpoints:

- ``GET /metrics`` — Prometheus text exposition.  When a health engine
  is attached, its gauges are refreshed *before* rendering so a scrape
  never sees stale SLO numbers.  Clients that negotiate
  ``Accept: application/openmetrics-text`` get the OpenMetrics
  exposition instead — same families, plus histogram exemplars
  (bucket → ``trace_id``) and the ``# EOF`` terminator.
- ``GET /healthz`` — a *real* health check: 200 with ``{"status":"ok"}``
  when within SLO, **503** with ``{"status":"degraded","reasons":[…]}``
  when a burn threshold or latency target is blown.  Load balancers key
  off the status code; humans and alerting key off the JSON reasons.
  Without a health engine it degrades to the old static 200 "ok".
- ``GET /slo`` — the full SLO snapshot (all windows, quantiles, burn
  rates, breach history) as JSON.
- ``GET /sentinel`` — the perf-regression sentinel's per-shape EWMA
  baselines and trip counts as JSON (404 without a sentinel).
- ``GET /dashboard`` — a self-contained zero-dependency HTML page with
  server-side SVG sparklines over the retained scrape ring (404 without
  a dashboard); ``GET /dashboard.json`` is the raw series feed.
- ``GET /fleet/metrics`` / ``/fleet/slo`` / ``/fleet/dashboard`` /
  ``/fleet/dashboard.json`` — the federated fleet plane (404 without a
  federator; only the router attaches one): every backend's families
  merged under a ``node`` label, the fleet SLO rollup, and the fleet
  board.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Callable, Optional

from .metrics import OPENMETRICS_CONTENT_TYPE, MetricsRegistry

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (health ← metrics)
    from .dashboard import Dashboard
    from .federate import FleetScraper
    from .health import SLOHealth
    from .sentinel import PerfSentinel

__all__ = ["MetricsServer", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_JSON_TYPE = "application/json; charset=utf-8"
_HTML_TYPE = "text/html; charset=utf-8"


class MetricsServer:
    """Background /metrics + /healthz + /slo server bound to ``host:port``."""

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int,
        host: str = "127.0.0.1",
        *,
        health: "Optional[SLOHealth]" = None,
        sentinel: "Optional[PerfSentinel]" = None,
        dashboard: "Optional[Dashboard]" = None,
        federator: "Optional[FleetScraper]" = None,
        refresh: Optional[Callable[[], None]] = None,
    ) -> None:
        self.registry = registry
        self.health = health
        self.sentinel = sentinel
        self.dashboard = dashboard
        self.federator = federator
        self.refresh = refresh

        server = self

        class _Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    if server.health is not None:
                        server.health.refresh()
                    if server.refresh is not None:
                        server.refresh()
                    accept = self.headers.get("Accept", "") or ""
                    if "application/openmetrics-text" in accept:
                        self._reply(
                            200,
                            server.registry.render_openmetrics().encode("utf-8"),
                            OPENMETRICS_CONTENT_TYPE,
                        )
                    else:
                        self._reply(
                            200,
                            server.registry.render().encode("utf-8"),
                            CONTENT_TYPE,
                        )
                elif path == "/healthz":
                    if server.health is None:
                        self._reply(200, b"ok\n", "text/plain; charset=utf-8")
                        return
                    healthy, body = server.health.healthz()
                    self._reply(
                        200 if healthy else 503,
                        (json.dumps(body, sort_keys=True) + "\n").encode("utf-8"),
                        _JSON_TYPE,
                    )
                elif path == "/slo" and server.health is not None:
                    snap = server.health.refresh()
                    self._reply(
                        200,
                        (json.dumps(snap, sort_keys=True) + "\n").encode("utf-8"),
                        _JSON_TYPE,
                    )
                elif path == "/sentinel" and server.sentinel is not None:
                    snap = server.sentinel.snapshot()
                    self._reply(
                        200,
                        (json.dumps(snap, sort_keys=True) + "\n").encode("utf-8"),
                        _JSON_TYPE,
                    )
                elif path == "/dashboard" and server.dashboard is not None:
                    self._reply(
                        200,
                        server.dashboard.render_html().encode("utf-8"),
                        _HTML_TYPE,
                    )
                elif path == "/dashboard.json" and server.dashboard is not None:
                    self._reply(
                        200,
                        server.dashboard.render_json().encode("utf-8"),
                        _JSON_TYPE,
                    )
                elif path == "/fleet/metrics" and server.federator is not None:
                    self._reply(
                        200,
                        server.federator.render().encode("utf-8"),
                        CONTENT_TYPE,
                    )
                elif path == "/fleet/slo" and server.federator is not None:
                    snap = server.federator.slo_rollup()
                    self._reply(
                        200,
                        (json.dumps(snap, sort_keys=True) + "\n").encode("utf-8"),
                        _JSON_TYPE,
                    )
                elif (
                    path == "/fleet/dashboard" and server.federator is not None
                ):
                    self._reply(
                        200,
                        server.federator.render_html().encode("utf-8"),
                        _HTML_TYPE,
                    )
                elif (
                    path == "/fleet/dashboard.json"
                    and server.federator is not None
                ):
                    self._reply(
                        200,
                        server.federator.render_json().encode("utf-8"),
                        _JSON_TYPE,
                    )
                else:
                    self.send_error(404)

            def log_message(self, *_args) -> None:  # quiet: stats sink is the log
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="verifyd-metrics",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self, timeout: Optional[float] = 2.0) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=timeout)
