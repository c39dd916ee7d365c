"""Federated fleet metrics: every backend's registry, one pane of glass.

The router's ``/metrics`` exports only its *own* registry; each backend
must be scraped separately, so the fleet has no single view and a node
death reads as a missing scrape config rather than a gap in a known
series.  The :class:`FleetScraper` closes that: it polls every
backend's metrics — HTTP ``GET /metrics`` when the backend exposes an
obs httpd (derived from its ``@healthz`` probe URL), the authenticated
``stats`` op's ``metrics`` snapshot as the fallback — and merges the
families under a **closed** ``node`` label whose value set is exactly
the router's static fleet membership (``--backend`` list).

Surfaces (all served by the router's obs httpd):

- ``GET /fleet/metrics`` — the merged exposition.  Every sample line
  from every *live* node, ``node`` injected as the first label.  A node
  whose last scrape is stale contributes **no** samples — a gap, never
  zeros (zeros would read as a real measurement); only the synthetic
  ``verifyd_fleet_node_up`` family keeps reporting it at 0.
- ``GET /fleet/slo`` — the fleet-level SLO rollup: per-node
  availability/burn/health read from the scraped ``verifyd_slo_*``
  gauges, fleet-wide mins/maxes, and summed fleet throughput.
- ``GET /fleet/dashboard`` — a self-contained HTML board (same
  zero-dependency SVG sparklines as the per-daemon dashboard) with one
  retained ring per node.

The scraper also folds the merged view into the router's **own**
registry as bounded ``verifyd_fleet_*`` families (node up, per-node
throughput/queue/RSS, scrape counters, merged-series cardinality) —
which the router's TelemetryStore then records, making fleet history
durable across router restarts.

The port's copy of the JAX package's ``obs/federate.py``: the merged
families are the backends' own, so the port's
``verifyd_kernel_launches_total`` comes through ``/fleet/metrics`` with
its ``node`` label and no other change.
"""

from __future__ import annotations

import html
import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .dashboard import render_sparkline
from .metrics import MetricsRegistry
from .tsdb import flatten_snapshot, parse_series_key

__all__ = ["FleetScraper", "ScrapeTarget", "parse_exposition"]

#: one scraped sample: (metric name, labels, value)
Sample = Tuple[str, Dict[str, str], float]


class ScrapeTarget:
    """How to reach one backend's metrics: an HTTP exposition URL, a
    zero-arg stats callable returning the ``stats`` op snapshot, or both
    (HTTP preferred; the op is the fallback for metrics-portless nodes)."""

    def __init__(
        self,
        metrics_url: Optional[str] = None,
        stats_fn: Optional[Callable[[], Dict[str, Any]]] = None,
    ) -> None:
        self.metrics_url = metrics_url
        self.stats_fn = stats_fn


def parse_exposition(
    text: str,
) -> Tuple[List[Sample], Dict[str, str], Dict[str, str]]:
    """Prometheus text 0.0.4 → (samples, family types, family helps)."""
    samples: List[Sample] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else "untyped"
            elif len(parts) >= 3 and parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        key, _, raw = line.rpartition(" ")
        if not key:
            continue
        try:
            value = float(raw)
        except ValueError:
            continue
        name, labels = parse_series_key(key)
        samples.append((name, labels, value))
    return samples, types, helps


def _snapshot_samples(
    snap: Dict[str, Any],
) -> Tuple[List[Sample], Dict[str, str], Dict[str, str]]:
    """``stats`` op ``metrics`` section → the same shape as an HTTP scrape
    (histograms flattened to ``_count``/``_sum``, their family typed)."""
    samples: List[Sample] = []
    types: Dict[str, str] = {}
    for key in (snap.get("counters") or {}):
        types.setdefault(parse_series_key(key)[0], "counter")
    for key in (snap.get("gauges") or {}):
        types.setdefault(parse_series_key(key)[0], "gauge")
    for key in (snap.get("histograms") or {}):
        types.setdefault(parse_series_key(key)[0], "histogram")
    for key, value in flatten_snapshot(snap).items():
        name, labels = parse_series_key(key)
        samples.append((name, labels, value))
    return samples, types, {}


def _find(
    samples: List[Sample], name: str, **labels: str
) -> Optional[float]:
    for n, got, v in samples:
        if n != name:
            continue
        if all(got.get(ln) == lv for ln, lv in labels.items()):
            return v
    return None


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class _NodeState:
    __slots__ = (
        "samples",
        "types",
        "helps",
        "last_ok",
        "last_err",
        "scrapes",
        "errors",
        "source",
        "ring",
        "prev_completed",
        "prev_t",
        "build",
    )

    def __init__(self) -> None:
        self.samples: List[Sample] = []
        self.types: Dict[str, str] = {}
        self.helps: Dict[str, str] = {}
        self.last_ok: Optional[float] = None
        self.last_err: Optional[str] = None
        self.scrapes = 0
        self.errors = 0
        self.source: Optional[str] = None
        self.ring: deque = deque(maxlen=240)
        self.prev_completed: Optional[float] = None
        self.prev_t: Optional[float] = None
        self.build: Dict[str, str] = {}


class FleetScraper:
    """Poll every fleet member's metrics; merge, roll up, and re-export."""

    def __init__(
        self,
        registry: MetricsRegistry,
        targets: Dict[str, ScrapeTarget],
        *,
        interval_s: float = 2.0,
        stale_after_s: Optional[float] = None,
        timeout_s: float = 2.0,
        time_fn: Callable[[], float] = time.time,
        title: str = "verifyd fleet",
    ) -> None:
        self.registry = registry
        self.targets = dict(targets)
        #: frozen fleet membership — the closed value set of the ``node``
        #: label (the cardinality pass proves label values fold into it)
        self._nodes = tuple(sorted(self.targets))
        self.interval_s = max(0.2, float(interval_s))
        self.stale_after_s = (
            float(stale_after_s)
            if stale_after_s is not None
            else max(5.0, 3.0 * self.interval_s)
        )
        self.timeout_s = float(timeout_s)
        self.title = title
        self._time = time_fn
        self._lock = threading.Lock()
        self._state: Dict[str, _NodeState] = {
            name: _NodeState() for name in self._nodes
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_members = registry.gauge(
            "verifyd_fleet_nodes", "Configured fleet membership size"
        )
        self._m_members.set(float(len(self._nodes)))
        self._m_up = registry.gauge(
            "verifyd_fleet_node_up",
            "1 when the node's last scrape is fresh, 0 when stale/dead",
            labelnames=("node",),
        )
        self._m_scrapes = registry.counter(
            "verifyd_fleet_scrapes_total",
            "Successful federated scrapes, by node",
            labelnames=("node",),
        )
        self._m_errors = registry.counter(
            "verifyd_fleet_scrape_errors_total",
            "Failed federated scrapes, by node",
            labelnames=("node",),
        )
        self._m_series = registry.gauge(
            "verifyd_fleet_series",
            "Merged series count across live nodes (cardinality bound)",
        )
        self._m_jobs = registry.gauge(
            "verifyd_fleet_node_jobs_per_sec",
            "Per-node completed-job rate between scrapes",
            labelnames=("node",),
        )
        self._m_queue = registry.gauge(
            "verifyd_fleet_node_queue_depth",
            "Per-node queue depth at last scrape",
            labelnames=("node",),
        )
        self._m_rss = registry.gauge(
            "verifyd_fleet_node_rss_bytes",
            "Per-node host RSS at last scrape",
            labelnames=("node",),
        )

    # -- scraping ------------------------------------------------------------

    def _fetch(self, target: ScrapeTarget):
        """(samples, types, helps, source) from one backend, HTTP first."""
        if target.metrics_url:
            try:
                with urllib.request.urlopen(
                    target.metrics_url, timeout=self.timeout_s
                ) as resp:
                    text = resp.read().decode("utf-8", "replace")
                return (*parse_exposition(text), "http")
            except (urllib.error.URLError, OSError, ValueError):
                if target.stats_fn is None:
                    raise
        if target.stats_fn is None:
            raise OSError("no scrape path configured")
        snap = target.stats_fn() or {}
        metrics = snap.get("metrics") if isinstance(snap, dict) else None
        if not isinstance(metrics, dict):
            raise OSError("stats reply carried no metrics section")
        return (*_snapshot_samples(metrics), "stats")

    def scrape_once(self) -> Dict[str, bool]:
        """One sweep over the fleet; public for tests and the check
        script.  Returns {node: scrape succeeded}."""
        results: Dict[str, bool] = {}
        for node in self._nodes:
            target = self.targets[node]
            t0 = self._time()
            try:
                samples, types, helps, source = self._fetch(target)
            except Exception as e:  # noqa: BLE001 - any failure is a gap
                results[node] = False
                with self._lock:
                    st = self._state[node]
                    st.errors += 1
                    st.last_err = str(e) or e.__class__.__name__
                if node not in self._nodes:
                    node = "other"
                self._m_errors.inc(node=node)
                continue
            now = self._time()
            with self._lock:
                st = self._state[node]
                st.samples = samples
                st.types = types
                st.helps = helps
                st.last_ok = now
                st.last_err = None
                st.scrapes += 1
                st.source = source
                completed = _find(samples, "verifyd_jobs_completed_total")
                rate = 0.0
                if (
                    completed is not None
                    and st.prev_completed is not None
                    and st.prev_t is not None
                    and now > st.prev_t
                ):
                    rate = max(0.0, completed - st.prev_completed) / (
                        now - st.prev_t
                    )
                if completed is not None:
                    st.prev_completed, st.prev_t = completed, now
                queue = _find(samples, "verifyd_queue_depth") or 0.0
                rss = _find(samples, "verifyd_resource_rss_bytes") or 0.0
                burn = _find(samples, "verifyd_slo_burn_rate", window="fast")
                build = {}
                for n, labels, v in samples:
                    if n == "verifyd_build_info" and v:
                        build = dict(labels)
                        break
                if build:
                    st.build = build
                st.ring.append(
                    {
                        "t": round(now, 3),
                        "throughput": round(rate, 3),
                        "queue_depth": queue,
                        "slo_burn": round(burn or 0.0, 4),
                        "rss_mb": round(rss / (1 << 20), 2),
                        "scrape_s": round(now - t0, 4),
                    }
                )
            results[node] = True
            if node not in self._nodes:
                node = "other"
            self._m_scrapes.inc(node=node)
            self._m_jobs.set(rate, node=node)
            self._m_queue.set(queue, node=node)
            self._m_rss.set(rss, node=node)
        self._refresh_up()
        return results

    def _refresh_up(self) -> None:
        now = self._time()
        live = 0
        series = 0
        with self._lock:
            fresh = {
                node: (
                    st.last_ok is not None
                    and now - st.last_ok <= self.stale_after_s
                )
                for node, st in self._state.items()
            }
            for node, ok in fresh.items():
                if ok:
                    live += 1
                    series += len(self._state[node].samples)
        for node in self._nodes:
            up = 1.0 if fresh.get(node) else 0.0
            if node not in self._nodes:
                node = "other"
            self._m_up.set(up, node=node)
        self._m_series.set(float(series))

    def _live(self) -> Dict[str, _NodeState]:
        """Nodes with a fresh scrape (holding the lock is the caller's job)."""
        now = self._time()
        return {
            node: st
            for node, st in self._state.items()
            if st.last_ok is not None and now - st.last_ok <= self.stale_after_s
        }

    # -- thread --------------------------------------------------------------

    def start(self) -> "FleetScraper":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="verifyd-fleet-scraper", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # the scraper must never take the router down
                pass

    def close(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- read side -----------------------------------------------------------

    def build_info(self) -> Dict[str, Dict[str, str]]:
        """Last-seen ``verifyd_build_info`` labels per node (route fleet)."""
        with self._lock:
            return {
                node: dict(st.build)
                for node, st in self._state.items()
                if st.build
            }

    def render(self) -> str:
        """The merged ``/fleet/metrics`` exposition, ``node`` label first.

        Families are grouped across live nodes (HELP/TYPE once, first
        node's metadata wins); stale nodes contribute nothing except the
        synthetic ``verifyd_fleet_node_up`` family, which reports every
        configured member so a death reads as ``up 0`` + a gap.
        """
        with self._lock:
            live = self._live()
            families: Dict[str, Tuple[str, str]] = {}
            rows: Dict[str, List[str]] = {}
            up_lines = []
            for node in self._nodes:
                st = self._state[node]
                up_lines.append(
                    f'verifyd_fleet_node_up{{node="{_escape(node)}"}} '
                    f"{1 if node in live else 0}"
                )
                if node not in live:
                    continue
                for name, labels, value in st.samples:
                    family = name
                    for suffix in ("_bucket", "_sum", "_count"):
                        base = name[: -len(suffix)] if name.endswith(suffix) else None
                        if base and st.types.get(base) == "histogram":
                            family = base
                            break
                    if family not in families:
                        families[family] = (
                            st.types.get(family, "untyped"),
                            st.helps.get(family, ""),
                        )
                    parts = [f'node="{_escape(node)}"'] + [
                        f'{ln}="{_escape(lv)}"'
                        for ln, lv in labels.items()
                    ]
                    val = int(value) if float(value).is_integer() else value
                    rows.setdefault(family, []).append(
                        f"{name}{{{','.join(parts)}}} {val}"
                    )
        lines = [
            "# HELP verifyd_fleet_node_up 1 when the node's last scrape "
            "is fresh, 0 when stale/dead",
            "# TYPE verifyd_fleet_node_up gauge",
            *up_lines,
        ]
        for family in sorted(rows):
            kind, help_text = families[family]
            if help_text:
                lines.append(f"# HELP {family} {help_text}")
            lines.append(f"# TYPE {family} {kind}")
            lines.extend(rows[family])
        return "\n".join(lines) + "\n"

    def slo_rollup(self) -> Dict[str, Any]:
        """Fleet-level SLO picture from the scraped ``verifyd_slo_*``
        gauges: per-node availability/burn/health plus fleet extremes
        and summed throughput.  Stale nodes report ``up: False`` with no
        numbers — a gap, not a zero."""
        with self._lock:
            live = self._live()
            nodes: Dict[str, Any] = {}
            avails: List[float] = []
            burns: List[float] = []
            throughput = 0.0
            healthy_nodes = 0
            for node in self._nodes:
                st = self._state[node]
                if node not in live:
                    nodes[node] = {"up": False, "last_error": st.last_err}
                    continue
                avail = _find(
                    st.samples, "verifyd_slo_availability", window="fast"
                )
                burn = _find(
                    st.samples, "verifyd_slo_burn_rate", window="fast"
                )
                healthy = _find(st.samples, "verifyd_slo_healthy")
                rate = st.ring[-1]["throughput"] if st.ring else 0.0
                throughput += rate
                if avail is not None:
                    avails.append(avail)
                if burn is not None:
                    burns.append(burn)
                ok = healthy is None or healthy >= 0.5
                if ok:
                    healthy_nodes += 1
                nodes[node] = {
                    "up": True,
                    "healthy": ok,
                    "availability_fast": avail,
                    "burn_rate_fast": burn,
                    "jobs_per_sec": rate,
                    "source": st.source,
                }
            up = len(live)
        return {
            "title": self.title,
            "nodes": nodes,
            "fleet": {
                "members": len(self._nodes),
                "up": up,
                "healthy_nodes": healthy_nodes,
                "healthy": up > 0 and healthy_nodes == up,
                "availability_min": min(avails) if avails else None,
                "burn_rate_max": max(burns) if burns else None,
                "jobs_per_sec": round(throughput, 3),
            },
        }

    def payload(self) -> Dict[str, Any]:
        """Raw per-node rings (the fleet board's JSON feed, and tests)."""
        with self._lock:
            live = set(self._live())
            return {
                "title": self.title,
                "interval_s": self.interval_s,
                "nodes": {
                    node: {
                        "up": node in live,
                        "scrapes": st.scrapes,
                        "errors": st.errors,
                        "source": st.source,
                        "build": dict(st.build),
                        "samples": [dict(s) for s in st.ring],
                    }
                    for node, st in self._state.items()
                },
            }

    def render_json(self) -> str:
        return json.dumps(self.payload(), sort_keys=True) + "\n"

    def render_html(self) -> str:
        """``/fleet/dashboard``: one self-contained HTML board, one row
        per (node, series) with the same inline-SVG sparklines as the
        per-daemon dashboard."""
        rollup = self.slo_rollup()
        with self._lock:
            live = set(self._live())
            node_rows = []
            for node in self._nodes:
                st = self._state[node]
                samples = list(st.ring)
                status = "up" if node in live else "DOWN"
                build = st.build
                build_txt = (
                    " · ".join(
                        f"{k}={v}" for k, v in sorted(build.items())
                    )
                    if build
                    else ""
                )
                node_rows.append(
                    f'<h2>{html.escape(node)} '
                    f'<span class="unit">{status}'
                    f'{(" · " + html.escape(build_txt)) if build_txt else ""}'
                    "</span></h2>"
                )
                series = (
                    ("throughput", "jobs/s"),
                    ("queue_depth", "jobs"),
                    ("slo_burn", "x"),
                    ("rss_mb", "MiB"),
                )
                rows = []
                for key, unit in series:
                    vals = [float(s.get(key, 0.0)) for s in samples]
                    cur = vals[-1] if vals else 0.0
                    rows.append(
                        "<tr>"
                        f'<td class="name">{html.escape(key)}</td>'
                        f'<td class="val">{cur:g}<span class="unit"> '
                        f"{html.escape(unit)}</span></td>"
                        f"<td>{render_sparkline(vals)}</td>"
                        "</tr>"
                    )
                node_rows.append(f"<table>{''.join(rows)}</table>")
        fleet = rollup["fleet"]
        refresh = max(1, int(round(self.interval_s)))
        when = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(self._time())
        )
        return (
            "<!DOCTYPE html>\n"
            '<html><head><meta charset="utf-8">'
            f'<meta http-equiv="refresh" content="{refresh}">'
            f"<title>{html.escape(self.title)}</title>"
            "<style>"
            "body{font:14px/1.4 system-ui,sans-serif;margin:2em;"
            "background:#fbfbfb;color:#222}"
            "table{border-collapse:collapse;margin-bottom:1em}"
            "td{padding:.35em .9em;border-bottom:1px solid #e4e4e4;"
            "vertical-align:middle}"
            "td.name{font-weight:600}"
            "td.val{font-variant-numeric:tabular-nums;text-align:right}"
            ".unit{color:#888;font-size:12px}"
            "svg.spark{display:block}"
            "h1{font-size:18px}h2{font-size:15px}"
            "footer{margin-top:1.5em;color:#888;font-size:12px}"
            "</style></head><body>"
            f"<h1>{html.escape(self.title)} — "
            f"{fleet['up']}/{fleet['members']} up · "
            f"{fleet['jobs_per_sec']:g} jobs/s"
            "</h1>"
            f"{''.join(node_rows)}"
            f"<footer>{self.interval_s:g}s scrape · rendered {when} · "
            "also: <code>/fleet/metrics</code>, <code>/fleet/slo</code>"
            "</footer></body></html>\n"
        )
