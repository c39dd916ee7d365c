"""Live dashboard: a retained scrape ring rendered as a zero-dependency
HTML page (``GET /dashboard`` on the obs httpd) and a JSON series feed
(``GET /dashboard.json``).

The port's copy of the JAX package's ``obs/dashboard.py``.  The
``compiles`` series reads ``verifyd_jit_compiles_total``, which in the
port counts the lazy ``nvcc`` / ``g++`` library builds
(``obs/introspect.py``).

A small sampler thread reads the daemon's own metric families — the same
numbers a Prometheus scrape would see — into a bounded ring, so the page
needs no external TSDB: sparklines are server-side inline SVG, the page
is one self-contained document (no scripts, no fetches, works through an
SSH port forward), and a ``<meta http-equiv="refresh">`` keeps it live.

Series retained per tick: throughput (completed jobs/s over the tick),
queue depth, SLO fast-window burn rate, device-lease occupancy, kernel
library builds (builds/tick), and host RSS.
"""

from __future__ import annotations

import html
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["Dashboard", "render_sparkline", "SERIES"]

#: retained series, in display order: (key, title, unit)
SERIES = (
    ("throughput", "throughput", "jobs/s"),
    ("queue_depth", "queue depth", "jobs"),
    ("slo_burn", "SLO burn (fast window)", "x"),
    ("leases", "devices leased", "devices"),
    ("compiles", "library builds", "per tick"),
    ("rss_mb", "host RSS", "MiB"),
)


def _counter_total(registry, name: str) -> float:
    """Sum of all series of a counter family (0.0 when unregistered)."""
    m = registry.get(name)
    if m is None:
        return 0.0
    try:
        return float(sum(m.snapshot().values()))
    except (TypeError, ValueError, AttributeError):
        return 0.0


def _gauge_value(registry, name: str) -> float:
    m = registry.get(name)
    if m is None:
        return 0.0
    try:
        return float(m.value())
    except (TypeError, ValueError, AttributeError):
        return 0.0


def render_sparkline(
    values: Sequence[float], *, width: int = 280, height: int = 48
) -> str:
    """One series as an inline SVG polyline (self-contained, no scripts)."""
    vals = [float(v) for v in values]
    if not vals:
        return (
            f'<svg class="spark" width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}"></svg>'
        )
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    n = len(vals)
    step = width / max(1, n - 1)
    pts = []
    for i, v in enumerate(vals):
        x = 0.0 if n == 1 else i * step
        y = height - 4 - (v - lo) / span * (height - 8)
        pts.append(f"{x:.1f},{y:.1f}")
    return (
        f'<svg class="spark" width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}" preserveAspectRatio="none">'
        f'<polyline fill="none" stroke="#2a7ae2" stroke-width="1.5" '
        f'points="{" ".join(pts)}"/></svg>'
    )


class Dashboard:
    """Retained scrape ring + HTML/JSON renderers.

    ``start_thread=False`` leaves sampling to the caller (tests call
    :meth:`sample_once` directly; the daemon runs the thread).
    """

    def __init__(
        self,
        registry,
        *,
        health=None,
        sampler=None,
        interval_s: float = 2.0,
        capacity: int = 240,
        time_fn: Callable[[], float] = time.time,
        title: str = "verifyd",
        progress_fn: Optional[Callable[[], List[dict]]] = None,
    ) -> None:
        self.registry = registry
        self.health = health
        self.sampler = sampler
        #: zero-arg callable returning per-active-job progress rows
        #: (service/progress.py JobProgress.rows); sampled on the SAME
        #: tick as the metric series — no extra thread for the panel
        self.progress_fn = progress_fn
        self.interval_s = max(0.2, float(interval_s))
        self.title = title
        self._time = time_fn
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(2, int(capacity)))
        self._prev_completed: Optional[float] = None
        self._prev_compiles: Optional[float] = None
        self._prev_t: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ------------------------------------------------------------

    def sample_once(self) -> Dict[str, float]:
        now = self._time()
        completed = _counter_total(self.registry, "verifyd_jobs_completed_total")
        compiles = _counter_total(self.registry, "verifyd_jit_compiles_total")
        # sample_once is both the sampler thread's tick body and a public
        # entry (the /dashboard handler samples inline when the ring is
        # cold): the prev_* delta baseline is a read-then-write, so an
        # interleaved pair of calls would both diff against the same
        # baseline and double-count the interval's throughput.
        with self._lock:
            dt = (now - self._prev_t) if self._prev_t is not None else None
            throughput = 0.0
            compile_rate = 0.0
            if dt and dt > 0:
                throughput = max(0.0, completed - (self._prev_completed or 0.0)) / dt
                compile_rate = max(0.0, compiles - (self._prev_compiles or 0.0))
            self._prev_t, self._prev_completed, self._prev_compiles = (
                now,
                completed,
                compiles,
            )
        burn = 0.0
        if self.health is not None:
            try:
                snap = self.health.snapshot()
                windows = snap.get("windows") or {}
                if windows:
                    first = sorted(
                        windows.items(), key=lambda kv: kv[1].get("seconds", 0)
                    )[0][1]
                    burn = float(first.get("burn_rate", 0.0))
            except Exception:
                burn = 0.0
        rss = _gauge_value(self.registry, "verifyd_resource_rss_bytes")
        sample = {
            "t": round(now, 3),
            "throughput": round(throughput, 3),
            "queue_depth": _gauge_value(self.registry, "verifyd_queue_depth"),
            "slo_burn": round(burn, 4),
            "leases": _gauge_value(self.registry, "verifyd_devices_leased"),
            "compiles": compile_rate,
            "rss_mb": round(rss / (1 << 20), 2),
        }
        if self.progress_fn is not None:
            try:
                rows = self.progress_fn() or []
            except Exception:
                rows = []
            sample["progress"] = [
                {
                    "job": r.get("job"),
                    "engine": r.get("engine"),
                    "ratio": float(r.get("progress_ratio") or 0.0),
                    "eta_s": r.get("eta_s"),
                }
                for r in rows[:16]
                if isinstance(r, dict) and not r.get("done")
            ]
        with self._lock:
            self._ring.append(sample)
        return sample

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # the dashboard must never take verifyd down
                pass

    def start(self) -> "Dashboard":
        if self._thread is None:
            self.sample_once()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="verifyd-dashboard", daemon=True
            )
            self._thread.start()
        return self

    def close(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    # -- read side -----------------------------------------------------------

    @staticmethod
    def _progress_series(
        samples: List[dict], cap: int = 8
    ) -> List[Dict[str, Any]]:
        """Per-job progress-ratio series across the retained ring.

        Jobs come from the newest sample that carried progress rows
        (the currently active set); each job's series is its ratio at
        every retained tick it appeared in, so a long-running search
        draws a climbing sparkline while short jobs show as blips.
        """
        latest: List[dict] = []
        for s in reversed(samples):
            if s.get("progress"):
                latest = s["progress"]
                break
        out = []
        for row in latest[:cap]:
            job = row.get("job")
            series = [
                p["ratio"]
                for s in samples
                for p in (s.get("progress") or ())
                if p.get("job") == job
            ]
            out.append(
                {
                    "job": job,
                    "engine": row.get("engine"),
                    "ratio": row.get("ratio", 0.0),
                    "eta_s": row.get("eta_s"),
                    "series": series,
                }
            )
        return out

    def payload(self) -> Dict[str, Any]:
        """The /dashboard.json body: retained series, oldest first."""
        with self._lock:
            samples = list(self._ring)
        return {
            "title": self.title,
            "interval_s": self.interval_s,
            "retained": len(samples),
            "t": [s["t"] for s in samples],
            "series": {
                key: [s.get(key, 0.0) for s in samples] for key, _, _ in SERIES
            },
            "progress": self._progress_series(samples),
        }

    def render_json(self) -> str:
        return json.dumps(self.payload(), sort_keys=True) + "\n"

    def render_html(self) -> str:
        """The /dashboard body: one self-contained HTML document."""
        with self._lock:
            samples = list(self._ring)
        refresh = max(1, int(round(self.interval_s)))
        rows = []
        for key, label, unit in SERIES:
            vals = [float(s.get(key, 0.0)) for s in samples]
            cur = vals[-1] if vals else 0.0
            hi = max(vals) if vals else 0.0
            rows.append(
                "<tr>"
                f"<td class=\"name\">{html.escape(label)}</td>"
                f"<td class=\"val\">{cur:g}<span class=\"unit\"> "
                f"{html.escape(unit)}</span></td>"
                f"<td class=\"peak\">peak {hi:g}</td>"
                f"<td data-series=\"{html.escape(key)}\">"
                f"{render_sparkline(vals)}</td>"
                "</tr>"
            )
        progress_rows = []
        for p in self._progress_series(samples):
            eta = p.get("eta_s")
            eta_txt = f"{float(eta):.0f}s left" if eta is not None else "—"
            progress_rows.append(
                "<tr>"
                f"<td class=\"name\">job {html.escape(str(p['job']))}"
                f"<span class=\"unit\"> {html.escape(str(p.get('engine') or ''))}"
                "</span></td>"
                f"<td class=\"val\">{100.0 * float(p.get('ratio') or 0.0):.1f}"
                "<span class=\"unit\"> %</span></td>"
                f"<td class=\"peak\">{html.escape(eta_txt)}</td>"
                "<td data-series=\"progress\">"
                f"{render_sparkline(p.get('series') or [])}</td>"
                "</tr>"
            )
        progress_html = ""
        if progress_rows:
            progress_html = (
                "<h1>active searches</h1>"
                f"<table>{''.join(progress_rows)}</table>"
            )
        when = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(self._time()))
        return (
            "<!DOCTYPE html>\n"
            "<html><head><meta charset=\"utf-8\">"
            f"<meta http-equiv=\"refresh\" content=\"{refresh}\">"
            f"<title>{html.escape(self.title)} dashboard</title>"
            "<style>"
            "body{font:14px/1.4 system-ui,sans-serif;margin:2em;"
            "background:#fbfbfb;color:#222}"
            "table{border-collapse:collapse}"
            "td{padding:.35em .9em;border-bottom:1px solid #e4e4e4;"
            "vertical-align:middle}"
            "td.name{font-weight:600}"
            "td.val{font-variant-numeric:tabular-nums;text-align:right}"
            "td.peak{color:#888;font-size:12px}"
            ".unit{color:#888;font-size:12px}"
            "svg.spark{display:block}"
            "h1{font-size:18px}footer{margin-top:1.5em;color:#888;"
            "font-size:12px}"
            "</style></head><body>"
            f"<h1>{html.escape(self.title)} — live dashboard</h1>"
            f"<table>{''.join(rows)}</table>"
            f"{progress_html}"
            f"<footer>{len(samples)} samples retained · "
            f"{self.interval_s:g}s tick · rendered {when} · "
            "also: <code>/dashboard.json</code>, <code>/metrics</code>, "
            "<code>/slo</code></footer>"
            "</body></html>\n"
        )
