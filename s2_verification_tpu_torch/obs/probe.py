"""Backend health probing + circuit breaking for the router tier.

Two small, separately testable pieces the fleet router composes per
backend:

- :class:`CircuitBreaker` — the classic closed → open → half-open state
  machine over *request* outcomes.  Consecutive transport failures trip
  the breaker open; after ``reset_s`` one probe request is admitted
  (half-open); its success closes the breaker, its failure re-opens it.
  The clock is injectable (``time_fn``) so the state machine tests
  without sleeping, exactly like :class:`~.health.SLOHealth`.
- :class:`HealthProber` — a polling thread running one boolean probe per
  target (TCP ``ping`` op, or an HTTP ``/healthz`` GET via
  :func:`http_health_probe`) and reporting up/down *transitions* through
  ``on_change``.  Probing is liveness (is the process there at all);
  the breaker is request-path quality — the router routes only where
  both agree.

Both are stdlib-only and own no sockets beyond what the probe callables
dial, so they compose in-process for tests and in the router daemon
unchanged.  The port's copy of the JAX package's ``obs/probe.py``.
"""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Mapping, Optional

__all__ = ["CircuitBreaker", "HealthProber", "http_health_probe"]


class CircuitBreaker:
    """Closed → open → half-open breaker over request outcomes.

    ``allow()`` answers "may I send this request"; callers must follow
    every allowed request with :meth:`record_success` or
    :meth:`record_failure`.  In half-open exactly one in-flight probe is
    admitted at a time — concurrent callers are refused until the probe
    reports back.
    """

    def __init__(
        self,
        failures: int = 3,
        reset_s: float = 5.0,
        time_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        if failures < 1:
            raise ValueError(f"failure threshold must be >= 1, got {failures}")
        self.failures = failures
        self.reset_s = reset_s
        self._time = time_fn
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._time() - self._opened_at < self.reset_s:
                    return False
                # Reset window elapsed: admit one probe.
                self._state = "half_open"
                self._probing = True
                return True
            # half_open: one probe at a time.
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            self._probing = False
            if self._state == "half_open" or self._consecutive >= self.failures:
                self._state = "open"
                self._opened_at = self._time()

    def reset(self) -> None:
        """Force closed (a node verifiably rejoined, e.g. probe up-edge)."""
        self.record_success()


def http_health_probe(url: str, timeout: float = 2.0) -> bool:
    """One ``/healthz`` GET: True only on HTTP 200 — a 503 (degraded SLO)
    or an unreachable listener both read as down."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status == 200
    except (urllib.error.URLError, OSError, ValueError):
        return False


class HealthProber:
    """Poll a named set of boolean probes; report up/down transitions.

    ``probes`` maps target name → zero-arg callable returning truthy for
    up (callables bound their own timeouts).  ``on_change(name, up)``
    fires on every transition *and* on the first observation of each
    target, so consumers need no special cold-start handling.  A probe
    that raises reads as down.
    """

    def __init__(
        self,
        probes: Mapping[str, Callable[[], bool]],
        *,
        interval_s: float = 1.0,
        on_change: Optional[Callable[[str, bool], None]] = None,
    ) -> None:
        self._probes = dict(probes)
        self.interval_s = interval_s
        self.on_change = on_change
        #: last observation per target (None = never probed)
        self.status: Dict[str, Optional[bool]] = {n: None for n in self._probes}
        # probe_once is both the poller thread's tick body and a public
        # entry (router failover calls it inline on a routing miss): the
        # transition read-modify-write on ``status`` must not interleave,
        # or both callers observe the same ``prev`` and double-fire
        # on_change for one transition.
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def probe_once(self) -> Dict[str, bool]:
        """Run every probe synchronously (also the thread's tick body)."""
        out: Dict[str, bool] = {}
        for name, fn in self._probes.items():
            try:
                up = bool(fn())
            except Exception:
                up = False
            out[name] = up
            with self._lock:
                prev = self.status.get(name)
                self.status[name] = up
            if up != prev and self.on_change is not None:
                try:
                    self.on_change(name, up)
                except Exception:
                    pass
        return out

    def start(self) -> "HealthProber":
        def _loop() -> None:
            while not self._stop.is_set():
                self.probe_once()
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=_loop, name="verifyd-prober", daemon=True
        )
        self._thread.start()
        return self

    def close(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
