"""Overload protection: deadlines, quarantine, shedding, degradation.

Four cooperating pieces, one per failure mode a production verifyd must
survive:

``CancelToken``
    One per job, threaded from admission through the scheduler into the
    supervised child.  Set-once with a reason (``deadline`` /
    ``client_gone`` / ``shutdown``); searches poll :meth:`check` at
    layer boundaries instead of being preempted, so cancellation is
    cooperative and leases release through the normal ``finally`` path.

``QuarantineStore``
    Persistent per-fingerprint crash ledger under ``--state-dir``.  A
    fingerprint observed in-flight across >= threshold process deaths
    (or supervised-child kills) is quarantined: boot-time orphan replay
    skips it and fresh submits are answered with the **definite**
    ``Quarantined`` error until an operator releases it.  This turns
    the poison-job crash loop — die, replay the orphan, die again —
    into a non-event.

``AdmissionController``
    Pre-admission shedding on host pressure: RSS against a
    ``--max-rss-frac`` watermark, fd headroom against ``RLIMIT_NOFILE``,
    and deadline feasibility against per-shape observed wall time.
    Sheds answer immediately with an honest ``retry_after`` instead of
    queueing work the host cannot finish.  Resource reads are cached
    for a short interval so the hot submit path stays cheap.

``DegradedWriter``
    One ENOSPC/OSError policy for every durable writer (journal, cache
    seglog, archive, flight recorder): the first failure flips the
    writer into a degraded memory-only mode (counted, evented, surfaced
    on /healthz for the journal), subsequent appends are dropped
    cheaply, and a periodic re-probe re-arms the writer when space
    returns.  The ``VERIFYD_FAULT_ENOSPC_FILE`` environment shim lets
    the chaos harness inject ENOSPC deterministically without filling a
    real filesystem.
"""

from __future__ import annotations

import errno
import json
import os
import resource
import threading
import time
from typing import Callable, Optional

__all__ = [
    "CancelToken",
    "QuarantineStore",
    "AdmissionController",
    "DegradedWriter",
    "FAULT_ENOSPC_ENV",
]

#: While the file this variable points at exists — and is empty or holds
#: the writer's name — DegradedWriter.run raises a synthetic ENOSPC
#: instead of calling through.  Fault injection for `make overload`;
#: zero overhead when the variable is unset.
FAULT_ENOSPC_ENV = "VERIFYD_FAULT_ENOSPC_FILE"


class CancelToken:
    """Set-once cooperative cancellation flag with an optional deadline.

    Thread-safe: the submit path arms it, scheduler workers and the
    supervised-child babysitter poll it, and the acceptor's client-gone
    watcher may fire it — all from different threads.  First reason
    wins; a deadline expiry observed by :meth:`check` self-cancels with
    reason ``"deadline"``.
    """

    __slots__ = ("_lock", "_reason", "deadline_at")

    def __init__(self, deadline_at: Optional[float] = None) -> None:
        self._lock = threading.Lock()
        self._reason: Optional[str] = None
        #: absolute time.monotonic() deadline, or None for unbounded
        self.deadline_at = deadline_at

    def cancel(self, reason: str) -> bool:
        """Arm the token; returns True if this call set it first."""
        with self._lock:
            if self._reason is None:
                self._reason = reason
                return True
            return False

    def check(self) -> Optional[str]:
        """Reason if cancelled (auto-cancelling on a passed deadline)."""
        with self._lock:
            if self._reason is None and self.deadline_at is not None:
                if time.monotonic() >= self.deadline_at:
                    self._reason = "deadline"
            return self._reason

    def remaining(self) -> Optional[float]:
        """Seconds until the deadline (None = unbounded, 0.0 = passed)."""
        if self.deadline_at is None:
            return None
        return max(0.0, self.deadline_at - time.monotonic())

    @property
    def reason(self) -> Optional[str]:
        with self._lock:
            return self._reason


class QuarantineStore:
    """Persistent poison-job ledger: crash counts and quarantined set.

    One JSON file (atomic tmp+rename rewrite — the set is operator-scale
    small) under ``<state_dir>/quarantine/``.  ``note_crash`` is called
    once per fingerprint per observed death: at boot for every journal
    orphan that had *started* running when the process died, and live
    when a supervised child dies inconclusively.  Reaching the threshold
    moves the fingerprint to the quarantined set; ``note_success``
    forgives accumulated crashes on any conclusive verdict.
    """

    def __init__(
        self,
        dir_path: str,
        *,
        threshold: int = 3,
        stats=None,
    ) -> None:
        self.dir = dir_path
        self.path = os.path.join(dir_path, "quarantine.json")
        self.threshold = max(1, int(threshold))
        self.stats = stats
        self._lock = threading.Lock()
        self._crashes: dict[str, dict] = {}
        self._quarantined: dict[str, dict] = {}
        self._load()

    # -- persistence ----------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
            self._crashes = dict(data.get("crashes", {}))
            self._quarantined = dict(data.get("quarantined", {}))
        except (OSError, ValueError, TypeError):
            pass

    def _persist_locked(self) -> None:
        """Atomic rewrite; an unwritable disk loses only counter deltas —
        the ledger itself degrades gracefully like every other writer."""
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "crashes": self._crashes,
                        "quarantined": self._quarantined,
                    },
                    f,
                    sort_keys=True,
                )
            os.replace(tmp, self.path)
        except OSError:
            pass

    # -- mutation -------------------------------------------------------

    def note_crash(self, fingerprint: str, kind: str = "boot") -> int:
        """Record one death coinciding with ``fingerprint``; quarantines
        at the threshold.  Returns the accumulated crash count."""
        if not fingerprint:
            return 0
        emit = None
        with self._lock:
            ent = self._crashes.setdefault(
                fingerprint, {"count": 0, "kinds": {}}
            )
            ent["count"] = int(ent.get("count", 0)) + 1
            kinds = ent.setdefault("kinds", {})
            kinds[kind] = int(kinds.get(kind, 0)) + 1
            count = ent["count"]
            if (
                count >= self.threshold
                and fingerprint not in self._quarantined
            ):
                self._quarantined[fingerprint] = {
                    "crashes": count,
                    "kinds": dict(kinds),
                    "since": time.time(),
                }
                emit = ("job_quarantined", count, kind)
            self._persist_locked()
            size = len(self._quarantined)
        if emit is not None and self.stats is not None:
            self.stats.emit(
                "job_quarantined",
                fingerprint=fingerprint,
                crashes=emit[1],
                kind=emit[2],
                size=size,
            )
        return count

    def note_success(self, fingerprint: str) -> None:
        """A conclusive verdict forgives accumulated crashes."""
        if not fingerprint:
            return
        with self._lock:
            if self._crashes.pop(fingerprint, None) is not None:
                self._persist_locked()

    def release(self, fingerprint: str) -> bool:
        """Operator override: un-quarantine and reset the crash count."""
        with self._lock:
            ent = self._quarantined.pop(fingerprint, None)
            self._crashes.pop(fingerprint, None)
            if ent is None:
                return False
            self._persist_locked()
            size = len(self._quarantined)
        if self.stats is not None:
            self.stats.emit(
                "quarantine_release", fingerprint=fingerprint, size=size
            )
        return True

    # -- queries --------------------------------------------------------

    def is_quarantined(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._quarantined

    def get(self, fingerprint: str) -> Optional[dict]:
        with self._lock:
            ent = self._quarantined.get(fingerprint)
            return dict(ent, fingerprint=fingerprint) if ent else None

    def crash_count(self, fingerprint: str) -> int:
        with self._lock:
            ent = self._crashes.get(fingerprint)
            return int(ent.get("count", 0)) if ent else 0

    def list(self) -> list[dict]:
        with self._lock:
            return [
                dict(ent, fingerprint=fp)
                for fp, ent in sorted(self._quarantined.items())
            ]

    def __len__(self) -> int:
        with self._lock:
            return len(self._quarantined)


def _read_meminfo_total() -> int:
    try:
        with open("/proc/meminfo", encoding="ascii") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def _read_self_rss() -> int:
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        return 0


def _count_open_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0


class AdmissionController:
    """Shed-before-queue decisions on host pressure and deadline math.

    ``decide`` returns ``None`` to admit or a shed reason from the
    bounded set ``{"rss", "fds", "deadline"}``.  Resource probes are
    cached for ``cache_s`` so a 300+ jobs/s submit stream does not churn
    /proc; the sampler's last sample is preferred when one is armed.
    """

    #: shed when open fds pass this fraction of RLIMIT_NOFILE
    FD_FRAC = 0.9

    def __init__(
        self,
        stats=None,
        *,
        max_rss_frac: float = 0.0,
        sampler=None,
        cache_s: float = 0.25,
        rss_fn: Callable[[], int] = _read_self_rss,
        fds_fn: Callable[[], int] = _count_open_fds,
    ) -> None:
        self.stats = stats
        self.max_rss_frac = float(max_rss_frac or 0.0)
        self.sampler = sampler
        self.cache_s = cache_s
        self._rss_fn = rss_fn
        self._fds_fn = fds_fn
        self._mem_total = _read_meminfo_total()
        try:
            self._fd_limit = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
        except (OSError, ValueError):
            self._fd_limit = 0
        self._lock = threading.Lock()
        self._probed_at = 0.0
        self._rss = 0
        self._fds = 0

    def _probe(self) -> tuple[int, int]:
        now = time.monotonic()
        with self._lock:
            if now - self._probed_at < self.cache_s:
                return self._rss, self._fds
            self._probed_at = now
        rss = fds = 0
        sample = None
        if self.sampler is not None:
            try:
                sample = self.sampler.snapshot().get("last")
            except Exception:
                sample = None
        if isinstance(sample, dict):
            rss = int(sample.get("rss_bytes") or 0)
            fds = int(sample.get("fds") or 0)
        if not rss:
            rss = self._rss_fn()
        if not fds:
            fds = self._fds_fn()
        with self._lock:
            self._rss, self._fds = rss, fds
        return rss, fds

    def decide(
        self,
        *,
        queue_depth: int = 0,
        deadline_s: Optional[float] = None,
        shape: Optional[str] = None,
    ) -> Optional[str]:
        """None = admit; else the shed reason (bounded cardinality)."""
        if self.max_rss_frac > 0 and self._mem_total > 0:
            rss, fds = self._probe()
            if rss > self.max_rss_frac * self._mem_total:
                return "rss"
            if (
                self._fd_limit
                and self._fd_limit != resource.RLIM_INFINITY
                and fds > self.FD_FRAC * self._fd_limit
            ):
                return "fds"
        if deadline_s is not None and self.stats is not None and shape:
            try:
                wall = self.stats.predicted_wall_s(shape)
            except Exception:
                wall = 0.0
            if wall > 0:
                # Queue ETA + this job's own predicted wall: a deadline
                # the host has never met for this shape is shed honestly
                # at the door rather than cancelled after queueing.
                eta = queue_depth * wall + wall
                if eta > deadline_s:
                    return "deadline"
        return None


class DegradedWriter:
    """One degrade/recover policy for a durable append path.

    ``run(fn)`` calls through while armed.  The first ``OSError`` (or
    injected ENOSPC) flips the writer degraded: the failure is counted
    and evented (``writer_degraded``), ``on_degrade`` fires (the journal
    uses it to mark /healthz), and subsequent appends are *dropped*
    without touching the disk except for one re-probe attempt every
    ``reprobe_s``.  A successful re-probe re-arms the writer and events
    ``writer_recovered`` with the number of drops.
    """

    def __init__(
        self,
        name: str,
        stats=None,
        *,
        reprobe_s: float = 5.0,
        on_degrade: Optional[Callable[[str], None]] = None,
        on_recover: Optional[Callable[[], None]] = None,
    ) -> None:
        self.name = name
        self.stats = stats
        self.reprobe_s = reprobe_s
        self.on_degrade = on_degrade
        self.on_recover = on_recover
        self._lock = threading.Lock()
        self._degraded = False
        self._degraded_at = 0.0
        self._last_probe = 0.0
        self._drops = 0
        self._error = ""

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    @property
    def drops(self) -> int:
        with self._lock:
            return self._drops

    def _maybe_inject_fault(self) -> None:
        path = os.environ.get(FAULT_ENOSPC_ENV)
        if not path:
            return
        try:
            with open(path, encoding="utf-8") as f:
                targets = f.read().split()
        except OSError:
            return  # file absent → fault disarmed
        if not targets or self.name in targets:
            raise OSError(errno.ENOSPC, "injected: no space left on device")

    def run(self, fn: Callable[[], object], default=None):
        """Returns ``(value, ok)``: ``fn()``'s result and whether the
        append actually landed.  Degraded calls return ``(default,
        False)`` without invoking ``fn`` except on re-probe ticks."""
        now = time.monotonic()
        with self._lock:
            if self._degraded and now - self._last_probe < self.reprobe_s:
                self._drops += 1
                return default, False
            self._last_probe = now
            was_degraded = self._degraded
        try:
            self._maybe_inject_fault()
            value = fn()
        except OSError as e:
            self._note_failure(e, was_degraded)
            return default, False
        if was_degraded:
            self._note_recovery()
        return value, True

    def _note_failure(self, e: OSError, was_degraded: bool) -> None:
        with self._lock:
            self._error = f"{e.__class__.__name__}: {e}"
            if self._degraded:
                self._drops += 1
                return
            self._degraded = True
            self._degraded_at = time.time()
            self._drops = 1
        if self.stats is not None:
            self.stats.emit(
                "writer_degraded", writer=self.name, error=str(e)
            )
        if self.on_degrade is not None:
            try:
                self.on_degrade(str(e))
            except Exception:
                pass

    def _note_recovery(self) -> None:
        with self._lock:
            self._degraded = False
            drops, self._drops = self._drops, 0
            self._error = ""
        if self.stats is not None:
            self.stats.emit(
                "writer_recovered", writer=self.name, drops=drops
            )
        if self.on_recover is not None:
            try:
                self.on_recover()
            except Exception:
                pass

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "writer": self.name,
                "degraded": self._degraded,
                "drops": self._drops,
                "error": self._error,
                "degraded_at": self._degraded_at or None,
            }
