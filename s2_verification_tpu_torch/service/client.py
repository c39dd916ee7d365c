"""Client side of the verifyd protocol (the ``submit`` CLI's engine).

Synchronous blocking sockets, one connection per request — the same
connection discipline as the collector transport's setup path
(``collector/socket_s2.py:snapshot_bodies``).  ``submit`` keeps its
connection open until the daemon replies with the verdict; everything
else answers immediately.

The address selects the transport: a filesystem path dials the unix
socket unchanged; ``host:port`` (with a ``secret``) dials the
authenticated TCP listener, signing every request frame and verifying
every reply with the protocol's HMAC (:func:`.protocol.sign_frame`).

Failures divide into two classes the retry loop treats differently:

* :class:`VerifydUnavailable` — no daemon ever *answered* (connect
  refused/timed out).  Retried with exponential backoff + jitter; if it
  never clears, the CLI exits 69 (EX_UNAVAILABLE).
* :class:`VerifydRefused` — a daemon was reached but the exchange failed
  at the transport layer (connection lost mid-call, garbled/unsigned
  reply, ``FrameError``/``FrameTooLarge``/``AuthError`` replies).
  Transient flavors (lost connection, frame noise) are retried the same
  way; a refusal that persists exits 76 (EX_PROTOCOL) — *distinct* from
  69, because "something is there and saying no" needs a different fix
  than "nothing is listening".

Backpressure (``QueueFull`` → :class:`VerifydBusy`) keeps its own loop:
the daemon's ``retry_after_s`` hint takes precedence over the backoff
schedule.  Semantic errors (``DecodeError``: the *history* is bad) are
never retried — resubmitting the same bytes cannot help.
"""

from __future__ import annotations

import json
import random
import socket
import time

from ..obs.context import TRACE_FIELD, new_trace_id, trace_frame
from .protocol import (
    ERR_AUTH,
    ERR_FRAME,
    ERR_NO_BACKEND,
    ERR_QUEUE_FULL,
    ERR_SHUTTING_DOWN,
    ERR_TOO_LARGE,
    encode_frame,
    parse_hostport,
    sign_frame,
    verify_frame,
)

__all__ = [
    "VerifydError",
    "VerifydBusy",
    "VerifydUnavailable",
    "VerifydRefused",
    "VerifydDeadlineExceeded",
    "VerifydClient",
]


class VerifydError(RuntimeError):
    """The daemon answered with an error frame."""

    def __init__(self, cls: str, msg: str, extra: dict | None = None) -> None:
        super().__init__(f"{cls}: {msg}")
        self.cls = cls
        self.msg = msg
        self.extra = extra or {}


class VerifydBusy(VerifydError):
    """Backpressure: the admission queue is full; retry after the hint."""

    @property
    def retry_after_s(self) -> float:
        return float(self.extra.get("retry_after_s", 1.0))


class VerifydUnavailable(VerifydError):
    """No daemon ever answered a connect (CLI exit 69, EX_UNAVAILABLE)."""


class VerifydDeadlineExceeded(VerifydUnavailable):
    """``submit --deadline`` wall-clock budget spent before any attempt
    succeeded (CLI exit 69 — the service was effectively unavailable for
    the whole window the caller was willing to wait)."""

    def __init__(self, deadline_s: float, attempts: int, last: str) -> None:
        super().__init__(
            "DeadlineExceeded",
            f"deadline exceeded after {attempts} attempts"
            f" ({deadline_s:g}s budget; last error: {last})",
        )
        self.deadline_s = deadline_s
        self.attempts = attempts


class VerifydRefused(VerifydError):
    """A daemon was reached but refused or broke the exchange (CLI exit
    76, EX_PROTOCOL after retries).  ``transient`` marks flavors worth
    retrying (lost connection, line noise) vs. definite refusals (bad
    auth secret: every retry will fail identically)."""

    def __init__(
        self,
        cls: str,
        msg: str,
        extra: dict | None = None,
        *,
        transient: bool = True,
    ) -> None:
        super().__init__(cls, msg, extra)
        self.transient = transient


#: error-frame classes that are transport noise, not semantic failures
_REFUSAL_CLASSES = {ERR_FRAME, ERR_TOO_LARGE, ERR_AUTH}

#: semantic answers that are transient by contract — a draining daemon
#: restarts, a router's empty routable set refills on the next probe
#: tick — so the retry loop treats them like backoff-worthy transport
#: failures rather than definite refusals
_TRANSIENT_CLASSES = {ERR_SHUTTING_DOWN, ERR_NO_BACKEND}


class VerifydClient:
    def __init__(
        self,
        address: str,
        timeout: float | None = None,
        *,
        secret: bytes | None = None,
    ) -> None:
        #: unix-socket path, or ``host:port`` for the TCP transport
        self.address = address
        #: default per-call timeout; submit calls may override (a verdict
        #: on a hard history legitimately takes longer than a ping)
        self.timeout = timeout
        self.secret = secret
        self._hostport: tuple[str, int] | None = None
        if not address.startswith(("/", ".")) and ":" in address:
            self._hostport = parse_hostport(address)
        if self._hostport is not None and secret is None:
            raise ValueError("the TCP transport requires a shared secret")

    # retained name: tests and the CLI historically read .path
    @property
    def path(self) -> str:
        return self.address

    def _connect(self, timeout: float | None) -> socket.socket:
        try:
            if self._hostport is not None:
                return socket.create_connection(self._hostport, timeout=timeout)
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.settimeout(timeout)
                s.connect(self.address)
            except OSError:
                s.close()
                raise
            return s
        except (OSError, socket.timeout) as e:
            raise VerifydUnavailable(
                "Unavailable", f"cannot connect to {self.address}: {e}"
            ) from e

    def _call(self, req: dict, timeout: float | None = None) -> dict:
        if self.secret is not None and self._hostport is not None:
            req = sign_frame(req, self.secret)
        tmo = timeout if timeout is not None else self.timeout
        with self._connect(tmo) as s:
            try:
                s.sendall(encode_frame(req))
                buf = b""
                while b"\n" not in buf:
                    chunk = s.recv(1 << 16)
                    if not chunk:
                        raise VerifydRefused(
                            "ConnectionClosed",
                            "daemon closed the connection mid-call",
                        )
                    buf += chunk
                # One frame per line: anything past the first newline is
                # a stray duplicate reply, not part of this frame.
                buf = buf.split(b"\n", 1)[0]
            except (OSError, socket.timeout) as e:
                # Connected, then the exchange died: the daemon exists.
                raise VerifydRefused(
                    "ConnectionLost", f"exchange with {self.address} failed: {e}"
                ) from e
        try:
            resp = json.loads(buf)
        except ValueError as e:
            raise VerifydRefused("GarbledReply", f"reply is not JSON: {e}") from e
        if not isinstance(resp, dict):
            raise VerifydRefused("GarbledReply", "reply frame is not an object")
        if self.secret is not None and self._hostport is not None:
            if not verify_frame(resp, self.secret):
                # A reply we can't verify that *claims* AuthError means the
                # secrets disagree (the daemon signs with its own) — that's
                # the actionable diagnosis, and equally non-transient.
                if (
                    isinstance(resp.get("err"), dict)
                    and resp["err"].get("class") == ERR_AUTH
                ):
                    e = resp["err"]
                    raise VerifydRefused(
                        ERR_AUTH, e.get("msg", ""), e, transient=False
                    )
                raise VerifydRefused(
                    "ReplyAuth",
                    "daemon reply failed HMAC verification",
                    transient=False,
                )
        if "err" in resp:
            e = resp["err"]
            cls = e.get("class", "InternalError")
            if cls == ERR_QUEUE_FULL:
                raise VerifydBusy(cls, e.get("msg", ""), e)
            if cls in _REFUSAL_CLASSES:
                # Auth rejection is definite: the secret is wrong and
                # stays wrong.  Frame noise is worth another try.
                raise VerifydRefused(
                    cls, e.get("msg", ""), e, transient=cls != ERR_AUTH
                )
            raise VerifydError(cls, e.get("msg", ""), e)
        return resp["ok"]

    # -- ops ----------------------------------------------------------------

    def ping(self, timeout: float | None = 10.0) -> dict:
        return self._call({"op": "ping"}, timeout=timeout)

    def stats(self, timeout: float | None = 10.0) -> dict:
        return self._call({"op": "stats"}, timeout=timeout)

    def trace(self, timeout: float | None = 10.0) -> dict:
        """Fetch the daemon's span ring as Chrome trace_event JSON."""
        return self._call({"op": "trace"}, timeout=timeout)

    def profiles(self, timeout: float | None = 10.0, **filters) -> dict:
        """Query the daemon's durable profile archive.  Filters pass
        through to the ``profiles`` op: shape, backend, client, verdict,
        since, slowest, limit."""
        req = {"op": "profiles"}
        req.update({k: v for k, v in filters.items() if v is not None})
        return self._call(req, timeout=timeout)

    def shutdown(
        self,
        timeout: float | None = 10.0,
        *,
        drain: bool = False,
        drain_timeout_s: float | None = None,
    ) -> dict:
        """Stop the daemon.  With ``drain=True`` the daemon stops
        admitting, finishes in-flight work up to ``drain_timeout_s`` (its
        ``--drain-timeout`` default when None), closes the journal
        cleanly, then exits — the rolling-restart path."""
        req: dict = {"op": "shutdown"}
        if drain:
            req["drain"] = True
            if drain_timeout_s is not None:
                req["timeout"] = drain_timeout_s
        return self._call(req, timeout=timeout)

    # -- router ops (service/router.py speaks the same protocol) -------------

    def fleet(self, timeout: float | None = 10.0) -> dict:
        """Router only: ring membership + per-backend health/drain state."""
        return self._call({"op": "fleet"}, timeout=timeout)

    def drain(
        self,
        node: str,
        *,
        drain_timeout_s: float | None = None,
        timeout: float | None = None,
    ) -> dict:
        """Router only: drain ``node`` out of the fleet (stop routing,
        wait for in-flight, drain-aware backend shutdown).  The call
        blocks until the drain completes, so the default wire timeout is
        None (wait)."""
        req: dict = {"op": "drain", "node": node}
        if drain_timeout_s is not None:
            req["timeout"] = drain_timeout_s
        return self._call(req, timeout=timeout)

    def undrain(self, node: str, timeout: float | None = 10.0) -> dict:
        """Router only: return a drained node to the routable set."""
        return self._call({"op": "undrain", "node": node}, timeout=timeout)

    def quarantine(
        self,
        action: str = "list",
        fingerprint: str | None = None,
        timeout: float | None = 10.0,
    ) -> dict:
        """Poison-job quarantine ops: ``list`` / ``inspect`` / ``release``
        (the latter two take a fingerprint)."""
        req: dict = {"op": "quarantine", "action": action}
        if fingerprint is not None:
            req["fingerprint"] = fingerprint
        return self._call(req, timeout=timeout)

    def watch(
        self,
        *,
        job: int | None = None,
        fingerprint: str | None = None,
        search: str | None = None,
        part: str | int | None = None,
        timeout: float | None = 10.0,
    ) -> dict:
        """One-shot progress snapshot of running searches (``watch`` CLI
        polls this).  Selectors: ``job`` id, verdict-cache
        ``fingerprint``, distributed ``search`` id (+ optional ``part``),
        or none for every active job.  A named selector with no live
        match is the definite ``UnknownJob`` — the job finished, never
        existed, or lives on another backend (the router fans out and
        answers for the fleet)."""
        req: dict = {"op": "watch"}
        if job is not None:
            req["job"] = int(job)
        if fingerprint is not None:
            req["fingerprint"] = fingerprint
        if search is not None:
            req["search"] = search
        if part is not None:
            req["part"] = str(part)
        return self._call(req, timeout=timeout)

    def tsq(
        self,
        *,
        res: str | None = None,
        metric: str | None = None,
        labels: dict | None = None,
        since: float | None = None,
        until: float | None = None,
        limit: int | None = None,
        info: bool = False,
        timeout: float | None = 10.0,
    ) -> dict:
        """Query the node's durable telemetry history (``tsq`` CLI).
        Selectors: ``res`` ring (raw/1m/15m), ``metric`` name substring,
        ``labels`` equality filters, ``since``/``until`` wall-clock
        bounds, ``limit`` points per series.  ``info=True`` returns the
        ring inventory instead of points."""
        req: dict = {"op": "tsq"}
        if res is not None:
            req["res"] = res
        if metric is not None:
            req["metric"] = metric
        if labels:
            req["labels"] = dict(labels)
        if since is not None:
            req["since"] = float(since)
        if until is not None:
            req["until"] = float(until)
        if limit is not None:
            req["limit"] = int(limit)
        if info:
            req["info"] = True
        return self._call(req, timeout=timeout)

    def submit(
        self,
        history_text: str | None = None,
        *,
        records: list | None = None,
        client: str = "client",
        priority: int = 10,
        no_viz: bool | None = None,
        timeout: float | None = None,
        trace_id: str | None = None,
        deadline_s: float | None = None,
        distributed: bool = False,
    ) -> dict:
        """Submit one history.  Mints a distributed ``trace_id`` (unless
        the caller supplies one, e.g. across a retry loop) and sends it in
        the optional ``trace`` frame field — old daemons ignore it; new
        daemons thread it through every span and echo it back.  The reply
        always carries ``trace_id`` (filled in client-side against an old
        daemon), so callers can correlate unconditionally.

        ``deadline_s`` rides the frame as the end-to-end ``deadline``
        field: the daemon refuses admissions it cannot meet and cancels
        the search when the budget runs out mid-flight (definite
        ``DeadlineExceeded``).  Old daemons ignore the field.

        ``records`` submits the history as an already-decoded list of
        event objects instead of a JSONL string — one less
        serialize/parse round-trip on the hot path.  Exactly one of
        ``history_text`` / ``records`` must be given.

        ``distributed`` asks a router to run the search fleet-wide
        (service/distsearch.py): the frontier is partitioned by
        state-hash range across healthy backends.  Daemons and routers
        without the capability ignore the flag and route normally."""
        if (history_text is None) == (records is None):
            raise ValueError("submit takes exactly one of history_text / records")
        tid = trace_id or new_trace_id()
        req: dict = {
            "op": "submit",
            "client": client,
            "priority": priority,
            TRACE_FIELD: trace_frame(tid),
        }
        if records is not None:
            req["records"] = records
        else:
            req["history"] = history_text
        if no_viz is not None:
            req["no_viz"] = no_viz
        if deadline_s is not None:
            req["deadline"] = float(deadline_s)
        if distributed:
            req["distributed"] = True
        reply = self._call(req, timeout=timeout)
        if isinstance(reply, dict):
            reply.setdefault("trace_id", tid)
        return reply

    def grant(
        self,
        *,
        search: str,
        seg: str,
        part: str,
        epoch: int,
        timeout: float | None = 10.0,
    ) -> dict:
        """Distributed search: claim partition ownership on a backend.

        The coordinator journals the grant *before* this call, so a
        crash between journal and wire leaves an orphan grant the next
        epoch re-grants.  A backend holding a newer epoch for the same
        partition answers the definite ``EpochFenced``."""
        req = {
            "op": "grant",
            "search": search,
            "seg": seg,
            "part": part,
            "epoch": int(epoch),
        }
        return self._call(req, timeout=timeout)

    def delta(
        self,
        history_text: str,
        *,
        search: str,
        seg: str,
        part: str,
        epoch: int,
        carry: dict,
        union: bool = True,
        client: str = "distsearch",
        deadline_s: float | None = None,
        timeout: float | None = None,
        trace_id: str | None = None,
    ) -> dict:
        """Distributed search: ship one segment + partition carry and
        block for the partition's end-of-segment union.  ``carry`` is the
        prefix-carry payload (checker/prefix.py) holding this
        partition's share of the boundary state union.  The backend
        fences the epoch both on entry and again when the verdict is
        ready — a revocation that lands mid-search turns the eventual
        reply into ``EpochFenced``.  ``union=False`` (the final segment)
        skips collecting the end union — the verdict alone suffices, and
        the backend may accept early instead of materializing every
        indefinite-append layer."""
        tid = trace_id or new_trace_id()
        req: dict = {
            "op": "delta",
            "history": history_text,
            "client": client,
            "search": search,
            "seg": seg,
            "part": part,
            "epoch": int(epoch),
            "carry": carry,
            TRACE_FIELD: trace_frame(tid),
        }
        if not union:
            req["union"] = False
        if deadline_s is not None:
            req["deadline"] = float(deadline_s)
        reply = self._call(req, timeout=timeout)
        if isinstance(reply, dict):
            reply.setdefault("trace_id", tid)
        return reply

    def partition_done(
        self,
        *,
        search: str,
        part: str,
        epoch: int,
        reason: str = "done",
        timeout: float | None = 10.0,
    ) -> dict:
        """Distributed search: close (or revoke) a partition grant.  An
        epoch at or above the backend's recorded grant closes it and
        cancels any in-flight partition job; an older epoch is fenced."""
        req = {
            "op": "partition_done",
            "search": search,
            "part": part,
            "epoch": int(epoch),
            "reason": reason,
        }
        return self._call(req, timeout=timeout)

    def follow(
        self,
        history_text: str | None = None,
        *,
        records: list | None = None,
        stream: str,
        frontier: str | None = None,
        client: str = "client",
        priority: int = 10,
        timeout: float | None = None,
        trace_id: str | None = None,
        deadline_s: float | None = None,
    ) -> dict:
        """Verify one rolling window of a continuously monitored stream.

        ``frontier`` is the token echoed by the previous window's reply
        (None starts a lineage).  The reply is window-scoped: it carries
        ``verdict`` for the stream-so-far, ``advanced`` (whether the
        committed frontier moved) and the next ``frontier`` token.  A
        daemon that lost the token answers the definite
        ``UnknownFrontier`` — callers resync with a full :meth:`submit`.
        """
        if (history_text is None) == (records is None):
            raise ValueError("follow takes exactly one of history_text / records")
        if not stream:
            raise ValueError("follow needs a non-empty stream id")
        tid = trace_id or new_trace_id()
        req: dict = {
            "op": "follow",
            "client": client,
            "priority": priority,
            "stream": stream,
            TRACE_FIELD: trace_frame(tid),
        }
        if records is not None:
            req["records"] = records
        else:
            req["history"] = history_text
        if frontier is not None:
            req["frontier"] = frontier
        if deadline_s is not None:
            req["deadline"] = float(deadline_s)
        reply = self._call(req, timeout=timeout)
        if isinstance(reply, dict):
            reply.setdefault("trace_id", tid)
        return reply

    def submit_with_retry(
        self,
        history_text: str,
        *,
        retries: int = 0,
        backoff_s: float = 0.5,
        max_retry_wait_s: float = 30.0,
        deadline_s: float | None = None,
        rng: random.Random | None = None,
        **kw,
    ) -> dict:
        """``submit`` with the full retry policy.

        Backpressure sleeps the daemon's ``retry_after_s`` hint (the hint
        wins over the schedule — the daemon knows its own drain rate).
        Transient transport failures (:class:`VerifydUnavailable`,
        transient :class:`VerifydRefused`) sleep exponential backoff with
        full jitter: ``uniform(0, backoff_s * 2**attempt)``, capped at
        ``max_retry_wait_s``.  Non-transient refusals (wrong secret) and
        semantic errors (``DecodeError``) raise immediately — retrying
        identical bytes cannot change those answers.  After ``retries``
        re-submissions the last error propagates for the CLI's exit-code
        mapping (75 busy / 69 unavailable / 76 refused).

        ``deadline_s`` caps total wall-clock across *all* attempts and
        sleeps (``submit --deadline``): per-attempt timeouts are clamped
        to the remaining budget, sleeps are truncated, and when the
        budget is spent :class:`VerifydDeadlineExceeded` raises — so a
        client cannot spin forever against a flapping node regardless of
        the attempt count.  The *remaining* budget also rides each
        attempt's frame as the end-to-end ``deadline`` field, so the
        daemon (or a router hop) enforces the same clock server-side.
        """
        rng = rng or random.Random()
        # One logical request = one trace id, however many wire attempts.
        kw.setdefault("trace_id", new_trace_id())
        t0 = time.monotonic()
        caller_timeout = kw.pop("timeout", None)

        def _remaining() -> float | None:
            if deadline_s is None:
                return None
            return deadline_s - (time.monotonic() - t0)

        def _sleep(want_s: float, attempts: int, last: str) -> None:
            rem = _remaining()
            if rem is not None:
                if rem <= want_s:
                    # Sleeping would spend the rest of the budget with no
                    # attempt left to show for it — fail now, honestly.
                    raise VerifydDeadlineExceeded(deadline_s, attempts, last)
                want_s = min(want_s, rem)
            time.sleep(max(0.0, want_s))

        for attempt in range(retries + 1):
            rem = _remaining()
            if rem is not None and rem <= 0:
                raise VerifydDeadlineExceeded(
                    deadline_s, attempt, "budget spent before attempt"
                )
            tmo = caller_timeout
            if rem is not None:
                tmo = rem if tmo is None else min(tmo, rem)
                # Each wire attempt carries what is LEFT of the budget,
                # already net of sleeps and failed attempts.
                kw["deadline_s"] = rem
            try:
                return self.submit(history_text, timeout=tmo, **kw)
            except VerifydBusy as e:
                if attempt == retries:
                    raise
                _sleep(
                    min(e.retry_after_s, max_retry_wait_s),
                    attempt + 1,
                    f"{e.cls}: {e.msg}",
                )
            except (VerifydUnavailable, VerifydRefused) as e:
                if isinstance(e, VerifydRefused) and not e.transient:
                    raise
                if attempt == retries:
                    raise
                _sleep(
                    min(max_retry_wait_s, rng.uniform(0, backoff_s * (2**attempt))),
                    attempt + 1,
                    f"{e.cls}: {e.msg}",
                )
            except VerifydError as e:
                # ShuttingDown / NoBackend: transient by contract (the
                # drained daemon restarts, the router's routable set
                # refills).  Everything else semantic is definite.
                if e.cls not in _TRANSIENT_CLASSES or attempt == retries:
                    raise
                _sleep(
                    min(max_retry_wait_s, rng.uniform(0, backoff_s * (2**attempt))),
                    attempt + 1,
                    f"{e.cls}: {e.msg}",
                )
        raise AssertionError("unreachable")
