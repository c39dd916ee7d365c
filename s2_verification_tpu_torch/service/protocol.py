"""verifyd wire protocol: newline-delimited JSON frames over a unix
socket or an authenticated TCP connection.

The port's copy of the JAX package's ``service/protocol.py``: frames,
signatures and error codes are byte-identical, so each package's client
talks to the other's daemon.  The port's daemon serves ``ping``,
``stats``, ``trace``, ``watch``, ``shutdown`` and ``submit``; it answers
the other ops below with an error frame naming the module they need.

Same framing discipline as the collector's loopback transport
(``collector/socket_s2.py``): one JSON object per line, request → one JSON
reply, one connection per request.  ``submit`` replies are *deferred* —
the connection stays open until the verdict is ready (or the admission
queue rejects the job immediately).

Requests are ``{"op": <name>, ...}``; replies are ``{"ok": {...}}`` or
``{"err": {"class": <name>, "msg": <text>, ...}}``.

Ops:

``ping``      → ``{"ok": {"server": "verifyd", "version", "pid", "protocol"}}``
``stats``     → ``{"ok": {<counter snapshot>}}``
``submit``    → history JSONL text in ``history``; optional ``client``
                (string identity), ``priority`` (int, lower = sooner),
                ``no_viz``, ``deadline`` — remaining end-to-end budget
                in seconds; the daemon refuses a spent budget with the
                **definite** ``DeadlineExceeded`` and cooperatively
                cancels queued/running work when it expires (like
                ``trace`` below, the field is optional, ignored by old
                daemons, and HMAC-covered) — and ``trace`` — a
                distributed-trace context
                ``{"trace_id": <32 hex>, "sent_wall": <epoch s>}``
                (obs/context.py).  The field is *optional and ignored by
                old daemons* (unknown keys pass through untouched, and
                the HMAC covers whatever keys are present), so new
                clients interoperate with old daemons and vice versa; a
                daemon that understands it threads the id through every
                span and echoes it as ``trace_id`` in the reply.  Reply
                carries the ``check`` verdict (``verdict`` = the CLI
                exit code 0/1/2, ``outcome``), the HTML artifact path,
                the backend that decided, queue wait, and ``cached``
                (answered from the verdict cache).
``follow``    → one rolling window of a continuously monitored stream
                (requires the daemon's prefix store, ``serve --prefix``).
                Same history payload fields as ``submit`` (``history`` /
                ``records``, ``client``, ``priority``, ``deadline``,
                ``trace``) plus a required ``stream`` id and an optional
                ``frontier`` — the store key of the previous window's
                committed cut, echoed by the previous reply.  The reply
                is **window-scoped** (``scope="window"``): the verdict
                covers the stream-so-far given the committed prefix, not
                the window as a standalone history, so it is never
                cached.  It carries ``window`` (ordinal), ``ops`` /
                ``ops_total``, ``advanced`` (whether the frontier moved)
                and the new ``frontier`` token.  An unknown/evicted
                ``frontier`` is refused with the **definite**
                ``UnknownFrontier`` — the client resyncs by resubmitting
                the full history (or restarting the follow from scratch).
``trace``     → ``{"ok": {"traceEvents": [...], ...}}`` — the daemon's
                in-memory span ring in Chrome trace_event JSON (Object
                Format); loads directly in Perfetto / chrome://tracing.
``profiles``  → query the durable per-job profile archive (requires
                ``--state-dir``).  Optional filters: ``shape``,
                ``backend`` (prefix match), ``client``, ``verdict``
                (int), ``since`` (epoch s), ``slowest`` (N by wall
                time), ``limit`` (newest N; defaults to 100 when no
                other cut is given).  Reply:
                ``{"ok": {"records": [...], "total": <archived>}}``.
``quarantine``→ poison-job ledger ops (requires ``--state-dir``):
                ``action`` = ``list`` (every quarantined fingerprint),
                ``inspect`` (one entry + live crash count, needs
                ``fingerprint``), or ``release`` (operator override:
                un-quarantine + forgive crashes).  Submitting a
                quarantined history is answered with the **definite**
                ``Quarantined`` error before admission.
``shutdown``  → acks, then stops the daemon.  Optional ``drain``
                (bool) + ``timeout`` (seconds): stop admitting, let
                in-flight jobs finish up to the deadline, close the
                journal cleanly, then stop — the router's rolling
                restart sends this.

Distributed-search ops (coordinator → backend; ``service/distsearch.py``
orchestrates, ``service/router.py`` hosts the coordinator):

``grant``     → ownership handshake for one frontier partition:
                ``search`` (the job fingerprint), ``seg`` (segment cut
                key), ``part`` (digest range id), ``epoch`` (monotone
                fencing counter).  The backend records the grant and
                refuses any frame for the pair carrying an *older* epoch
                with the **definite** ``EpochFenced`` — the coordinator
                journals the grant before sending, so an unclean death
                leaves a re-grantable record, never a lost range.
``delta``     → run one partition of a segment: the segment history
                (``history``/``records``) plus ``carry`` — the partition's
                share of the frontier union in the prefix-carry payload
                shape (checker/prefix.py).  Deferred reply like
                ``submit``; the backend checks the grant epoch both at
                admission and again when the verdict is ready (a
                revocation landing mid-search turns the reply into
                ``EpochFenced`` instead of a zombie delta).  Reply carries
                ``verdict``/``outcome`` and, on OK, ``states`` — the
                end-of-segment union the coordinator merges.
``partition_done`` → close or revoke a grant (``reason`` = ``done`` /
                ``revoked``): the backend drops the grant entry when the
                epoch is current-or-newer and cancels any in-flight
                partition search for the pair.

Router ops (``service/router.py`` speaks this same protocol and adds):

``fleet``     → ``{"ok": {"ring": {...}, "backends": [...]}}`` —
                per-backend up/draining/breaker/in-flight state.
``drain``     → ``{"node": <name>, "timeout": <s>}``: stop routing new
                work to the node, wait for router-side in-flight, then
                send it a drain-aware ``shutdown``.
``undrain``   → put a drained node back in the routable set.

A router ``submit`` may also fail with ``NoBackend`` (transient: every
routable backend was tried and none answered — retry like
``ShuttingDown``); successes carry ``node`` (which backend answered)
and ``stolen`` when work-stealing rerouted a cold job.

Frame bounds: the daemon reads at most ``MAX_FRAME_BYTES`` per frame
(configurable) and answers an oversized frame with the **definite**
protocol error ``FrameTooLarge`` before closing the connection — a
garbled client cannot balloon daemon memory through an unbounded read.
``FrameError`` (transport-level malformation: not JSON, not an object)
is distinct from ``DecodeError`` (a well-formed frame whose *history*
does not decode): the first is retryable line noise, the second is the
client's bug.

Authentication (TCP only; the unix socket is filesystem-permissioned and
carries no auth field): every frame carries ``"auth"``, the hex
HMAC-SHA256 of the frame's canonical JSON (sorted keys, compact
separators, ``auth`` excluded) under the shared secret.  The daemon
verifies before dispatch — a wrong or missing secret is rejected with
``AuthError`` before anything touches the admission queue — and signs
its replies so the client can verify them back.

Backpressure: a full admission queue answers ``submit`` immediately with
``{"err": {"class": "QueueFull", "retry_after_s": <hint>}}`` — the
documented reject-with-retry-after reply; the daemon never buffers beyond
its configured depth.

Exit-code conventions for the ``submit`` CLI: verdicts map to the
``check`` exit codes (0 linearizable / 1 not / 2 inconclusive, 64 decode
errors); ``EXIT_BUSY`` (75, EX_TEMPFAIL) for a backpressure reject after
retries; ``EXIT_UNAVAILABLE`` (69, EX_UNAVAILABLE) when no daemon ever
answered a connect; ``EXIT_PROTOCOL`` (76, EX_PROTOCOL) when a daemon
*was* reached but refused after retries (bad secret, persistent frame
errors, connection lost mid-call).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import json

__all__ = [
    "PROTOCOL_VERSION",
    "MAX_FRAME_BYTES",
    "ERR_QUEUE_FULL",
    "ERR_DECODE",
    "ERR_FRAME",
    "ERR_TOO_LARGE",
    "ERR_AUTH",
    "ERR_INTERNAL",
    "ERR_SHUTTING_DOWN",
    "ERR_NO_BACKEND",
    "ERR_DEADLINE",
    "ERR_EPOCH",
    "ERR_FRONTIER",
    "ERR_QUARANTINED",
    "ERR_CANCELLED",
    "ERR_UNKNOWN_JOB",
    "EXIT_BUSY",
    "EXIT_UNAVAILABLE",
    "EXIT_PROTOCOL",
    "VERDICT_EXIT",
    "encode_frame",
    "decode_frame",
    "sign_frame",
    "verify_frame",
    "parse_hostport",
    "ok",
    "err",
]

PROTOCOL_VERSION = 1

#: Default per-frame read bound.  A submitted history rides inside one
#: frame, so this also caps history size (~8 MiB JSONL ≈ 10^5 events —
#: far past what any engine decides); the old implicit bound was
#: asyncio's 64 KiB stream limit, which *rejected* legal large histories.
MAX_FRAME_BYTES = 8 << 20

ERR_QUEUE_FULL = "QueueFull"
ERR_DECODE = "DecodeError"
ERR_FRAME = "FrameError"
ERR_TOO_LARGE = "FrameTooLarge"
ERR_AUTH = "AuthError"
ERR_INTERNAL = "InternalError"
ERR_SHUTTING_DOWN = "ShuttingDown"
#: Definite: the job's end-to-end deadline passed (at admission, in the
#: queue, or mid-search).  Retrying without a larger deadline is
#: pointless, so clients treat it like a semantic refusal, and the
#: router forwards it instead of failing over.
ERR_DEADLINE = "DeadlineExceeded"
#: Definite: the history's fingerprint is quarantined after repeated
#: process/child deaths.  Answered before admission; an operator
#: releases it with the ``quarantine`` op.
ERR_QUARANTINED = "Quarantined"
#: Definite: the job was cancelled for a non-deadline reason
#: (``client_gone``, ``shutdown``) after admission.
ERR_CANCELLED = "Cancelled"
#: Definite: a ``follow`` frame named a frontier token the prefix store
#: does not hold (evicted, never durable, or minted by another node).
#: Retrying the same token is pointless — the client resyncs with a full
#: ``submit`` and starts a fresh follow lineage.
ERR_FRONTIER = "UnknownFrontier"
#: Router-only: every routable backend was tried (or none existed) and
#: the submit could not be placed.  Transient — clients retry like
#: :data:`ERR_SHUTTING_DOWN`.
ERR_NO_BACKEND = "NoBackend"
#: Definite: a distributed-search frame (``grant``/``delta``) carried an
#: epoch older than the one this node holds for the partition, or named a
#: grant that was revoked underneath the sender.  The fencing answer of
#: the distsearch protocol: a zombie owner that missed its own revocation
#: gets this instead of an accepted delta, and the coordinator applies
#: the same check once more at merge time — retrying the stale epoch is
#: pointless, the partition already belongs to a newer grant.
ERR_EPOCH = "EpochFenced"
#: Definite: a ``watch`` frame named a job (or fingerprint / search) this
#: node is not running and does not remember finishing.  Retrying the
#: same selector on the same node is pointless; the router treats it as a
#: semantic answer, not a reason to fail over.
ERR_UNKNOWN_JOB = "UnknownJob"

#: check-CLI exit code per outcome value (cli.py docstring contract).
VERDICT_EXIT = {"ok": 0, "illegal": 1, "unknown": 2}

EXIT_BUSY = 75  # EX_TEMPFAIL: queue full, retry after the hint
EXIT_UNAVAILABLE = 69  # EX_UNAVAILABLE: no daemon ever answered a connect
EXIT_PROTOCOL = 76  # EX_PROTOCOL: daemon reached but refused after retries


#: Request-frame field table: op -> {field: "required" | "optional"}.
#: ``op`` itself and the fields in :data:`UNSIGNED_FIELDS` ride on every
#: frame implicitly.  This is the wire contract the static protocol-compat
#: lint pass checks construction sites (client.py) and parse sites
#: (daemon.py/router.py) against: a field added here must be optional (old
#: peers must keep interoperating — senders may omit it, parsers must
#: ``.get`` it with a default), and because only :data:`UNSIGNED_FIELDS`
#: escape the MAC, every new field is HMAC-covered by construction.
FRAME_FIELDS = {
    "ping": {},
    "stats": {},
    "trace": {},
    "fleet": {},
    "submit": {
        # Exactly one of history (JSONL string) / records (JSON array of
        # event objects) — the daemon enforces the one-of; both are
        # optional at the frame layer so either wire form interoperates.
        "history": "optional",
        "records": "optional",
        "client": "optional",
        "priority": "optional",
        "no_viz": "optional",
        "deadline": "optional",
        "trace": "optional",
        # Route the submit through the fleet-distributed frontier search
        # (router only; service/distsearch.py).  Optional and ignored by
        # plain daemons, so old peers keep interoperating.
        "distributed": "optional",
    },
    "follow": {
        # Same one-of history/records contract as submit, plus the
        # stream identity and the carried frontier token.
        "history": "optional",
        "records": "optional",
        "client": "optional",
        "priority": "optional",
        "deadline": "optional",
        "trace": "optional",
        "stream": "optional",
        "frontier": "optional",
    },
    "profiles": {
        "shape": "optional",
        "backend": "optional",
        "client": "optional",
        "verdict": "optional",
        "since": "optional",
        "slowest": "optional",
        "limit": "optional",
    },
    "shutdown": {"drain": "optional", "timeout": "optional"},
    "quarantine": {"action": "optional", "fingerprint": "optional"},
    # Live progress snapshot of running searches.  All selectors optional
    # (old-peer interop): no selector = every active job on the node;
    # ``job`` = one job id; ``fingerprint`` = jobs keyed by verdict-cache
    # fingerprint (how a coordinator polls its ``ppart:`` partition jobs);
    # ``search``(+``part``) = a distributed search's partitions, resolved
    # by the router against its live coordinator or fanned out.
    "watch": {
        "job": "optional",
        "fingerprint": "optional",
        "search": "optional",
        "part": "optional",
    },
    # Durable-telemetry history query (obs/tsdb.py).  All selectors
    # optional (old-peer interop): no selector = the raw ring's recent
    # tail; ``info`` = ring inventory instead of points.
    "tsq": {
        "res": "optional",
        "metric": "optional",
        "labels": "optional",
        "since": "optional",
        "until": "optional",
        "limit": "optional",
        "info": "optional",
    },
    "drain": {"node": "required", "timeout": "optional"},
    "undrain": {"node": "required"},
    # Distributed-search ops (coordinator → backend; service/distsearch.py).
    # All fields optional at the frame layer for old-peer interop; the
    # daemon enforces the semantic requirements (search/part/epoch) itself.
    "grant": {
        "search": "optional",
        "seg": "optional",
        "part": "optional",
        "epoch": "optional",
        "trace": "optional",
    },
    "delta": {
        # Same one-of history/records payload contract as submit, plus the
        # partition identity and the carried frontier union.
        "history": "optional",
        "records": "optional",
        "client": "optional",
        "deadline": "optional",
        "trace": "optional",
        "search": "optional",
        "seg": "optional",
        "part": "optional",
        "epoch": "optional",
        "carry": "optional",
        "union": "optional",
    },
    "partition_done": {
        "search": "optional",
        "part": "optional",
        "epoch": "optional",
        "reason": "optional",
        "trace": "optional",
    },
}

#: The only fields excluded from the HMAC canonicalization — the MAC
#: itself.  Everything else in a frame is authenticated; extending this
#: tuple widens the unauthenticated surface and fails the protocol-compat
#: lint unless :func:`_frame_mac` agrees.
UNSIGNED_FIELDS = ("auth",)


def encode_frame(obj: dict) -> bytes:
    """One wire frame: compact JSON + newline (history text rides inside a
    JSON string, so embedded newlines are escaped and framing holds)."""
    return json.dumps(obj, separators=(",", ":")).encode("utf-8") + b"\n"


def decode_frame(line: bytes) -> dict:
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError(f"frame must be a JSON object, got {type(obj).__name__}")
    return obj


def _frame_mac(obj: dict, secret: bytes) -> str:
    """HMAC-SHA256 over the canonical serialization of ``obj`` minus
    :data:`UNSIGNED_FIELDS`.  Canonical = sorted keys + compact separators,
    so both ends derive identical bytes regardless of insertion order."""
    body = {k: v for k, v in obj.items() if k not in UNSIGNED_FIELDS}
    canon = json.dumps(body, sort_keys=True, separators=(",", ":")).encode("utf-8")
    return _hmac.new(secret, canon, hashlib.sha256).hexdigest()


def sign_frame(obj: dict, secret: bytes) -> dict:
    return {**obj, "auth": _frame_mac(obj, secret)}


def verify_frame(obj: dict, secret: bytes) -> bool:
    mac = obj.get("auth")
    return isinstance(mac, str) and _hmac.compare_digest(
        mac, _frame_mac(obj, secret)
    )


def parse_hostport(addr: str) -> tuple[str, int]:
    """``host:port`` → (host, port); bare ``:port`` binds all interfaces."""
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"expected HOST:PORT, got {addr!r}")
    return host or "0.0.0.0", int(port)


def ok(payload: dict) -> dict:
    return {"ok": payload}


def err(cls: str, msg: str, **extra) -> dict:
    e = {"class": cls, "msg": msg}
    e.update(extra)
    return {"err": e}
