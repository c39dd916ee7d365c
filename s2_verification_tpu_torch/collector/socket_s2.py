"""A loopback-socket S2 transport: the second implementation of the seam.

The reference's collector speaks to a real network S2 endpoint configured
from env vars with retry policy
(rust/s2-verification/src/bin/collect-history.rs:70-94).  Collection runs
without network egress, but the transport protocol
(:class:`~.transport.S2StreamTransport`) must demonstrably carry a real
async IO boundary — an in-process method call can hide contract violations
(shared objects, synchronous rendezvous) a socket cannot.

:class:`S2SocketServer` serves an authoritative :class:`~.fake_s2.FakeS2Stream`
(state + fault injection live server-side, like the real service) over a
unix-domain socket **on its own thread and event loop**;
:class:`S2SocketTransport` is a client implementing the protocol over
newline-delimited JSON frames (bodies base64-coded), one connection per
request — the reference client's connection discipline, not a pinned pipe.

Error taxonomy rides the wire by class name: the five contract exceptions
(transport.py) re-raise client-side as themselves.  Anything else the
server throws maps to :class:`~.transport.IndefiniteServerError` — an
unknown failure mid-append may or may not have applied, and claiming
"definite" would license the collector to skip the rotation protocol
(history.rs:575-592) on an op that actually took effect.

Determinism note: the fake's in-process path keeps byte-replayable
interleavings via the VirtualClock; socket IO schedules on real readiness,
so runs through this transport are valid but not byte-identical across
machines.  The server thread never touches the collector's clock — a
clock sleep on the server loop would both break that isolation and
deadlock the collector's single-wake scheduler.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import logging
import os
import socket
import threading

from .fake_s2 import FakeS2Stream
from .transport import (
    AppendAck,
    AppendConditionFailed,
    CheckTailError,
    DefiniteServerError,
    IndefiniteServerError,
    ReadError,
)

__all__ = ["S2SocketServer", "S2SocketTransport"]

log = logging.getLogger("s2_verification_tpu_torch.socket_s2")

_WIRE_ERRORS = {
    cls.__name__: cls
    for cls in (
        AppendConditionFailed,
        DefiniteServerError,
        IndefiniteServerError,
        ReadError,
        CheckTailError,
    )
}

_B64 = lambda b: base64.b64encode(b).decode("ascii")
_UNB64 = lambda s: base64.b64decode(s.encode("ascii"))


class S2SocketServer:
    """Serve one ``FakeS2Stream`` over a unix-domain socket.

    Runs a private event loop on a daemon thread so the collector's loop
    (and its sync setup calls, collect.py:85) can block on the socket
    without deadlocking against their own scheduler.  Use as a context
    manager; the socket path must not already exist.
    """

    def __init__(self, stream: FakeS2Stream, path: str) -> None:
        if stream.clock is not None:
            raise ValueError(
                "server-side stream must not carry a VirtualClock: the "
                "collector's clock lives on the client loop"
            )
        self.stream = stream
        self.path = path
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._started = threading.Event()
        self._stop: asyncio.Future | None = None
        self._startup_error: BaseException | None = None

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "S2SocketServer":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError(f"socket server failed to start on {self.path}")
        if self._startup_error is not None:
            # Bind failures (e.g. a stale socket file from a crashed run,
            # which only a clean exit removes) must surface with their real
            # cause, not as a silent dead thread.
            raise RuntimeError(
                f"socket server failed to start on {self.path}"
            ) from self._startup_error
        return self

    def __exit__(self, *exc) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(
                lambda: self._stop.set_result(None) if not self._stop.done() else None
            )
        if self._thread is not None:
            self._thread.join(timeout=10)
        with contextlib.suppress(FileNotFoundError):
            os.remove(self.path)

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:
            self._startup_error = e
        finally:
            self._started.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = self._loop.create_future()
        server = await asyncio.start_unix_server(self._handle, path=self.path)
        self._started.set()
        try:
            await self._stop
        finally:
            server.close()
            await server.wait_closed()

    # -- protocol -----------------------------------------------------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while line := await reader.readline():
                resp = await self._dispatch(json.loads(line))
                writer.write(json.dumps(resp).encode("utf-8") + b"\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    async def _dispatch(self, req: dict) -> dict:
        try:
            op = req["op"]
            if op == "append":
                ack = await self.stream.append(
                    [_UNB64(b) for b in req["bodies"]],
                    match_seq_num=req.get("match_seq_num"),
                    fencing_token=req.get("fencing_token"),
                    set_fencing_token=req.get("set_fencing_token"),
                )
                return {"ok": {"tail": ack.tail}}
            if op == "read_all":
                bodies = await self.stream.read_all()
                return {"ok": {"bodies": [_B64(b) for b in bodies]}}
            if op == "check_tail":
                return {"ok": {"tail": await self.stream.check_tail()}}
            if op == "snapshot":
                return {
                    "ok": {"bodies": [_B64(b) for b in self.stream.snapshot_bodies()]}
                }
            return {"err": {"class": "DefiniteServerError", "msg": f"unknown op {op!r}"}}
        except tuple(_WIRE_ERRORS.values()) as e:
            return {"err": {"class": type(e).__name__, "msg": str(e)}}
        except Exception as e:  # unknown failure: ambiguous by contract
            log.exception("socket server internal error")
            return {"err": {"class": "IndefiniteServerError", "msg": repr(e)}}


class S2SocketTransport:
    """Client side of the loopback transport (implements
    :class:`~.transport.S2StreamTransport`)."""

    def __init__(self, path: str) -> None:
        self.path = path
        #: attached by the collector; socket awaits schedule on real IO
        #: readiness, so the clock only governs the workloads' own sleeps.
        self.clock = None

    async def _call(self, req: dict) -> dict:
        reader, writer = await asyncio.open_unix_connection(self.path)
        try:
            writer.write(json.dumps(req).encode("utf-8") + b"\n")
            await writer.drain()
            line = await reader.readline()
        finally:
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()
        if not line:
            raise IndefiniteServerError("server closed the connection mid-call")
        return _unwrap(json.loads(line))

    async def append(
        self,
        bodies: list[bytes],
        *,
        match_seq_num: int | None = None,
        fencing_token: str | None = None,
        set_fencing_token: str | None = None,
    ) -> AppendAck:
        ok = await self._call(
            {
                "op": "append",
                "bodies": [_B64(b) for b in bodies],
                "match_seq_num": match_seq_num,
                "fencing_token": fencing_token,
                "set_fencing_token": set_fencing_token,
            }
        )
        return AppendAck(tail=ok["tail"])

    async def read_all(self) -> list[bytes]:
        ok = await self._call({"op": "read_all"})
        return [_UNB64(b) for b in ok["bodies"]]

    async def check_tail(self) -> int:
        return (await self._call({"op": "check_tail"}))["tail"]

    def snapshot_bodies(self) -> list[bytes]:
        """Blocking setup-path scan (collect.py calls this synchronously
        from inside its loop; the server answers from its own thread)."""
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(10.0)
            s.connect(self.path)
            s.sendall(json.dumps({"op": "snapshot"}).encode("utf-8") + b"\n")
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(1 << 16)
                if not chunk:
                    raise ReadError("server closed the connection mid-snapshot")
                buf += chunk
        ok = _unwrap(json.loads(buf))
        return [_UNB64(b) for b in ok["bodies"]]


def _unwrap(resp: dict) -> dict:
    if "err" in resp:
        err = resp["err"]
        cls = _WIRE_ERRORS.get(err.get("class"), IndefiniteServerError)
        raise cls(err.get("msg", ""))
    return resp["ok"]
