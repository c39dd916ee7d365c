"""Fault-injecting frame proxy: the chaos harness's network.

Sits between a verifyd client and the daemon's TCP listener, forwarding
newline-delimited frames and injecting one configured fault on a
deterministic schedule — **every Nth frame**, not a random rate, so a
client with retries configured always converges (fault, retry, clean
frame) and chaos tests cannot flake on an unlucky coin.

Faults (applied to client→daemon frames; replies pass through):

``truncate``   — forward only the first half of the frame, then close
                 both directions: the daemon sees a torn frame, the
                 client a lost connection.
``garble``     — stamp an invalid UTF-8 byte into the middle of the frame
                 (newline kept, so framing holds): the daemon *always*
                 answers the retryable ``FrameError`` — a subtler garble
                 that stayed valid JSON would fail the HMAC instead, and
                 ``AuthError`` is deliberately non-retryable (a wrong
                 secret stays wrong; line noise does not).
``delay``      — sleep ``delay_s`` before forwarding (reply latency).
``duplicate``  — forward the frame twice: the daemon runs the op twice
                 and the fingerprint cache answers the twin; the client
                 reads one reply and closes, the second dies with the
                 connection.

Threaded blocking sockets (two pump threads per connection), same
discipline as the client side — the proxy must not share the daemon's
event loop or its failure domain.  The port's copy of the JAX package's
``service/chaosproxy.py``.
"""

from __future__ import annotations

import contextlib
import logging
import socket
import threading
import time

__all__ = ["FAULTS", "ChaosProxy"]

log = logging.getLogger("s2_verification_tpu_torch.chaosproxy")

FAULTS = ("none", "truncate", "garble", "delay", "duplicate")


class ChaosProxy:
    """``with ChaosProxy(("127.0.0.1", port), fault="garble") as p:``
    then dial ``p.port``.  ``every=N`` faults frames N, 2N, ... counted
    across all connections."""

    def __init__(
        self,
        upstream: tuple[str, int],
        *,
        fault: str = "none",
        every: int = 2,
        delay_s: float = 0.2,
        host: str = "127.0.0.1",
    ) -> None:
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
        if every < 1:
            raise ValueError(f"'every' must be >= 1, got {every}")
        self.upstream = upstream
        self.fault = fault
        self.every = every
        self.delay_s = delay_s
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(32)
        # closing a socket does not wake a thread blocked in accept();
        # a short timeout lets the accept loop notice _closing instead
        self._listener.settimeout(0.2)
        self.port: int = self._listener.getsockname()[1]
        self._lock = threading.Lock()
        self._frames = 0  #: frames seen (for the every-Nth schedule)
        self.faulted = 0  #: frames actually faulted
        self._closing = False
        self._accept_thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "ChaosProxy":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="chaosproxy-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._closing = True
        with contextlib.suppress(OSError):
            self._listener.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    # -- pumps ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)  # pumps use blocking I/O
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            up = socket.create_connection(self.upstream, timeout=10)
        except OSError:
            with contextlib.suppress(OSError):
                conn.close()
            return
        t = threading.Thread(
            target=self._pump_back, args=(up, conn), daemon=True
        )
        t.start()
        try:
            self._pump_frames(conn, up)
        finally:
            for s in (conn, up):
                with contextlib.suppress(OSError):
                    s.shutdown(socket.SHUT_RDWR)
                with contextlib.suppress(OSError):
                    s.close()

    def _pump_back(self, src: socket.socket, dst: socket.socket) -> None:
        """Daemon→client direction: byte-transparent."""
        with contextlib.suppress(OSError):
            while chunk := src.recv(1 << 16):
                dst.sendall(chunk)
            with contextlib.suppress(OSError):
                dst.shutdown(socket.SHUT_WR)

    def _pump_frames(self, src: socket.socket, dst: socket.socket) -> None:
        """Client→daemon direction: split into newline frames, faulting
        on the deterministic schedule."""
        buf = b""
        with contextlib.suppress(OSError):
            while True:
                chunk = src.recv(1 << 16)
                if not chunk:
                    if buf:  # trailing bytes without a newline: pass on
                        dst.sendall(buf)
                    with contextlib.suppress(OSError):
                        dst.shutdown(socket.SHUT_WR)
                    return
                buf += chunk
                while (nl := buf.find(b"\n")) != -1:
                    frame, buf = buf[: nl + 1], buf[nl + 1 :]
                    if not self._forward(frame, dst):
                        return

    def _forward(self, frame: bytes, dst: socket.socket) -> bool:
        """Forward one frame, maybe faulted; False = connection killed."""
        with self._lock:
            self._frames += 1
            hit = self.fault != "none" and self._frames % self.every == 0
            if hit:
                self.faulted += 1
        if not hit:
            dst.sendall(frame)
            return True
        log.debug("faulting frame %d with %s", self._frames, self.fault)
        if self.fault == "truncate":
            dst.sendall(frame[: max(1, len(frame) // 2)])
            return False  # caller tears down both sockets
        if self.fault == "garble":
            # 0xFF cannot appear in UTF-8: json decode fails definitively
            # (FrameError, retryable) instead of sometimes surviving as
            # valid-JSON-wrong-MAC (AuthError, deliberately fatal).
            mid = len(frame) // 2
            garbled = frame[:mid] + b"\xff" + frame[mid + 1 :]
            dst.sendall(garbled[:-1].replace(b"\n", b" ") + b"\n")
            return True
        if self.fault == "delay":
            time.sleep(self.delay_s)
            dst.sendall(frame)
            return True
        # duplicate
        dst.sendall(frame + frame)
        return True
