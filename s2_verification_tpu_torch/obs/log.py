"""Structured logging: JSON or text lines with correlation fields.

Replaces the daemon's ad-hoc ``sys.stderr`` writes with one logger that
every diagnostic goes through.  Two formats, switched by ``serve
--log-format``:

- ``text`` — ``2026-08-05T12:00:00.123Z INFO  msg key=value …`` (the
  human default);
- ``json`` — one JSON object per line (``{"t", "level", "msg", ...}``)
  for log shippers.

Correlation: a logger carries *bound* fields (merged into every line —
e.g. ``component=verifyd``), and call sites pass per-line fields like
``trace_id=…`` / ``job_id=…`` so a grep (or a jq filter) over the log
joins against the trace and the stats stream.  ``bind()`` derives a
child logger with extra bound fields; handy for per-job prefixes.

The module also provides :class:`StructuredHandler`, a
``logging.Handler`` adapter so stdlib ``logging`` emitted by library
code (supervise, resilient, the scheduler) lands in the same
stream with the same format.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Any, Dict, IO, Optional

__all__ = ["StructuredLogger", "StructuredHandler", "LEVELS"]

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}
_NAMES = {v: k for k, v in LEVELS.items()}


class StructuredLogger:
    """Thread-safe leveled line logger, JSON or text, with bound fields."""

    def __init__(
        self,
        stream: Optional[IO[str]] = None,
        *,
        fmt: str = "text",
        level: str = "info",
        **bound: Any,
    ) -> None:
        if fmt not in ("text", "json"):
            raise ValueError("fmt must be 'text' or 'json', got %r" % (fmt,))
        self._stream = stream if stream is not None else sys.stderr
        self.fmt = fmt
        self.level = LEVELS.get(level, 20)
        self._bound: Dict[str, Any] = dict(bound)
        self._lock = threading.Lock()

    def bind(self, **fields: Any) -> "StructuredLogger":
        """A child logger whose lines always carry ``fields`` (e.g.
        ``log.bind(job_id=7, trace_id=tid)``).  Shares the stream+lock."""
        child = StructuredLogger.__new__(StructuredLogger)
        child._stream = self._stream
        child.fmt = self.fmt
        child.level = self.level
        child._bound = {**self._bound, **fields}
        child._lock = self._lock
        return child

    # ------------------------------------------------------------ emit

    def log(self, level: str, msg: str, **fields: Any) -> None:
        lvl = LEVELS.get(level, 20)
        if lvl < self.level:
            return
        merged = {**self._bound, **fields}
        if self.fmt == "json":
            rec: Dict[str, Any] = {
                "t": round(time.time(), 6),
                "level": level,
                "msg": msg,
            }
            rec.update(merged)
            try:
                line = json.dumps(rec, sort_keys=True, default=str)
            except (TypeError, ValueError):
                line = json.dumps(
                    {"t": rec["t"], "level": level, "msg": msg, "unserializable": True}
                )
        else:
            stamp = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
            extras = " ".join(
                "%s=%s" % (k, _compact(v)) for k, v in sorted(merged.items())
            )
            line = "%sZ %-7s %s" % (stamp, level.upper(), msg)
            if extras:
                line += " " + extras
        try:
            with self._lock:
                self._stream.write(line + "\n")
                self._stream.flush()
        except (OSError, ValueError):
            pass  # a dead log stream must never take the daemon down

    def debug(self, msg: str, **fields: Any) -> None:
        self.log("debug", msg, **fields)

    def info(self, msg: str, **fields: Any) -> None:
        self.log("info", msg, **fields)

    def warning(self, msg: str, **fields: Any) -> None:
        self.log("warning", msg, **fields)

    def error(self, msg: str, **fields: Any) -> None:
        self.log("error", msg, **fields)

    def event(self, name: str, fields: Dict[str, Any]) -> None:
        """Log a ServiceStats event as a structured line (the stats sink
        fallback path: ``stats_log='-'`` routes here instead of raw
        stderr writes)."""
        self.log("info", "event:%s" % name, **fields)


def _compact(value: Any) -> str:
    if isinstance(value, float):
        return "%.6g" % value
    if isinstance(value, str):
        return value if value and " " not in value else json.dumps(value)
    if isinstance(value, (dict, list, tuple)):
        try:
            return json.dumps(value, sort_keys=True, default=str)
        except (TypeError, ValueError):
            return repr(value)
    return str(value)


class StructuredHandler(logging.Handler):
    """stdlib ``logging`` adapter: routes library records (supervise,
    resilient, …) through a StructuredLogger so every diagnostic shares
    one format and one stream."""

    def __init__(self, logger: StructuredLogger) -> None:
        super().__init__()
        self._slog = logger

    def emit(self, record: logging.LogRecord) -> None:
        try:
            level = _NAMES.get(
                min(40, max(10, (record.levelno // 10) * 10)), "info"
            )
            self._slog.log(level, record.getMessage(), logger=record.name)
        except Exception:
            pass
