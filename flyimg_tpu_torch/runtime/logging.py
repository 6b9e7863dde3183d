"""Structured JSON logging for the serving tier.

The port of ``flyimg_tpu/runtime/logging.py``:

- ``JsonFormatter``: one JSON object per line (timestamp, level, logger,
  message, plus any extras attached to the record: trace_id/span_id,
  route, status, duration_ms, ...), flat so any log aggregator can filter
  on the fields directly.
- ``configure_logging(params)``: process-level setup from the ``log_*``
  parameters (format json|text, level). Idempotent.
- ``access_log(...)``: the access-log line the HTTP layer writes once per
  request, carrying ``trace_id``/``span_id`` so a slow or failed request
  in the log is one ``/debug/traces/{id}`` lookup away from its span tree.

Emission goes through stdlib ``logging`` (logger ``flyimg.access`` for
access lines, ``flyimg.*`` for subsystem logs).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

__all__ = ["JsonFormatter", "configure_logging", "access_log", "ACCESS_LOGGER"]

ACCESS_LOGGER = "flyimg.access"

# LogRecord attributes that are plumbing, not payload: everything else on
# a record (the `extra={...}` dict) is emitted as a top-level JSON field
_RESERVED = frozenset(
    (
        "name", "msg", "args", "levelname", "levelno", "pathname", "filename",
        "module", "exc_info", "exc_text", "stack_info", "lineno", "funcName",
        "created", "msecs", "relativeCreated", "thread", "threadName",
        "processName", "process", "taskName", "message", "asctime",
    )
)


class JsonFormatter(logging.Formatter):
    """One JSON object per line; record extras become top-level fields."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            ) + f".{int(record.msecs):03d}Z",
            "level": record.levelname.lower(),
            "logger": record.name,
            "message": record.getMessage(),
        }
        for key, value in record.__dict__.items():
            if key in _RESERVED or key.startswith("_") or key in out:
                continue
            try:
                json.dumps(value)
            except (TypeError, ValueError):
                value = repr(value)
            out[key] = value
        if record.exc_info and record.exc_info[0] is not None:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"))


def configure_logging(params=None, *, stream=None) -> logging.Logger:
    """Arm the ``flyimg`` logger hierarchy from the ``log_*`` knobs:

    - ``log_format``: ``json`` (default — one object per line) or ``text``
    - ``log_level``: threshold name (default ``info``)

    Idempotent: re-configuration replaces the handler installed by a
    previous call instead of stacking duplicates. Returns the root
    ``flyimg`` logger."""
    fmt = "json"
    level_name = "info"
    if params is not None:
        fmt = str(params.by_key("log_format", "json")).lower()
        level_name = str(params.by_key("log_level", "info")).lower()
    level = getattr(logging, level_name.upper(), logging.INFO)

    logger = logging.getLogger("flyimg")
    logger.setLevel(level)
    # replace only OUR previously installed handler (marked), never a
    # deployment's own handlers
    for handler in list(logger.handlers):
        if getattr(handler, "_flyimg_managed", False):
            logger.removeHandler(handler)
    handler = logging.StreamHandler(stream)
    handler._flyimg_managed = True
    # replica attribution: with a replica identity
    # configured, EVERY flyimg log line carries it — multi-replica log
    # streams interleave in one aggregator, and a line that cannot name
    # its replica cannot be joined to that replica's traces
    replica = (
        str(params.by_key("fleet_replica_id", "") or "")
        if params is not None else ""
    )
    if replica:
        handler.addFilter(_ReplicaFilter(replica))
    if fmt == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s %(message)s"
            )
        )
    logger.addHandler(handler)
    # stop double-printing through the root logger once we own a handler
    logger.propagate = False
    return logger


class _ReplicaFilter(logging.Filter):
    """Stamps ``replica`` onto every record through the managed handler
    (a Filter rather than a formatter concern so the text format carries
    it too via record attributes)."""

    def __init__(self, replica: str) -> None:
        super().__init__()
        self._replica = replica

    def filter(self, record: logging.LogRecord) -> bool:
        if not hasattr(record, "replica"):
            record.replica = self._replica
        return True


def access_log(
    *,
    method: str,
    path: str,
    route: str,
    status: int,
    duration_s: float,
    bytes_sent: int = 0,
    remote: Optional[str] = None,
    trace_id: Optional[str] = None,
    span_id: Optional[str] = None,
    user_agent: Optional[str] = None,
    replica: Optional[str] = None,
) -> None:
    """One structured access-log line per request. ``trace_id``/``span_id``
    correlate the line with its trace in ``/debug/traces/{id}``."""
    extra = {
        "method": method,
        "path": path,
        "route": route,
        "status": int(status),
        "duration_ms": round(duration_s * 1000.0, 3),
        "bytes": int(bytes_sent),
    }
    if remote:
        extra["remote"] = remote
    if trace_id:
        extra["trace_id"] = trace_id
    if span_id:
        extra["span_id"] = span_id
    if user_agent:
        extra["user_agent"] = user_agent
    if replica:
        extra["replica"] = replica
    level = logging.INFO
    if status >= 500:
        level = logging.ERROR
    elif status >= 400:
        level = logging.WARNING
    logging.getLogger(ACCESS_LOGGER).log(
        level, "%s %s -> %s", method, path, status, extra=extra
    )
