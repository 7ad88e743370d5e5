"""Structured JSON logging with trace correlation.

One JSON object per record: timestamp, level, logger, message, plus
(a) the ambient log context — controller name and notebook identity, set by
    the controller worker around every reconcile (runtime/controller.py), and
(b) the current trace/span IDs from utils.tracing, so a log line can be
    joined to the trace that produced it (and to /debug/traces output).

`setup_json_logging()` is the operator entrypoint wiring (main.py enables it
by default; LOG_FORMAT=text opts out). Libraries/tests keep whatever logging
config they had — the formatter is inert until installed.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

_local = threading.local()  # .fields: Dict[str, Any]


def current_log_context() -> Dict[str, Any]:
    return dict(getattr(_local, "fields", None) or {})


@contextmanager
def log_context(**fields: Any) -> Iterator[None]:
    """Bind identity fields (controller, namespace, name, ...) to every log
    record emitted on this thread inside the block; nests by merging."""
    prev = getattr(_local, "fields", None)
    merged = dict(prev or {})
    merged.update({k: v for k, v in fields.items() if v not in (None, "")})
    _local.fields = merged
    try:
        yield
    finally:
        _local.fields = prev


def record_fields(record: logging.LogRecord) -> Dict[str, Any]:
    """One log record as structured fields: timestamp/level/message plus the
    ambient log context and current trace/span ids. Shared by the JSON
    formatter and the flight recorder's log capture, so an incident bundle's
    log lines carry exactly what the emitted JSON logs carried."""
    out: Dict[str, Any] = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
        + f".{int(record.msecs):03d}Z",
        "level": record.levelname,
        "logger": record.name,
        "message": record.getMessage(),
    }
    out.update(getattr(_local, "fields", None) or {})
    # trace correlation: inject the ids of whatever span is current on
    # this thread (deferred import: logging must work during partial
    # interpreter teardown and never cycle back through utils.tracing)
    from .tracing import current_span

    span = current_span()
    if span is not None and span.trace_id:
        out["trace_id"] = span.trace_id
        out["span_id"] = span.span_id
    return out


class JSONLogFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = record_fields(record)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup_json_logging(
    level: int = logging.INFO, stream: Optional[Any] = None
) -> logging.Handler:
    """Install the JSON formatter on the root logger (replacing prior
    handlers, like logging.basicConfig(force=True)); returns the handler."""
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JSONLogFormatter())
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(level)
    return handler
