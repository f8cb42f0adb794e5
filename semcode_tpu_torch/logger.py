"""Structured logging on the standard library.

Capability parity with the reference's structlog bridge
(reference src/semcode/logger.py:42-93): ISO timestamps, key=value event
rendering, console on/off switch, and redirect-to-file for long-running
ingestion jobs. structlog is not available in this environment, so a small
kwargs-binding adapter provides the same call style
(``log.info("event", repo=name, chunks=n)``).
"""

from __future__ import annotations

import logging
import sys
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Optional

_ROOT_NAME = "semcode_tpu_torch"
_configured = False


class _KVFormatter(logging.Formatter):
    """``2026-01-01T00:00:00Z [info] event key=value`` console renderer."""

    def format(self, record: logging.LogRecord) -> str:
        ts = datetime.fromtimestamp(record.created, tz=timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ"
        )
        event = record.getMessage()
        kv = getattr(record, "semcode_kv", None) or {}
        pairs = " ".join(f"{k}={v!r}" for k, v in kv.items())
        base = f"{ts} [{record.levelname.lower():<8}] {event}"
        if pairs:
            base = f"{base} {pairs}"
        if record.exc_info:
            base = f"{base}\n{self.formatException(record.exc_info)}"
        return base


class BoundLogger:
    """structlog-style logger: positional event + keyword context."""

    def __init__(self, logger: logging.Logger, context: Optional[dict] = None):
        self._logger = logger
        self._context = dict(context or {})

    def bind(self, **kwargs: Any) -> "BoundLogger":
        merged = dict(self._context)
        merged.update(kwargs)
        return BoundLogger(self._logger, merged)

    def _log(self, level: int, event: str, exc_info: Any = None, **kwargs: Any) -> None:
        kv = dict(self._context)
        kv.update(kwargs)
        self._logger.log(level, event, exc_info=exc_info, extra={"semcode_kv": kv})

    def debug(self, event: str, **kwargs: Any) -> None:
        self._log(logging.DEBUG, event, **kwargs)

    def info(self, event: str, **kwargs: Any) -> None:
        self._log(logging.INFO, event, **kwargs)

    def warning(self, event: str, **kwargs: Any) -> None:
        self._log(logging.WARNING, event, **kwargs)

    def error(self, event: str, **kwargs: Any) -> None:
        self._log(logging.ERROR, event, **kwargs)

    def exception(self, event: str, **kwargs: Any) -> None:
        self._log(logging.ERROR, event, exc_info=sys.exc_info(), **kwargs)


def configure_logging(
    level: int = logging.INFO, enable_console: bool = True
) -> None:
    """Configure the package root logger (idempotent)."""
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    root.setLevel(level)
    root.handlers.clear()
    if enable_console:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_KVFormatter())
        root.addHandler(handler)
    else:
        root.addHandler(logging.NullHandler())
    root.propagate = False
    _configured = True


def get_logger(name: str = _ROOT_NAME) -> BoundLogger:
    if not _configured:
        configure_logging()
    if not name.startswith(_ROOT_NAME):
        name = f"{_ROOT_NAME}.{name}"
    return BoundLogger(logging.getLogger(name))


def redirect_logging_to_file(path: Path, level: int = logging.INFO) -> None:
    """Send all package logging to a file (reference logger.py:82-93)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    root = logging.getLogger(_ROOT_NAME)
    root.handlers.clear()
    handler = logging.FileHandler(path, encoding="utf-8")
    handler.setFormatter(_KVFormatter())
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
