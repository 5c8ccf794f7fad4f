"""Colored, rank-aware logging.

PyTorch port of ``paddlenlp_tpu/utils/log.py`` (itself the counterpart of the
reference's colorlog-based singleton logger). Rank-awareness comes from the
``RANK`` environment variable that ``torch.distributed`` launchers set; only
rank 0 logs at INFO by default.

Structured mode: ``PDNLP_TPU_LOG_JSON=1`` switches the formatter to one JSON
object per line (``ts``/``level``/``logger``/``msg``/``file``/``line`` [+
``exc``] [+ ``trace`` inside a traced serving request]) so serving and
trainer logs are machine-parseable — the shape log shippers
(fluentbit/vector) and ``jq`` expect. ``logger.set_json(True)``
toggles it at runtime.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import sys
import threading
import time

__all__ = ["logger"]

_COLORS = {
    "DEBUG": "\033[35m",  # purple
    "INFO": "\033[32m",  # green
    "WARNING": "\033[33m",  # yellow
    "ERROR": "\033[31m",  # red
    "CRITICAL": "\033[31;1m",
}
_RESET = "\033[0m"


def _process_index() -> int:
    return int(os.environ.get("RANK", "0"))


def _ambient_trace():
    """Active span-tracer trace id (None outside a traced request). Imported
    lazily: observability pulls this module in at import time, so a top-level
    import here would be circular."""
    try:
        from ..observability.tracer import current_trace

        return current_trace()
    except Exception:
        return None


class _ColorFormatter(logging.Formatter):
    def format(self, record):  # noqa: A003
        color = _COLORS.get(record.levelname, "")
        timestamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(record.created))
        msg = record.getMessage()
        if record.exc_info:
            msg = msg + "\n" + self.formatException(record.exc_info)
        return f"{color}[{timestamp}] [{record.levelname:>8}]{_RESET} {record.pathname.split('/')[-1]}:{record.lineno} - {msg}"


class _JsonFormatter(logging.Formatter):
    """One JSON object per line; keys stable for log shippers."""

    def format(self, record):  # noqa: A003
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "file": record.pathname.split("/")[-1],
            "line": record.lineno,
        }
        trace = _ambient_trace()
        if trace is not None:
            out["trace"] = trace
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class Logger:
    """Singleton logger with level context manager, mirroring reference semantics."""

    _instance = None
    _lock = threading.Lock()

    def __new__(cls, *args, **kwargs):
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = super().__new__(cls)
        return cls._instance

    def __init__(self, name: str = "paddlenlp_tpu_torch"):
        if getattr(self, "_initialized", False):
            return
        self._initialized = True
        self.logger = logging.getLogger(name)
        self.logger.propagate = False
        self._handler = logging.StreamHandler(sys.stderr)
        json_mode = os.environ.get("PDNLP_TPU_LOG_JSON", "").lower() in ("1", "true", "yes")
        self._handler.setFormatter(_JsonFormatter() if json_mode else _ColorFormatter())
        self.logger.addHandler(self._handler)
        level = os.environ.get("PDNLP_TPU_LOG_LEVEL", "INFO").upper()
        self.logger.setLevel(level)

    def set_json(self, enabled: bool = True):
        """Switch between JSON-lines and colored human formatting."""
        self._handler.setFormatter(_JsonFormatter() if enabled else _ColorFormatter())

    def _log(self, level: int, msg, *args):
        if _process_index() != 0 and level < logging.WARNING:
            return
        self.logger.log(level, msg, *args, stacklevel=3)

    def debug(self, msg, *args):
        self._log(logging.DEBUG, msg, *args)

    def info(self, msg, *args):
        self._log(logging.INFO, msg, *args)

    def warning(self, msg, *args):
        self._log(logging.WARNING, msg, *args)

    def error(self, msg, *args):
        self._log(logging.ERROR, msg, *args)

    def critical(self, msg, *args):
        self._log(logging.CRITICAL, msg, *args)

    @functools.lru_cache(maxsize=None)  # noqa: B019
    def warning_once(self, msg):
        self.warning(msg)

    def set_level(self, level: str):
        self.logger.setLevel(level.upper())

    class _LevelContext:
        def __init__(self, logger: "Logger", level: str):
            self._logger = logger
            self._level = level.upper()
            self._old = None

        def __enter__(self):
            self._old = self._logger.logger.level
            self._logger.logger.setLevel(self._level)
            return self._logger

        def __exit__(self, *exc):
            self._logger.logger.setLevel(self._old)

    def processing(self, level: str = "DEBUG"):
        return Logger._LevelContext(self, level)


logger = Logger()
