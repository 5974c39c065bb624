"""Logging setup (copied from ``horovod_tpu/utils/logging.py``).

A thin shim over :mod:`logging` with Horovod's level names, selected by
``HVD_TPU_LOG_LEVEL`` (falling back to ``HOROVOD_LOG_LEVEL``).  Records
carry ``rank`` / ``host`` / ``step`` from one process-wide context
(:func:`set_log_context`); ``HVD_TPU_LOG_JSON=1`` switches to one JSON
object per line.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import sys
import time
from typing import Optional

_LEVELS = {
    "trace": logging.DEBUG,  # python logging has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_LOGGER = logging.getLogger("horovod_tpu_torch")
_configured = False

_context = {"rank": "-", "host": socket.gethostname(), "step": "-"}


def _flag(value: Optional[str]) -> bool:
    """``utils/env_parser.py``'s boolean grammar."""
    return value is not None and \
        value.strip().lower() in ("1", "true", "yes", "on")


def set_log_context(rank=None, host=None, step=None) -> None:
    """Update the fields every subsequent record carries."""
    if rank is not None:
        _context["rank"] = rank
    if host is not None:
        _context["host"] = host
    if step is not None:
        _context["step"] = step


class _ContextFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = _context["rank"]
        record.host = _context["host"]
        record.step = _context["step"]
        return True


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "t": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "rank": getattr(record, "rank", "-"),
            "host": getattr(record, "host", "-"),
            "step": getattr(record, "step", "-"),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def get_logger() -> logging.Logger:
    global _configured
    if not _configured:
        # each HVD_TPU_<NAME> falls back to HOROVOD_<NAME>, spelled out
        # so that the env pass (python -m horovod_tpu_torch.analysis)
        # sees the reads
        level_name = (os.environ.get(
            "HVD_TPU_LOG_LEVEL", os.environ.get("HOROVOD_LOG_LEVEL"))
            or "warning").lower()
        handler = logging.StreamHandler(sys.stderr)
        if _flag(os.environ.get("HVD_TPU_LOG_JSON",
                                os.environ.get("HOROVOD_LOG_JSON"))):
            handler.setFormatter(_JsonFormatter())
        else:
            hide_time = _flag(os.environ.get(
                "HVD_TPU_LOG_HIDE_TIME",
                os.environ.get("HOROVOD_LOG_HIDE_TIME")))
            fmt = "[%(levelname)s] hvd_tpu_torch: %(message)s" if hide_time \
                else "%(asctime)s [%(levelname)s] hvd_tpu_torch: %(message)s"
            handler.setFormatter(logging.Formatter(fmt))
        _LOGGER.addFilter(_ContextFilter())
        _LOGGER.addHandler(handler)
        _LOGGER.setLevel(_LEVELS.get(level_name, logging.WARNING))
        _LOGGER.propagate = False
        _configured = True
    return _LOGGER
