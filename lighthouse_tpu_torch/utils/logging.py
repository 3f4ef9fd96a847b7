"""Structured logging for the port's host layers (the verifier ladder, the
integrity guard, the verify service).

The port's copy of the part of the JAX package's ``utils/logging.py`` that
these layers use: ``get_logger(name)`` (stdlib logging with slog-style
``key: value`` fields, one stderr handler per logger, not propagated) and
``log_with(logger, level, msg, **fields)``.  The reference's metrics hook,
ring buffer and debounce latch serve the node's SSE stream and log-rate
counters, which the port does not have.
"""

from __future__ import annotations

import logging
import sys


class FieldsFormatter(logging.Formatter):
    """slog-style: `Mon HH:MM:SS LEVEL message, key: value, key: value`."""

    def format(self, record: logging.LogRecord) -> str:
        base = (f"{self.formatTime(record, '%b %d %H:%M:%S')} "
                f"{record.levelname:<5} {record.getMessage()}")
        fields = getattr(record, "fields", None)
        if fields:
            base += ", " + ", ".join(f"{k}: {v}" for k, v in fields.items())
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def get_logger(name: str = "lighthouse_tpu_torch", level: int = logging.INFO,
               stream=None) -> logging.Logger:
    """The logger ``name``, given the fields formatter on stderr (or
    ``stream``) the first time it is asked for."""
    logger = logging.getLogger(name)
    if not getattr(logger, "_lh_configured", False):
        logger.setLevel(level)
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(FieldsFormatter())
        logger.addHandler(handler)
        logger._lh_configured = True  # type: ignore[attr-defined]
        logger.propagate = False
    return logger


def log_with(logger: logging.Logger, level: int, msg: str, **fields) -> None:
    """A record with slog-style fields: ``log_with(log, INFO, "fired", site=s)``."""
    logger.log(level, msg, extra={"fields": fields})
