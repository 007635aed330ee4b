"""Logging (port of ``positionbaseddynamics_tpu/utils/log.py``): a thin
sink-based wrapper over :mod:`logging` matching the reference's
``Utils/Logger.h:15-60`` surface (LogLevel DEBUG/INFO/WARN/ERR, pluggable
Console/File/Buffer sinks, ``LOG_INFO`` streams), on the logger named
``positionbaseddynamics_tpu_torch``.

Python's stdlib logger already is a sink-based multi-handler logger, so
this module only provides the reference-shaped convenience API on top of
it; everything interoperates with ordinary ``logging`` configuration.
"""
from __future__ import annotations

import logging
from typing import List

logger = logging.getLogger("positionbaseddynamics_tpu_torch")

DEBUG, INFO, WARN, ERR = (logging.DEBUG, logging.INFO, logging.WARNING,
                          logging.ERROR)


def _add(handler, level, fmt):
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)
    logger.setLevel(min(logger.level or level, level))
    return handler


def add_console_sink(level=INFO):
    """``ConsoleSink`` (``Logger.h``)."""
    return _add(logging.StreamHandler(), level, "[%(levelname)s] %(message)s")


def add_file_sink(path: str, level=DEBUG):
    """``FileSink``."""
    return _add(logging.FileHandler(path), level,
                "%(asctime)s [%(levelname)s] %(message)s")


class BufferSink(logging.Handler):
    """``BufferSink`` — records messages for programmatic inspection
    (used by the reference's GUI log panel)."""

    def __init__(self, level=DEBUG):
        super().__init__(level)
        self.messages: List[str] = []

    def emit(self, record):
        self.messages.append(self.format(record))


def add_buffer_sink(level=DEBUG) -> BufferSink:
    return _add(BufferSink(level), level, "[%(levelname)s] %(message)s")


log_debug = logger.debug
log_info = logger.info
log_warn = logger.warning
log_err = logger.error
