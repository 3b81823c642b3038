"""Logging set-up for the command-line tools (port of the part of
eagle_tpu/utils/logging.py that `--log-level` and `--log-file` reach:
level-letter lines, relative timestamps, an optional log file). The
reference's queue-drained handler is not needed: the port logs nothing on
its hot path.

Environment, as in the reference: EAGLE_LOG_LEVEL (error|warn|info|debug,
default info), EAGLE_LOG_FILE (appended to), EAGLE_LOG_TIMESTAMPS (0|1,
default 1)."""

from __future__ import annotations

import logging
import os
import sys
import time

_START = time.time()
_LEVELS = {"error": logging.ERROR, "warn": logging.WARNING, "info": logging.INFO,
           "debug": logging.DEBUG}


class _Formatter(logging.Formatter):
    def __init__(self, timestamps: bool):
        super().__init__()
        self.timestamps = timestamps

    def format(self, record: logging.LogRecord) -> str:
        lvl = {"DEBUG": "D", "INFO": "I", "WARNING": "W", "ERROR": "E",
               "CRITICAL": "E"}.get(record.levelname, "?")
        ts = f"{record.created - _START:10.3f} " if self.timestamps else ""
        return f"{lvl} {ts}{record.name}: {record.getMessage()}"


def setup_logging(level: str | None = None, log_file: str | None = None) -> None:
    """Send the package's log to stderr (and `log_file`) at `level`. Safe to
    call more than once (reconfigures)."""
    level = level or os.environ.get("EAGLE_LOG_LEVEL", "info")
    log_file = log_file or os.environ.get("EAGLE_LOG_FILE")
    fmt = _Formatter(os.environ.get("EAGLE_LOG_TIMESTAMPS", "1") == "1")
    root = logging.getLogger("eagle_tpu_torch")
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    sinks: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if log_file:
        sinks.append(logging.FileHandler(log_file))
    for h in sinks:
        h.setFormatter(fmt)
        root.addHandler(h)
    root.setLevel(_LEVELS.get(level.lower(), logging.INFO))
    root.propagate = False
