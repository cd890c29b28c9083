"""Component logging and per-frame metrics.

Port of `onepiece_tpu/utils/logging.py`: the reference's coloured
`[Component]::[LEVEL]::msg` console lines on stderr (ConsoleColor.h), and
a metrics dict a frame appended to a JSONL file for offline analysis.
"""

from __future__ import annotations

import json
import sys
import time

_COLORS = {"DEBUG": "\033[34m", "INFO": "\033[32m", "WARN": "\033[33m", "ERROR": "\033[31m"}
_RESET = "\033[0m"

VERBOSITY = 1  # 0 silent, 1 info, 2 debug


def log(component: str, level: str, msg: str) -> None:
    if VERBOSITY == 0 or (level == "DEBUG" and VERBOSITY < 2):
        return
    print(f"{_COLORS.get(level, '')}[{component}]::[{level}]::{msg}{_RESET}", file=sys.stderr)


class MetricsLogger:
    """Keeps each recorded metrics dict (with a "ts" wall-clock stamp unless
    given) and, with a `path`, appends it to that JSONL file at once."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.history: list[dict] = []

    def record(self, **metrics) -> None:
        metrics.setdefault("ts", time.time())
        self.history.append(metrics)
        if self._fh:
            self._fh.write(json.dumps(metrics) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
