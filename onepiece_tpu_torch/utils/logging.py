"""Component logging.

Port of `log` in `onepiece_tpu/utils/logging.py`: the reference's coloured
`[Component]::[LEVEL]::msg` console lines on stderr (ConsoleColor.h). The
program's stage timings are spans of `utils/tracing.py`.
"""

from __future__ import annotations

import sys

_COLORS = {"DEBUG": "\033[34m", "INFO": "\033[32m", "WARN": "\033[33m", "ERROR": "\033[31m"}
_RESET = "\033[0m"

VERBOSITY = 1  # 0 silent, 1 info, 2 debug


def log(component: str, level: str, msg: str) -> None:
    if VERBOSITY == 0 or (level == "DEBUG" and VERBOSITY < 2):
        return
    print(f"{_COLORS.get(level, '')}[{component}]::[{level}]::{msg}{_RESET}", file=sys.stderr)
