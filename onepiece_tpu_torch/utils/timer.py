"""Named wall-clock timers that wait for the device.

Port of `onepiece_tpu/utils/timer.py` (the reference's TickTock.h TICK /
TOCK / LogAll). CUDA launches return before the device finishes, so `tock`
waits for the device of an optional tensor first, with
`torch.cuda.synchronize(device)` where the JAX package calls
`block_until_ready`; otherwise each stage would read microseconds and the
last one would absorb the whole pipeline. A CPU tensor needs no wait.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Timer:
    def __init__(self):
        self._starts: dict[str, float] = {}
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    def tick(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def tock(self, name: str, sync_value: torch.Tensor | None = None) -> float:
        """Stop timer `name` and return its ms; with a CUDA tensor
        `sync_value`, wait for its device first."""
        if sync_value is not None and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        dt = time.perf_counter() - self._starts[name]
        self._totals[name] += dt
        self._counts[name] += 1
        return dt * 1e3

    def mean_ms(self, name: str) -> float:
        c = self._counts[name]
        return self._totals[name] / c * 1e3 if c else 0.0

    def log_all(self) -> str:
        """Print and return one line a timer (the reference's `LogAll`)."""
        out = "\n".join(
            f"[Timer] {k}: total {v * 1e3:.2f} ms, mean {self.mean_ms(k):.2f} ms over {self._counts[k]}"
            for k, v in sorted(self._totals.items())
        )
        print(out)
        return out
