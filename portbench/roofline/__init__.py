"""Work counts of the program's kernels, one file a kernel.

`roofline/<kernel>.json` names the device kernels that do the work (by a
part of their names, as the profiler records them), the peak that bounds
it and the systems that run it; `roofline/<kernel>.py` counts the bytes
and operations that the inputs and the outputs need, whatever implements
the work: `count(cfg, mix, out, counts) -> {"bytes": .., "ops": ..}` or
None. A later kernel that does the same work adds its name to the list.
`peaks.json` holds the card's published peaks.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def kernels() -> dict:
    """{kernel: its data file} of every kernel counted here."""
    return {p.stem: json.loads(p.read_text()) for p in sorted(HERE.glob("*.json")) if p.stem != "peaks"}


def count_all(cfg: dict, mix: dict, out, counts) -> dict:
    """{kernel: work} of the kernels that the configuration's system runs."""
    work = {}
    for name, spec in kernels().items():
        if cfg["system"] not in spec["systems"]:
            continue
        w = importlib.import_module(f"portbench.roofline.{name}").count(cfg, mix, out, counts)
        if w is not None:
            work[name] = w
    return work


def bound_s(work: dict, spec: dict) -> float:
    """The least time for the work: the larger of its bytes over the memory
    bandwidth and its operations over the peak that `spec` names."""
    pk = peaks()
    return max(work["bytes"] / pk["hbm_bytes_per_s"], work["ops"] / pk[spec["peak"]])
