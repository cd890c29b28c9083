"""Metric readers, one file a metric, found by name: `metrics/<name>.py`
holds `KIND` ("end_to_end" or "per_layer"), `UNIT` and `read(ctx)`, which
returns the metric's value from a run's records (`Context`) or None where
the run has nothing for it to read; the harness then leaves it out."""

from __future__ import annotations

import importlib.util
import statistics
from pathlib import Path

from .. import roofline
from .. import trace as trace_mod

HERE = Path(__file__).resolve().parent


def load_all() -> dict:
    """{name: module} of every reader here; a name may hold dots."""
    out = {}
    for p in sorted(HERE.glob("*.py")):
        if p.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{p.stem.replace('.', '_')}", p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[p.stem] = mod
    return out


class Context:
    """A run as the readers see it: the driver's record."""

    def __init__(self, rec: dict, cfg: dict, mix: dict):
        self.cfg = cfg
        self.mix = mix
        self.frames = rec["frames"]
        self.window_s = rec["window_s"]
        self.chunk_ms = rec["chunk_ms"]
        self.grow_ms = rec["grow_ms"]
        self.mesh_ms = rec["mesh_ms"]
        self.setup_s = rec["setup_s"]
        self.syncs = rec["syncs"]
        self.work = rec.get("work", {})
        t = rec.get("trace")
        self.traced = t if t is not None and not t["empty"] else None

    # --- the traced stretch -------------------------------------------------

    def stretch(self):
        """(busy seconds, window seconds) of the device over the traced
        stretch: the union of its device intervals over its length."""
        if self.traced is None:
            return None
        t = self.traced
        return trace_mod.busy_ns(t["dev_start"], t["dev_end"], t["lo"], t["hi"]) / 1e9, (t["hi"] - t["lo"]) / 1e9

    def traced_frames(self) -> int:
        return self.traced["frames"] if self.traced else 0

    def device_ops(self) -> int:
        return sum(self.traced["counts"].values()) if self.traced else 0

    def kernel_seconds(self, parts: list[str]) -> float:
        if self.traced is None:
            return 0.0
        return sum(s for n, s in self.traced["seconds"].items() if any(p in n for p in parts))

    def roofline_share(self, kernel: str):
        """100 x the kernel's least time over its device time in the stretch."""
        spec = roofline.kernels().get(kernel)
        if spec is None or kernel not in self.work:
            return None
        t = self.kernel_seconds(spec["kernels"])
        if t <= 0.0:
            return None
        return 100.0 * roofline.bound_s(self.work[kernel], spec) / t


def p95(values: list[float]):
    """The 95th percentile (statistics' exclusive method), or None with
    fewer than 20 values."""
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[-1]
