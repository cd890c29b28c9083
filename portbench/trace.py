"""Reduction of one profiled stretch (`torch.profiler`, CUPTI on the card)
to what the per-layer metrics read: the device's busy intervals, the device
time and count of each operation by name, and the longest idle gaps
labelled with the host operation that ran across them. Everything comes
from the profiler's own records; nothing here reads the program."""

from __future__ import annotations

import numpy as np
import torch

SPAN = "portbench.scan"
TOP = 10


def merge(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals, as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def busy_ns(starts, ends, lo: int, hi: int) -> int:
    s, e = merge(starts, ends)
    return int(np.clip(np.minimum(e, hi) - np.maximum(s, lo), 0, None).sum())


def _host_label(cpu_s, cpu_e, cpu_n, t: int) -> str:
    """The innermost host operation running at time t (the latest started
    one that has not ended)."""
    i = int(np.searchsorted(cpu_s, t, side="right")) - 1
    for j in range(i, max(i - 400, -1), -1):
        if cpu_e[j] >= t:
            return cpu_n[j]
    return "host (no operation)"


def summarize(prof, traced: dict | None) -> dict:
    """The stretch of the `portbench.scan` span: its bounds (ns), the device
    intervals inside it, device seconds and counts by operation name, the
    device operations that took most time and the longest idle gaps by
    what the host was doing."""
    dev_s, dev_e, dev_n = [], [], []
    cpu_s, cpu_e, cpu_n = [], [], []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            dev_s.append(e.start_ns())
            dev_e.append(e.end_ns())
            dev_n.append(name)
        elif name == SPAN:
            lo, hi = e.start_ns(), e.end_ns()
        elif not name.startswith(("cuda", "cu")):  # runtime calls: the op above them says more
            cpu_s.append(e.start_ns())
            cpu_e.append(e.end_ns())
            cpu_n.append(name)
    if lo is None or not dev_s or traced is None or traced["frames"] is None:
        return dict(empty=True)
    dev_s, dev_e = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    inside = (dev_e > lo) & (dev_s < hi)
    dev_s, dev_e = dev_s[inside], dev_e[inside]
    names = [n for n, k in zip(dev_n, inside) if k]
    seconds, counts = {}, {}
    for n, d in zip(names, (dev_e - dev_s) / 1e9):
        seconds[n] = seconds.get(n, 0.0) + float(d)
        counts[n] = counts.get(n, 0) + 1
    # idle gaps between the merged device intervals, labelled at their midpoint
    ms, me = merge(dev_s, dev_e)
    gs = np.concatenate([[lo], me])
    ge = np.concatenate([ms, [hi]])
    ok = ge > gs
    gs, ge = gs[ok], ge[ok]
    order = np.argsort(cpu_s, kind="stable")
    cs, ce = np.asarray(cpu_s, np.int64)[order], np.asarray(cpu_e, np.int64)[order]
    cn = [cpu_n[i] for i in order]
    gaps = {}
    for i in np.argsort(gs - ge)[:2000]:  # the longest gaps
        label = _host_label(cs, ce, cn, int((gs[i] + ge[i]) // 2))
        gaps[label] = gaps.get(label, 0.0) + float(ge[i] - gs[i]) / 1e9
    return dict(empty=False, lo=int(lo), hi=int(hi), dev_start=dev_s, dev_end=dev_e, frames=traced["frames"],
                seconds=seconds, counts=counts, gaps=gaps)


def top(d: dict, n: int = TOP) -> list:
    return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
