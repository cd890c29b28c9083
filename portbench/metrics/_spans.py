"""The program's own spans over the traced stretch, for the span metrics.

`onepiece_tpu_torch.utils.tracing` records spans while a torch profiler
records, stamped with `time.time_ns()`: the clock of the profiler's host
events, so the stretch's bounds [lo, hi] select the spans of the traced
scan. Self time is a span's length less its children's, and goes to the
layer its name begins with (`integration.keys` -> `integration`). A
program without the recorder, or a run without a trace, gives None
everywhere here."""

from __future__ import annotations

import numpy as np


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from onepiece_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def in_stretch(spans: list, lo: int, hi: int) -> list:
    """(index, span) of the closed spans that lie inside [lo, hi]."""
    return [(i, s) for i, s in enumerate(spans) if s.end_ns >= 0 and s.start_ns >= lo and s.end_ns <= hi]


def self_ns(spans: list, lo: int, hi: int) -> dict[str, int]:
    """Self time (ns) by layer of the spans inside [lo, hi]."""
    kept = in_stretch(spans, lo, hi)
    children: dict[int, int] = {}
    for _, s in kept:
        if s.parent >= 0:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    out: dict[str, int] = {}
    for i, s in kept:
        layer = s.name.split(".", 1)[0]
        out[layer] = out.get(layer, 0) + s.end_ns - s.start_ns - children.get(i, 0)
    return out


def traced(ctx):
    """(spans, lo, hi) of a traced run whose program records spans, or None."""
    tr = recorder()
    if ctx.traced is None or tr is None:
        return None
    return tr.spans(), ctx.traced["lo"], ctx.traced["hi"]


def layer_ms(ctx, layer: str, per_frame: bool = True):
    """Self time of `layer`'s spans in the traced scan (ms, a frame or a
    scan), or None where the scan has no span of that layer."""
    t = traced(ctx)
    if t is None:
        return None
    ns = self_ns(*t).get(layer)
    if ns is None:
        return None
    return ns / 1e6 / (ctx.traced_frames() if per_frame else 1)


def syncs(ctx):
    """The program's counted waits for the device (the `n` of each `sync.*`
    span) in the traced scan, or None."""
    t = traced(ctx)
    if t is None:
        return None
    found = [s for _, s in in_stretch(*t) if s.name.startswith("sync.")]
    return sum(s.attrs.get("n", 1) for s in found) if found else None


def idle_in_spans(spans: list, lo: int, hi: int, dev_start, dev_end) -> float | None:
    """The share of the device's idle time in [lo, hi] during which the host
    was inside some program span: (|S| - |S and B|) / (|[lo, hi]| - |B|),
    S the union of the spans, B of the device's intervals."""
    from portbench import trace

    kept = [s for _, s in in_stretch(spans, lo, hi)]
    b = trace.merge(np.asarray(dev_start, np.int64), np.asarray(dev_end, np.int64))
    idle = hi - lo - trace.busy_ns(*b, lo, hi)
    if idle <= 0 or not kept:
        return None
    sp = trace.merge(np.asarray([s.start_ns for s in kept], np.int64), np.asarray([s.end_ns for s in kept], np.int64))
    both = trace.busy_ns(*_intersect(*sp, *b), lo, hi)
    return (trace.busy_ns(*sp, lo, hi) - both) / idle


def _intersect(a_s, a_e, b_s, b_e):
    """The pairwise intersections of two sets of disjoint sorted intervals."""
    out_s, out_e = [], []
    i = j = 0
    while i < len(a_s) and j < len(b_s):
        s, e = max(a_s[i], b_s[j]), min(a_e[i], b_e[j])
        if e > s:
            out_s.append(s)
            out_e.append(e)
        if a_e[i] < b_e[j]:
            i += 1
        else:
            j += 1
    return np.asarray(out_s, np.int64), np.asarray(out_e, np.int64)
