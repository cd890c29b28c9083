"""The program's stages as spans and its waits for the device as counters,
recorded while a torch profiler records.

    with tracing.span("integration.keys", frame=i):
        ...
    with tracing.sync("fused_slam.grow_check"):  # a span that also counts
        n = int(table.num_active)

The recorder is on exactly while a `torch.profiler` (or
`torch.autograd.profiler`) session records, as the profiler's own flag
says: nothing else turns it on. Off, `span` and `sync` cost the flag's
read and return one shared no-op context; no clock is read and nothing is
kept. On, a span enters a profiler range of its name, so the stages lie
in the same trace as the device's kernels, and keeps `Span` records
stamped with `time.time_ns()`, the Unix-epoch nanoseconds that the
profiler's host events carry, so that a reader can join the two by time.

Names are `<layer>.<stage>`; a reader takes the layer from the prefix.
A name that starts with "." takes the layer of the enclosing span, so
that code shared by two layers reports to its caller's: `.ransac` inside
`closure.pair_track` is `closure.ransac`, inside `sparse.track`
`sparse.ransac`.
`sync.<site>` spans wrap the program's lines that make the host wait for
the device, and `sync` counts them under the same name. Counters count
only while the recorder is on.

The recorder is module state for the one thread that drives the device;
it is not safe to open spans from several threads. It keeps at most
`MAX_SPANS` spans and counts the ones past that in `dropped()`.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1_000_000


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns() at entry
    end_ns: int  # at exit; -1 while the span is open
    parent: int  # index of the enclosing span, -1 for an outermost one
    root: int  # index of the outermost span around it (its own index if outermost)
    attrs: dict


_OFF = contextlib.nullcontext()
_spans: list[list] = []  # [name, start, end, parent, root, attrs], end -1 while open
_open: list[int] = []  # indices of the open spans, innermost last
_counts: dict[str, int] = {}
_dropped = 0


def enabled() -> bool:
    return _profiler._is_profiler_enabled


class _Recorded:
    __slots__ = ("name", "attrs", "index", "range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        global _dropped
        parent = _open[-1] if _open else -1
        if self.name[0] == "." and parent >= 0:
            self.name = _spans[parent][0].split(".", 1)[0] + self.name
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        if len(_spans) >= MAX_SPANS:
            _dropped += 1
            self.index = -1
            return self
        self.index = len(_spans)
        _spans.append([self.name, time.time_ns(), -1, parent, _spans[parent][4] if parent >= 0 else self.index,
                       self.attrs])
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        if _open and _open[-1] == self.index:  # not forgotten by `clear` meanwhile
            _spans[self.index][2] = time.time_ns()
            _open.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager: the span `name` with `attrs` around its block."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` (only while the recorder is on)."""
    if _profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def sync(site: str, n: int = 1):
    """The span `sync.<site>` (attribute `n`) around a block that makes the
    host wait for the device n times, counted under the same name."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    name = "sync." + site
    _counts[name] = _counts.get(name, 0) + n
    return _Recorded(name, {"n": n})


def note(**attrs) -> None:
    """Set attributes on the innermost open span (no-op where none is open)."""
    if _open and _profiler._is_profiler_enabled:
        _spans[_open[-1]][5].update(attrs)


def spans() -> list[Span]:
    """Every span kept so far, in the order they were opened."""
    return [Span(*s) for s in _spans]


def counters() -> dict[str, int]:
    return dict(_counts)


def dropped() -> int:
    return _dropped


def clear() -> None:
    """Forget the spans and counters (spans still open keep their blocks'
    ranges but are no longer kept)."""
    global _dropped
    _spans.clear()
    _open.clear()
    _counts.clear()
    _dropped = 0
