"""The span metrics: `metrics/_spans.py` on hand-made spans, and the tiny
traced runs of both cells on the CPU reporting every span metric of their
cell. A CPU profile has no device operations, so those runs read the
profiler's `aten::copy_` host events as the device's."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import ROOT, SPARSE_MIX, TINY_MIX

from portbench import trace
from portbench.metrics import _spans
from onepiece_tpu_torch.utils import tracing
from onepiece_tpu_torch.utils.tracing import Span

NEW = {"loop_self_ms", "tracking_self_ms", "integration_self_ms", "grow_span_ms", "meshing_self_ms",
       "sparse_self_ms", "closure_self_ms", "ba_self_ms", "sync_wait_ms", "program_syncs_per_frame"}

# two chunks of one frame each, a sync inside a tracking level, and spans
# before and after the stretch [100, 400]
SPANS = [
    Span("loop.chunk", 50, 90, -1, 0, {}),  # before the stretch
    Span("loop.chunk", 100, 200, -1, 1, {}),
    Span("loop.frame", 110, 190, 1, 1, {}),
    Span("tracking.level", 120, 160, 2, 1, {"level": 0}),
    Span("sync.grow_occupancy", 130, 140, 3, 1, {"n": 2}),
    Span("grow.pool", 200, 260, -1, 5, {"grew": True}),
    Span("grow.pool", 270, 280, -1, 6, {"grew": False}),
    Span("loop.chunk", 300, 390, -1, 7, {}),
    Span("loop.frame", 310, 380, 7, 7, {}),
    Span("loop.chunk", 395, 420, -1, 9, {}),  # runs past the stretch
    Span("loop.chunk", 430, -1, -1, 10, {}),  # still open
]


def test_self_time_by_layer_on_hand_made_spans():
    got = _spans.self_ns(SPANS, 100, 400)
    # loop: chunk 100 - frame 80, frame 80 - level 40, chunk 90 - frame 70, frame 70
    assert got == {"loop": 20 + 40 + 20 + 70, "tracking": 40 - 10, "sync": 10, "grow": 60 + 10}
    assert [i for i, _ in _spans.in_stretch(SPANS, 100, 400)] == list(range(1, 9))
    assert _spans.self_ns(SPANS, 0, 1000)["loop"] == 40 + 150 + 25
    assert _spans.self_ns(SPANS, 500, 600) == {}


def test_readers_on_hand_made_spans(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: SPANS)
    traced = dict(lo=100, hi=400, frames=2, dev_start=np.array([120, 300], np.int64),
                  dev_end=np.array([150, 320], np.int64))
    ctx = SimpleNamespace(traced=traced, traced_frames=lambda: 2)
    from portbench import metrics

    readers = metrics.load_all()
    assert readers["loop_self_ms"].read(ctx) == pytest.approx(150 / 2 / 1e6)
    assert readers["tracking_self_ms"].read(ctx) == pytest.approx(30 / 2 / 1e6)
    assert readers["grow_span_ms"].read(ctx) == pytest.approx(60 / 1e6)  # the span that grew
    assert readers["meshing_self_ms"].read(ctx) is None  # no span of the layer
    assert readers["program_syncs_per_frame"].read(ctx) == 1.0
    assert readers["sync_wait_ms"].read(ctx) == pytest.approx(10 / 2 / 1e6)
    assert all(readers[n].read(SimpleNamespace(traced=None, traced_frames=lambda: 0)) is None for n in NEW)
    # idle 300 - 50 = 250 ns; the spans inside the stretch cover [100, 260],
    # [270, 280] and [300, 390], all 50 busy ns among them
    share = _spans.idle_in_spans(SPANS, 100, 400, traced["dev_start"], traced["dev_end"])
    assert share == pytest.approx((160 + 10 + 90 - 50) / 250)


class _AsDevice:
    """A host event read as a device operation."""

    def __init__(self, e):
        self.e = e

    def name(self):
        return self.e.name()

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.e.start_ns()

    def end_ns(self):
        return self.e.end_ns()


def _with_capacity(workload, cfg, mix, capacity=64):
    return workload, {**cfg, "capacity": capacity}, mix


@pytest.mark.parametrize("cell", ["dense.loop", "ba.loop"])
def test_tiny_traced_runs_report_their_span_metrics(cell, monkeypatch, tiny_run):
    real = trace.summarize

    def summarize(prof, traced):
        events = [_AsDevice(e) if e.name() == "aten::copy_" else e for e in prof.profiler.kineto_results.events()]
        fake = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
        return real(fake, traced)

    monkeypatch.setattr(trace, "summarize", summarize)
    from portbench import run

    if cell == "dense.loop":  # a pool small enough to grow within the tiny scan
        load = run.load_cell
        monkeypatch.setattr(run, "load_cell", lambda name: _with_capacity(*load(name)))
    tracing.clear()
    rc, res = tiny_run(cell, trace=1)
    assert rc == 0 and res["correct"] is True
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"] if m["name"] in NEW and cell in m["workloads"]}
    assert want == {m for m in NEW if m in res["metrics"]}, res["metrics"]
    assert all(res["metrics"][m]["value"] > 0 for m in want)
    # the recorder was on for the traced scan alone: its counters are that scan's
    frames = (TINY_MIX if cell == "dense.loop" else SPARSE_MIX)["scan_frames"]
    counted = sum(n for k, n in tracing.counters().items() if k.startswith("sync."))
    assert res["metrics"]["program_syncs_per_frame"]["value"] == pytest.approx(counted / frames)
