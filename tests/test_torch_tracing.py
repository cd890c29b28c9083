"""The port's span recorder (`onepiece_tpu_torch/utils/tracing.py`) on the
CPU: off without a profiler (no range, no record), the records of nested
spans under one, its clock against the profiler's own host events, and the
stage spans and sync counters that the fused dense and BA systems open.
Needs no JAX."""

import numpy as np
import pytest
import torch

from onepiece_tpu_torch.geometry.camera import TUM_CAMERA
from onepiece_tpu_torch.lcdetection import mild
from onepiece_tpu_torch.systems import fused_ba
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.utils import synthetic, tracing

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def one_thread_and_a_clear_recorder():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(threads)


def _spans_by_name():
    out = {}
    for s in tracing.spans():
        out.setdefault(s.name, []).append(s)
    return out


def test_off_without_a_profiler_records_nothing(monkeypatch):
    def no_range(*_a, **_k):
        raise AssertionError("entered a profiler range with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    assert not tracing.enabled()
    with tracing.span("loop.chunk", frames=3) as a, tracing.span(".inner"), tracing.sync("site", 2):
        tracing.count("sync.other")
        tracing.note(grew=True)
    assert a is None  # the shared no-op context
    assert tracing.spans() == [] and tracing.counters() == {}


def test_nested_spans_under_a_profiler():
    with torch.profiler.profile(activities=CPU):
        with tracing.span("loop.chunk", frames=2):
            for i in range(2):
                with tracing.span("sparse.track", rung="main"):
                    with tracing.span(".ransac", round=1):
                        with tracing.sync("kabsch_svd"):
                            pass
                    tracing.note(ok=i == 0)
        with tracing.span("grow.pool"):
            tracing.count("sync.grow_occupancy", 3)
    s = tracing.spans()
    assert [x.name for x in s] == ["loop.chunk", "sparse.track", "sparse.ransac", "sync.kabsch_svd",
                                   "sparse.track", "sparse.ransac", "sync.kabsch_svd", "grow.pool"]
    assert [x.parent for x in s] == [-1, 0, 1, 2, 0, 4, 5, -1]
    assert [x.root for x in s] == [0] * 7 + [7]
    assert s[0].attrs == {"frames": 2} and s[2].attrs == {"round": 1} and s[3].attrs == {"n": 1}
    assert s[1].attrs == {"rung": "main", "ok": True} and s[4].attrs == {"rung": "main", "ok": False}
    for x in s:
        assert 0 < x.start_ns <= x.end_ns
        if x.parent >= 0:
            p = s[x.parent]
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns
    assert tracing.counters() == {"sync.kabsch_svd": 2, "sync.grow_occupancy": 3}
    # counting stops with the profiler
    tracing.count("sync.grow_occupancy")
    with tracing.span("loop.chunk"):
        pass
    assert len(tracing.spans()) == 8 and tracing.counters()["sync.grow_occupancy"] == 3


def test_recorder_clock_is_the_profilers():
    n = 200
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(50):  # warm
            with tracing.span("warm.up"):
                pass
        for _ in range(n):
            with tracing.span("clock.check"):
                torch.zeros(4)
    ours = [s for s in tracing.spans() if s.name == "clock.check"]
    theirs = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "clock.check"),
                    key=lambda e: e.start_ns())
    assert len(ours) == len(theirs) == n
    gaps = np.array([(abs(e.start_ns() - s.start_ns), abs(e.end_ns() - s.end_ns)) for e, s in zip(theirs, ours)])
    assert (np.median(gaps, axis=0) < 20_000).all(), np.median(gaps, axis=0)
    assert gaps.max() < 200_000, gaps.max(axis=0)


def _dense_frames(n: int):
    cam = TUM_CAMERA.pyramid(4)[3]  # 80x60
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(p), cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
                            num_steps=32) for p in synthetic.orbit_trajectory(n)]
    return cam, torch.stack([g for _, g in out]), torch.stack([d for d, _ in out])


def test_dense_chunk_opens_each_stage_once_a_frame():
    cam, grays, depths = _dense_frames(4)
    slam = FusedDenseFusion(cam, device="cpu", capacity=64, table_size=1024, kmax=512, stride=2,
                            voxel_size=0.04, truncation=0.16, iters=(2, 1, 1))
    with torch.profiler.profile(activities=CPU):
        slam.process_chunk(grays, depths)
        grew = slam.maybe_grow()
        slam.finalize()
        slam.to_volume()
    k = len(grays)
    by = _spans_by_name()
    assert grew and [s.attrs["grew"] for s in by["grow.pool"]] == [True]
    want = {"loop.chunk": 1, "loop.frame": k, "loop.init": 1, "tracking.preprocess": k,
            "tracking.level": 3 * (k - 1), "tracking.chain": k - 1, "integration.bilateral": k,
            "integration.keys": k, "integration.insert": k, "integration.fuse": k, "grow.pool": 1,
            "meshing.finalize": 1, "meshing.to_volume": 1}
    assert {n: len(by.get(n, [])) for n in want} == want
    assert sorted(s.attrs["level"] for s in by["tracking.level"]) == sorted([0, 1, 2] * (k - 1))
    frame_of = {i: s.attrs.get("frame") for i, s in enumerate(tracing.spans()) if s.name == "loop.frame"}
    for s in tracing.spans():
        if s.name.startswith(("tracking.", "integration.")):  # inside a frame, and that frame inside the chunk
            p = s
            while p.name != "loop.frame":
                p = tracing.spans()[p.parent]
            assert tracing.spans()[p.parent].name == "loop.chunk"
    assert sorted(frame_of.values()) == list(range(k))
    # every sync site counted as often as its span was passed, n each
    counted = {}
    for s in tracing.spans():
        if s.name.startswith("sync."):
            counted[s.name] = counted.get(s.name, 0) + s.attrs["n"]
    assert counted == tracing.counters()
    assert counted == {"sync.grow_saturated": 1, "sync.grow_occupancy": 1, "sync.finalize": 2,
                       "sync.volume_count": 1, "sync.volume_coords": 1}


def test_ba_chunk_opens_sparse_closure_and_ba_spans(monkeypatch):
    cam = TUM_CAMERA.pyramid(3)[2]  # 160x120
    scene = synthetic.default_scene()
    out = [synthetic.render(scene, torch.from_numpy(p), cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
                            num_steps=64) for p in synthetic.orbit_trajectory(12)[:6]]
    grays, depths = torch.stack([g for _, g in out]), torch.stack([d for d, _ in out])
    orig = mild.candidates_from_scores

    def every_candidate_salient(*a, **k):  # so that the chunk tracks loop-closure pairs
        top, ok = orig(*a, **k)
        return top, torch.ones_like(ok)

    monkeypatch.setattr(mild, "candidates_from_scores", every_candidate_salient)
    slam = fused_ba.FusedBASlam(cam, device="cpu", max_keypoints=500, keyframe_disparity=10.0, pt_capacity=2048,
                                obs_capacity=4096, ba_iters=2)
    with torch.profiler.profile(activities=CPU):
        slam.process_chunk(grays, depths)
    k = len(grays)
    by = _spans_by_name()
    assert len(by["loop.chunk"]) == 1 and len(by["loop.frame"]) == k and len(by["sparse.features"]) == 1
    assert [s.attrs["rung"] for s in by["sparse.track"]].count("main") == k - 1  # frame 0 is the bootstrap
    assert len(by["closure.candidates"]) >= 1 and len(by["closure.pose_graph"]) == 1
    assert len(by["closure.pair_track"]) == slam.lc_pairs > 0
    for s in by["closure.pair_track"]:  # the shared track stages report to loop closure
        kids = {c.name for c in tracing.spans() if c.parent == tracing.spans().index(s)}
        assert kids == {"closure.match", "closure.ransac", "closure.rematch", "closure.select", "closure.summary"}
    assert len(by["ba.link"]) == 1 and len(by["ba.lm"]) == 1 and len(by["ba.step"]) == 2
    assert len(by["ba.edge"]) == by["ba.link"][0].attrs["bound"]
    tracks = len(by["sparse.track"]) + len(by["closure.pair_track"])
    assert tracing.counters() == {"sync.ladder": k, "sync.kabsch_svd": 2 * 2 * tracks, "sync.promotions": 1,
                                  "sync.lc_pairs": 1, "sync.chunk_fetch": 1}
    roots = {s.root for s in tracing.spans()}
    assert roots == {0} and tracing.spans()[0].name == "loop.chunk"
