"""The closed-loop scan driver: one client replays recorded scans from
memory, back to back, handing in the next chunk when the last has finished
on the device.

A mix file (`traffic/<mix>.json`) sets the trajectory and its length, the
frames of a scan, the chunk and the scans whose outputs are judged. A scan starts at a loop frame drawn from the seed and
runs `scan_frames` frames of the closed loop from there (wrapping), so
every scan sees the same pairs of frames in another order. A scan is a
fresh system instance (`systems/<system>.py`), allocated inside the window.

The window closes at the first chunk boundary after `seconds`; its rate is
the frames of the chunks finished in it over its length. Each chunk is
timed from the hand-in of its frames until the device has finished it
(`torch.cuda.synchronize()` after `feed` and `grow`). Scans whose outputs
are judged are run to their end after the window if it closed first; that
work is not counted.

With `trace`, one whole scan (`trace_scan`) runs under the profiler, the
program's synchronising calls are counted over the window, and the pool's
growth and the scan's end (`finish`: the mesh, in a configuration that
meshes) are timed apart, each between two synchronisations.
"""

from __future__ import annotations

import gc
import importlib
import time
import warnings
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from ..inputs import synthetic

SYNC_WARNING = "called a synchronizing CUDA operation"


class Frames:
    """The loop's frames on the device, stored twice over, so that a scan
    from any start frame is a run of contiguous views."""

    def __init__(self, grays, depths, rgbs):
        self.grays = torch.cat([grays, grays])
        self.depths = torch.cat([depths, depths])
        self.rgbs = torch.cat([rgbs, rgbs])

    def scan(self, start: int, count: int):
        sl = slice(start, start + count)
        return self.grays[sl], self.depths[sl], self.rgbs[sl]


def make_frames(cfg: dict, mix: dict, seed: int, device) -> Frames:
    """Render the mix's loop on `device` in batches, then the sensor model
    (its draws from the seed) and a colour tint from the seed, quantised
    to 8 bits as a TUM RGB image is."""
    c = cfg["camera"]
    poses = torch.from_numpy(synthetic.TRAJECTORIES[mix["trajectory"]](mix["loop_frames"])).to(device)
    scene = synthetic.default_scene(device)
    depths, grays = [], []
    for i in range(0, poses.shape[0], mix["render_batch"]):
        d, g = synthetic.render_batch(scene, poses[i : i + mix["render_batch"]], c["fx"], c["fy"], c["cx"], c["cy"],
                                      c["height"], c["width"], num_steps=mix["render_steps"])
        depths.append(d)
        grays.append(g)
    depths, grays = torch.cat(depths), torch.cat(grays)
    rng = np.random.default_rng([seed, 1])
    grays, depths = synthetic.corrupt_batch(grays, depths, int(rng.integers(0, 2**31)))
    tint = torch.from_numpy(rng.uniform(0.6, 1.0, 3).astype(np.float32)).to(device)
    rgb8 = torch.clamp(grays[..., None] * tint * 255.0, 0, 255).to(torch.uint8).to(torch.float32)
    return Frames(grays, depths, rgb8 / torch.full((), 255.0, device=device))


def scan_starts(mix: dict, seed: int, count: int = 4096) -> np.ndarray:
    """Each scan's first frame, drawn from the seed on the closed loop."""
    return np.random.default_rng([seed, 2, 0]).integers(0, mix["loop_frames"], count)


class SyncCount:
    """Counts the program's synchronising CUDA calls (sync debug mode
    "warn") inside `counting()` blocks; a CPU run has none to count."""

    def __init__(self, dev: torch.device):
        self.count = 0
        self.dev = dev

    @contextmanager
    def counting(self):
        if self.dev.type != "cuda":
            yield
            return
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.count += sum(SYNC_WARNING in str(w.message) for w in caught)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float | None = None) -> dict:
    """Set-up (from `t_start`, the process's start), the window and the
    judged scan; returns the run's record."""
    t0 = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    judge = importlib.import_module(f"portbench.reference.{cfg['system']}")
    frames = make_frames(cfg, mix, seed, dev)
    n_chunks = mix["scan_frames"] // mix["chunk"]
    starts = scan_starts(mix, seed)

    def one_scan(start: int):
        scan = system.Scan(cfg, dev)
        g, d, c = frames.scan(start, mix["scan_frames"])
        for i in range(n_chunks):
            sl = slice(i * mix["chunk"], (i + 1) * mix["chunk"])
            scan.feed(g[sl], d[sl], c[sl])
            scan.grow()
        return scan.finish()

    # warm-up: one scan at the cell's own shapes builds and loads every kernel
    one_scan(int(scan_starts(mix, seed + 1, 1)[0]))
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    setup_s = time.perf_counter() - t0

    rng = np.random.default_rng([seed, 4, 0])
    judged = int(rng.integers(0, mix["judged_scans"]))
    keep = {judged} | ({mix["trace_scan"]} if trace else set())
    syncs = SyncCount(dev)

    def counting():  # the program's syncs inside the window
        return syncs.counting() if trace and t_close is None else nullcontext()
    chunk_ms, grow_ms, mesh_ms, kept = [], [], [], {}
    frames_done, scans_done = 0, 0
    prof, traced = None, None
    t_open = time.perf_counter()
    deadline, t_close = t_open + seconds, None
    k = 0
    while True:
        start = int(starts[k % len(starts)])
        profiled = trace and k == mix["trace_scan"]
        if profiled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        span = torch.profiler.record_function("portbench.scan") if profiled else nullcontext()
        with span:
            with counting():
                scan = system.Scan(cfg, dev)
            g, d, c = frames.scan(start, mix["scan_frames"])
            complete = True
            for i in range(n_chunks):
                if t_close is None and time.perf_counter() >= deadline:
                    t_close = time.perf_counter()
                if t_close is not None and k not in keep:
                    complete = False
                    break
                sl = slice(i * mix["chunk"], (i + 1) * mix["chunk"])
                ta = time.perf_counter()
                with counting():
                    scan.feed(g[sl], d[sl], c[sl])
                if trace:
                    _sync(dev)
                    tg = time.perf_counter()
                with counting():
                    grew = scan.grow()
                _sync(dev)
                tb = time.perf_counter()
                if trace and grew and t_close is None:
                    grow_ms.append((tb - tg) * 1e3)
                if t_close is None:
                    chunk_ms.append((tb - ta) * 1e3)
                    frames_done += mix["chunk"]
            if complete:
                tm = time.perf_counter()
                with counting():
                    out = scan.finish()
                _sync(dev)
                if trace and t_close is None:
                    mesh_ms.append((time.perf_counter() - tm) * 1e3)
                if k in keep:
                    kept[k] = (start, out)
                del out
            del scan
        if profiled:
            prof.__exit__(None, None, None)
            traced = dict(start=start, frames=mix["scan_frames"] if complete else None)
        if t_close is None:
            scans_done += complete
            if time.perf_counter() >= deadline:
                t_close = time.perf_counter()
        k += 1
        if t_close is not None and k > max(keep):
            break
    window_s = t_close - t_open
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    rec = dict(device_name=torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
               setup_s=setup_s, window_s=window_s, frames=frames_done, scans=scans_done, chunk_ms=chunk_ms, grow_ms=grow_ms, mesh_ms=mesh_ms,
               memory_peak_bytes=memory_peak, judged_scan=judged, syncs=syncs.count if trace else None)
    if trace:
        from .. import trace as trace_mod

        rec["trace"] = trace_mod.summarize(prof, traced)
        del prof
    # the judged scan against the reference, once the window has closed and
    # the peak has been read
    start, out = kept.pop(judged)
    gc.collect()
    g, d, c = frames.scan(start, mix["scan_frames"])
    rec["readings"] = judge.judge(out, g, d, c, {**cfg, **mix})
    if trace:  # the traced scan's work, recounted by the reference
        from .. import roofline

        t_start, t_out = (start, out) if mix["trace_scan"] == judged else kept.pop(mix["trace_scan"])
        counts = judge.recount(t_out, *frames.scan(t_start, mix["scan_frames"]), {**cfg, **mix})
        rec["work"] = roofline.count_all(cfg, mix, t_out, counts)
    return rec
