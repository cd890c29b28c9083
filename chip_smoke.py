#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`onepiece_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the final `ok` line:
  1. require CUDA; print the card's name and power limit
  2. build the CUDA kernels of onepiece_tpu_torch/csrc/ with nvcc (sm_90a)
  3. TSDF-integrate kernel vs its plain PyTorch version on a real 640x480
     frame (a 16385-row pool), in both image forms, gray (2, H, W) and rgb
     (4, H, W) with seeded uniform colour, at K = 8192 touched slots and
     with the same keys padded to K = 16384; each timed, the gray form at
     K = 8192 also with the L2 cache flushed before every call
  4. dense Gauss-Newton kernel vs its plain versions at 640x480, 320x240
     and 160x120: the normal equations alone (update off), then one step
     (normal equations, 6x6 solve, gate, se3_exp update in one launch)
     from the same T: inliers equal, T within 1e-5; one step and a whole
     level's `iters` launches timed with CUDA events
  5. the slice: FusedDenseFusion on the 16-frame 640x480 orbit
     (process_chunk -> finalize -> to_volume); ATE, block overflow, the
     kernels' launch counts and the absence of host syncs in the frame loop
     are checked, and ms per frame is timed over 5 fresh runs after one
     warm run; then the same with rgbs (seeded uniform colour): the same
     checks, and poses, sdf and weights bit-equal to the gray run's
  6. DenseSlam on 150 frames of the 640x480 `loop_trajectory` (three
     submaps): a warm run records the first nn1 inputs of each ICP call
     (the submap clouds at the ICP's initial pose); the nn1 kernel is held
     against its plain version there and at 32768 x 32768: indices equal,
     d2 bit-equal
  7. the DenseSlam slice again with the launch counts at 0: ATE, finite
     poses, icp_ok on every submap after the first, nn1 launches = 31 x ICP
     calls, no TSDF launch; host syncs counted per frame, per submap and
     inside each ICP call; ms per frame over 3 runs and ms per
     _finish_submap
  8. meshing: the marching-cubes kernel vs its plain version on the fused
     gray and rgb volumes of phase 5 (triangles bit-equal, in order), timed;
     then, each with the launch counts at 0, the reconstruction paths:
     `to_volume().extract_mesh_tensors()` of both phase-5 runs, the vertex
     dedup on the card (`ops/mesh_dedup.py`, held bit-equal to the numpy
     `dedup_triangle_soup` on every mesh), one copy to the host and
     `write_ply_mesh` to a temporary file, each step timed, the vertices
     checked against the synthetic scene's SDF; DenseFusion's post-hoc
     reconstruction of phase 7 (every 8th frame at the optimised poses,
     voxel 0.02 m, through `TSDFVolume.integrate`) and its mesh;
     `PipelinedDenseFusion` on the 16-frame orbit (ATE) and its mesh. For
     the last two, the largest count of distinct blocks a frame touches
     against the first 4,096-key cap of their `touched_block_keys`, and
     their `key_saturated_frames` (frames whose keys filled the cap; their
     key pass is redone at a larger cap, so no block is dropped)
  9. sparse: the Hamming kernel (`csrc/hamming.cu`) against its plain
     versions at the sparse path's shapes: `hamming_match` on the 1000
     descriptors of orbit frames 0 and 1, unwindowed and windowed (20 px
     around the ground-truth prediction), and on an all-valid 1000 x 1000
     pair of seeded random descriptors, indices and distances equal;
     `hamming_table` at 1000 x 1000, equal; `mild_feature_scores` of the
     last loop frame's 1000 descriptors against the 100-frame loop's 128 x
     1000 keyframe database with g = 39, within 1e-5 relative, two calls
     bit-equal and its loop-closure candidates equal; each timed, with the
     launch floor (a one-element `fill_` in the same profiler session)
     beside it, and each failing if the profiler saw any other kernel
     launched in its session (one kernel a call). Then,
     launches counted and host syncs counted, `FusedFBASlam` (defaults) on
     the 16-frame orbit in one chunk (ATE <= 15 mm, no edge overflow; ms per
     frame over 5 runs after a warm run) and on the 100-frame
     `loop_trajectory` in chunks of 25 (ATE <= 30 mm, a loop-closure edge,
     a capacity doubling, no edge overflow; ms per frame over 2 runs); and
     the FBAFusion mesh of the loop (every 8th frame at the optimised poses,
     voxel 0.02 m, truncation 0.1 m: TSDF and marching-cubes kernels, the
     dedup on the card bit-equal to numpy's, |scene SDF| median at the
     vertices < voxel / 2, the volume mapped to the scene by the first
     ground-truth pose, as in phase 8)
 10. BAFusion: the BA Schur kernel (`csrc/ba_schur.cu`) against its plain
     version on the inputs of `FusedBASlam`'s own BA steps, recorded in warm
     runs (the orbit's first step, the loop's last chunk's first step, and
     the latter again with its poses padded to BA_WIDE_FRAMES = 2,048
     keyframe slots, 39 of them live): S,
     rhs_c, b_p, V^-1 of the observed points and the back-substitution
     within KERNEL2_TOL of the largest plain entry, V^-1 of the padding
     points equal, two calls bit-equal; the same at the dampings LM
     reaches after rejections (BA_DAMPINGS), where the damping must move
     the plain S, V^-1 and back-substitution by 10x that tolerance; each
     timed (one LM step's three kernels from the profiler, failing if it
     saw another kernel) with its bound over the capacities and over the
     live frames and points. Then, launches and host syncs counted, `FusedBASlam` (defaults)
     on the 16-frame orbit in one chunk (ATE <= 15 mm and <= 1.5 x the
     FusedFBASlam ATE of phase 9 + 0.1 mm, finite BA mse, no overflow, host
     syncs and reads equal to FusedFBASlam's, two runs bit-equal; ms per
     frame over 5 runs) and on the 100-frame loop in chunks of 25 (ATE <= 30
     mm, a loop-closure edge, world points; ms per frame over 2 runs), ms a
     chunk of the track linker and the LM loop, and the corrupted orbit
     (`corrupt_sequence`: finite poses, >= 3 keyframes; its ATE printed
     beside BENCH_r05's for other chips)
Prints one JSON line of per-kernel results (launches: the counted runs of
phases 5 (gray and rgb), 7 and 8 together, for hamming phase 9's, for
ba_schur phase 10's; ms: the kernels' device time per
wrapper call from the profiler (from CUDA events around each single call
where the profiler records none; a note on stderr says so); event_ms and plain_ms: CUDA events around
back-to-back calls of the wrapper and of the plain version; the TSDF entry
adds the same for the rgb form (rgb_*), the gray form at K = 16384
(k16384_ms) and with a cold L2 (cold_ms); bound_ms: the least time the card
could take for the same work, the larger of bytes over 3.35 TB/s and
float32 operations over 67 TFLOP/s, the published H100 SXM peaks at 700 W
(hamming: __popc counts over PEAK_POPC_PER_S);
roofline_share = bound_ms / ms; the hamming entry adds the windowed, the
all-valid and the MILD times, bounds and shares, and the launch floor; the
ba_schur entry is one LM step's kernels at the orbit's BA call and adds the
loop's (loop_*), the loop's at 2,048 keyframe slots (wide_*), ms/frame and
ms a chunk of the linker and the LM loop), the card line, then
{"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_FRAMES = 16
L2_FLUSH_BYTES = 256 << 20  # read between calls for a cold-L2 time: 5x the H100's 50 MB L2
RENDER_STEPS = 64
KERNEL1_TOL = 1e-5  # sdf and colour, absolute; weights must be equal
KERNEL2_TOL = 1e-4  # JTJ, JTr, cost: max |kernel - plain| / max |plain|
GN_STEP_TOL = 1e-5  # T after one step: sums in another order, sinf / cosf vs torch's
MAX_ATE_M = 2.0e-3
TIMED_RUNS = 5
SLAM_FRAMES = 150  # three submaps of 50 frames
SLAM_TIMED_RUNS = 3
MAX_SLAM_ATE_M = 1.0e-2
NN1_BIG = 32768
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, published
PEAK_F32_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
# float32 operations per element of the work, counted from the kernels' code
TSDF_OPS_PER_VOXEL = 30  # voxel centre, rigid transform, projection
TSDF_OPS_PER_UPDATE = 20  # truncation, weighted averages of sdf and colour
GN_OPS_PER_PIXEL = 98  # valid source pixel: transform, projection, 6-channel bilinear
GN_OPS_PER_INLIER = 166  # Jacobian rows, 27 weighted products and sums, cost
NN1_OPS_PER_PAIR = 8  # 3 sub, 3 mul, 2 add per (query, valid reference)
MC_OPS_PER_VOXEL = 32  # 8 corners: |sdf|, 3 comparisons
MC_OPS_PER_TRIANGLE = 99  # 3 edges (6 each), 9 coordinates (6 each), 9 colour channels (3 each)
MC_BYTES_PER_BLOCK = 32 + 512 * 8  # its slot, 7 neighbour slots, the row's sdf and weight (512 x 2 f32)
MC_BYTES_PER_MESHED_BLOCK = 12  # its coords, read only where a triangle is written
MC_BYTES_PER_COLOUR_VOXEL = 12  # r, g, b f32 of a voxel at a corner of a block that holds a triangle
MC_BYTES_PER_TRIANGLE = 72  # 3 vertices and 3 colours of 3 f32
DENSE_FUSION_VOXEL = 0.02  # tools/dense_fusion.py's post-hoc reconstruction
DENSE_FUSION_STRIDE = 8
INTEGRATE_KEY_CAP = 4096  # touched_block_keys' first max_blocks in TSDFVolume.integrate and PipelinedDenseFusion
KEY_COUNT_ROOM = 1 << 16  # room to count a frame's touched blocks without that cap
# __popc results per clock on an SM of compute capability 9.0 (the CUDA C++
# Programming Guide's table of arithmetic instruction throughput: 16 for
# "population count"), times 132 SMs at the H100 SXM's 1.98 GHz boost clock
PEAK_POPC_PER_S = 16 * 132 * 1.98e9
MAX_SPARSE_ATE_M = 15e-3  # the orbit: the reference CPU build's 15.13 mm (BENCH_r05)
MAX_LOOP_ATE_M = 30e-3  # the 100-frame loop
SPARSE_TIMED_RUNS = 5
LOOP_FRAMES = 100
LOOP_CHUNK = 25
LOOP_TIMED_RUNS = 2
FBA_VOXEL = 0.02  # tools/fba_fusion.py's mesh step: voxel 0.02 m, truncation 5 voxels, every 8th frame
FBA_STRIDE = 8
MILD_G = 39  # keyframes in the loop's database when the MILD kernel is checked
MILD_DB_ROWS = 128  # the loop's database capacity after its doublings
ALL_VALID_SEED = 0  # the all-valid 1000 x 1000 hamming_match pair of random descriptors
BA_ITERS = 8  # FusedBASlam's LM iterations a chunk (its default)
BA_LAM0 = 3e-5  # FusedBASlam's first LM damping (its default)
# dampings the LM loop reaches after rejections (x2 each): the most
# FusedBASlam's 8 steps reach, and one within the host loop's 20
BA_DAMPINGS = (BA_LAM0 * 2**BA_ITERS, 1.0)
BA_DAMPING_MARGIN = 10  # the damping must move the plain system by 10x the kernel's tolerance
MAX_BA_WARM_RATIO = 1.5  # BA must not degrade the pose-graph warm start (tests/test_fused_ba.py:57): x1.5
BA_WARM_SLACK_M = 1e-4  # + 0.1 mm
# FusedBASlam's ATE on the corrupted 16-frame orbit as BENCH_r05 reports it for other chips
BENCH_NOISY_BA_ATE_M = {"JAX on its TPU (BENCH_r05)": 0.01785, "reference CPU build (BENCH_r05)": 0.02722}
# float32 operations of the BA Schur work, counted from csrc/ba_schur.cu (RGB-D model)
BA_OPS_PER_PAIR = 216  # one 6x6 block of 3-term dot products (3 mul, 3 add each)
BA_OPS_PER_OBS = 717  # residual and Jacobians 39, W/U/g/V/e and Y 561, U_f and rhs_c sums 78, W^T dc 39
BA_OPS_PER_POINT = 80  # damping 17, cofactor inverse 41, dp 21 and its sign
BA_OPS_PER_FRAME = 66  # U_f damping 30, added into S 36
BA_REDUCED_KERNELS = ("ba_points_kernel", "ba_blocks_kernel")  # launches A and B: reduced_system
BA_BACK_KERNELS = ("ba_back_substitute_kernel",)  # launch C: back_substitute
BA_WIDE_FRAMES = 2048  # keyframe slots of the loop's inputs padded past what a shared-memory strip of S takes


def bound(n_bytes: float, n_ops: float, peak_ops_per_s: float = PEAK_F32_PER_S) -> dict:
    """The least time for the work on the card, and what binds it: bytes over
    3.35 TB/s, and float32 operations over 67 TFLOP/s by default, or __popc
    counts over PEAK_POPC_PER_S: 16 results a clock per SM for compute
    capability 9.0 (the CUDA C++ Programming Guide's table of arithmetic
    instruction throughput) x 132 SMs x 1.98 GHz, 4.18e12 a second."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def device_times(fn, kernels: tuple[str, ...], calls: int = 20, attempts: int = 3) -> dict:
    """The profiler's (CUPTI's) record of `calls` fn() calls: `ms`, each of
    `kernels`' mean duration (the kernels whose names hold that string), or
    None where no session recorded every one of them; `per_call`, their
    launches per call; `other`, the launches per call of any other kernel;
    `seen`, the kernel names recorded. A mean per kernel stays right when
    the profiler drops some records. CUDA events around back-to-back calls
    also count the time the device waits for the host to enqueue the next
    launch.

    The profiler on the card now and then records no device activity in a
    session; the session is then repeated, up to `attempts` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = set()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = {k: [] for k in kernels}
        other = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                seen.add(e.name)
                hits = [k for k in kernels if k in e.name]
                for k in hits:
                    us[k].append(e.time_range.elapsed_us())
                other += not hits
        if all(us.values()):
            return dict(ms={k: float(np.mean(v)) / 1e3 for k, v in us.items()},
                        per_call={k: len(v) / calls for k, v in us.items()}, other=other / calls, seen=seen)
    return dict(ms=None, per_call=None, other=None, seen=seen)


def device_ms(fn, kernels: tuple[str, ...], calls: int = 20, attempts: int = 3) -> float:
    """Device time per fn() call in the kernels whose names hold one of
    `kernels` (each launched once per call): the sum of each kernel's mean
    duration as the profiler records it (`device_times`). If no session
    records every kernel, the time is that of CUDA events around each
    single call (the median over `calls`), which also counts the wrapper's
    other work, and a note on stderr says so."""
    rec = device_times(fn, kernels, calls, attempts)
    if rec["ms"] is not None:
        return sum(rec["ms"].values())
    start = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    for i in range(calls):
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    ms = float(np.median([a.elapsed_time(b) for a, b in zip(start, end)]))
    print(f"note: in {attempts} profiler sessions the device time of {kernels} was not all recorded "
          f"({len(rec['seen'])} device kernel names seen: {sorted(rec['seen'])[:8]}); timed {kernels} by CUDA "
          f"events around each single call instead: {ms:.4f} ms", file=sys.stderr, flush=True)
    return ms


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    """Replace obj.name by wrap(obj.name) while the block runs."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


class SyncCounter:
    """Counts synchronizing CUDA operations (sync debug mode "warn")."""

    def __enter__(self) -> "SyncCounter":
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        return self._catch.__exit__(*exc)

    @property
    def count(self) -> int:
        return sum("called a synchronizing CUDA operation" in str(w.message) for w in self._caught)

    def counting(self, fn, out: list):
        """fn, appending to `out` the syncs made inside each call."""

        def wrapped(*args, **kwargs):
            n = self.count
            res = fn(*args, **kwargs)
            out.append(self.count - n)
            return res

        return wrapped


def recording_icp_inputs(point_to_point, out: list):
    """point_to_point, appending each call's first nn1 inputs to `out`."""

    def wrapped(src, src_valid, tgt, tgt_valid, init_T, **kwargs):
        out.append((src @ init_T[:3, :3].T + init_T[:3, 3], tgt, tgt_valid))
        return point_to_point(src, src_valid, tgt, tgt_valid, init_T=init_T, **kwargs)

    return wrapped


def run_slam(cam, dev, grays, depths, wrap_finish=None):
    """One DenseSlam run over the frames: (slam, ms per frame, ms per
    _finish_submap). With `wrap_finish` (the sync-counted run) nothing is
    timed, so the run makes no synchronizing call of its own."""
    from onepiece_tpu_torch.systems.dense_slam import DenseSlam

    slam = DenseSlam(cam, dev)
    finish_ms = []
    if wrap_finish is not None:
        slam._finish_submap = wrap_finish(slam._finish_submap)
    else:
        finish = slam._finish_submap

        def timed_finish(sm_idx):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = finish(sm_idx)
            torch.cuda.synchronize()
            finish_ms.append((time.perf_counter() - t) * 1e3)
            return out

        slam._finish_submap = timed_finish
        torch.cuda.synchronize()
    t = time.perf_counter()
    for g, d in zip(grays, depths):
        slam.update_frame(g, d)
    if wrap_finish is None:
        torch.cuda.synchronize()
    return slam, (time.perf_counter() - t) * 1e3 / len(grays), finish_ms


def counted(expect: dict, what: str):
    """Run-time check of the launch counts of one main-path run (the counts
    were set to 0 just before it): returns them."""
    from onepiece_tpu_torch import _build

    launches = {k.name: k.launches for k in _build.KERNELS}
    if launches != expect:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {expect}")
    return launches


def scene_distance(scene, verts: np.ndarray, T_world: np.ndarray, dev) -> tuple[float, float]:
    """Median and 90th percentile of |scene_sdf| at the mesh's vertices, the
    volume's frame mapped to the scene's by T_world (4, 4)."""
    from onepiece_tpu_torch.utils import synthetic

    v = torch.from_numpy(verts.reshape(-1, 3)).to(dev) @ torch.from_numpy(T_world[:3, :3].T).to(dev) \
        + torch.from_numpy(T_world[:3, 3]).to(dev)
    d = synthetic.scene_sdf(scene, v)[0].abs().cpu().numpy()
    return float(np.median(d)), float(np.percentile(d, 90))


def mc_bytes(vox, slots, nbr, coords, voxel_size) -> tuple[int, int, int]:
    """The bytes the marching-cubes function must move on this volume, from
    the plain version's per-block triangle counts: (sdf-and-weight term,
    colour term, blocks that hold a triangle). Each active pool row is read
    once (a halo corner is another active row's voxel, counted there): sdf
    and weight of every row; colour only of the rows of blocks that hold a
    triangle and of the halo faces those blocks take from their other
    neighbours. The 72 B per triangle are added by the caller."""
    from onepiece_tpu_torch.ops import marching_cubes as mc

    fields = mc._pool_fields(vox)
    counts = []
    for s in range(0, slots.shape[0], mc.DEFAULT_CHUNK):
        own = [mc.gather_neighbors(f, slots[s : s + mc.DEFAULT_CHUNK, None], fill)[:, 0]
               for f, fill in zip(fields, mc.FILLS)]
        nb = [mc.gather_neighbors(f, nbr[s : s + mc.DEFAULT_CHUNK], fill) for f, fill in zip(fields, mc.FILLS)]
        valid = mc.extract_block_triangles_reference(*own, *nb, coords[s : s + mc.DEFAULT_CHUNK], voxel_size)[2]
        counts.append(valid.sum((1, 2)))
    meshed = torch.cat(counts) > 0
    need = torch.zeros((vox.shape[0], 8, 8, 8), dtype=torch.bool, device=vox.device)  # colour voxels read
    need[slots[meshed].long()] = True
    for k, off in enumerate(mc.NEIGHBOR_OFFSETS.tolist()):
        rows = nbr[meshed, k]
        need[(rows[rows >= 0].long(),) + tuple(0 if o else slice(None) for o in off)] = True
    n_meshed = int(meshed.sum())
    return (slots.shape[0] * MC_BYTES_PER_BLOCK, int(need.sum()) * MC_BYTES_PER_COLOUR_VOXEL
            + n_meshed * MC_BYTES_PER_MESHED_BLOCK, n_meshed)


def real_keys(depth_f, T_wc, cam, voxel_size: float, truncation: float) -> int:
    """Distinct blocks one frame touches: the keys `TSDFVolume.integrate`
    asks `touched_block_keys` for (stride 4), without its 4,096 cap."""
    from onepiece_tpu_torch.ops import tsdf as tsdf_ops

    keys = tsdf_ops.touched_block_keys(depth_f, torch.as_tensor(T_wc, dtype=torch.float32, device=depth_f.device),
                                       cam.fx, cam.fy, cam.cx, cam.cy, voxel_size, truncation,
                                       max_blocks=KEY_COUNT_ROOM)
    n = int((keys != tsdf_ops.INVALID_KEY).sum())
    if n >= KEY_COUNT_ROOM:
        raise AssertionError(f"a frame touches {n} blocks or more: raise KEY_COUNT_ROOM")
    return n


def mesh_phase(cam, dev, scene, card, poses, grays, depths, fused, dslam, s_grays, s_depths, slam_gt) -> dict:
    """Phase 8: the marching-cubes kernel against its plain version on the
    fused volumes, then the three reconstruction paths with counted launches."""
    import os
    import tempfile

    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.integration.blocks import TSDFVolume, neighbor_slots_device
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.io.ply import dedup_triangle_soup, read_ply, write_ply_mesh
    from onepiece_tpu_torch.odometry import dense
    from onepiece_tpu_torch.ops import marching_cubes as mc
    from onepiece_tpu_torch.ops.image import bilateral_filter
    from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup as dedup_on_device
    from onepiece_tpu_torch.systems.pipeline import PipelinedDenseFusion

    # -- the kernel against its plain version, gray and rgb volumes --
    res = {}
    for form, s in fused.items():
        vol = s.to_volume()
        na = vol.num_active
        coords = torch.from_numpy(vol.active_coords()).to(dev, torch.int32)
        nbr = neighbor_slots_device(coords)
        args = (vol.vox, torch.arange(na, dtype=torch.int32, device=dev), nbr, coords, vol.voxel_size)
        vk, ck = mc.extract_triangles(*args)
        vp, cp = mc.extract_triangles_reference(*args)
        torch.cuda.synchronize()
        if not (vk.shape == vp.shape and torch.equal(vk, vp) and torch.equal(ck, cp)):
            raise AssertionError(f"marching_cubes {form}: {vk.shape[0]} triangles, plain version {vp.shape[0]}, "
                                 f"not bit-equal in order")
        ms = device_ms(lambda: mc.extract_triangles(*args), ("mc_count_kernel", "mc_emit_kernel"))
        count_ms = device_ms(lambda: mc.extract_triangles(*args), ("mc_count_kernel",))
        event_ms = cuda_ms(lambda: mc.extract_triangles(*args))
        plain_ms = cuda_ms(lambda: mc.extract_triangles_reference(*args), reps=3, warmup=1)
        n_tri = vk.shape[0]
        sdf_bytes, colour_bytes, meshed = mc_bytes(*args)
        b = bound(sdf_bytes + colour_bytes + n_tri * MC_BYTES_PER_TRIANGLE,
                  MC_OPS_PER_VOXEL * 512 * na + MC_OPS_PER_TRIANGLE * n_tri)
        res[form] = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, count_ms=count_ms, **b)
        print(f"marching_cubes {form}: {na} blocks ({meshed} with triangles), {n_tri} triangles, bit-equal to "
              f"the plain version in order; kernel {ms:.4f} ms on the device (count pass {count_ms:.4f}; "
              f"{event_ms:.4f} ms by events, one host read between the passes), plain {plain_ms:.2f} ms, bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}: {sdf_bytes} B of slots, sdf and weight, {colour_bytes} B "
              f"of colour and coords, {n_tri * MC_BYTES_PER_TRIANGLE} B of triangles), roofline share "
              f"{b['bound_ms'] / ms:.3f}", flush=True)
        del vk, ck, vp, cp
    kernel = dict(max_abs_err=0.0, **res["gray"], rgb_ms=res["rgb"]["ms"], rgb_plain_ms=res["rgb"]["plain_ms"],
                  rgb_bound_ms=res["rgb"]["bound_ms"])

    zero = {k.name: 0 for k in _build.KERNELS}
    launches = []
    with tempfile.TemporaryDirectory() as tmp:

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t) * 1e3

        def mesh(name, vol, T_world, max_median, max_p90):
            """extract_mesh_tensors -> dedup on the card, held bit-equal to the
            numpy dedup -> one copy to the host -> PLY; vertices held against
            the scene."""
            (tv, tc), ex_ms = timed(vol.extract_mesh_tensors)
            (verts, faces, cols), dd_ms = timed(lambda: [x.cpu().numpy() for x in dedup_on_device(tv, tc)])
            path = os.path.join(tmp, f"{name}.ply")
            _, ply_ms = timed(lambda: write_ply_mesh(path, verts, faces, colors=cols))
            tv, tc = tv.cpu().numpy(), tc.cpu().numpy()
            ref, np_ms = timed(lambda: dedup_triangle_soup(tv, tc))
            if not all(np.array_equal(a, b) for a, b in zip((verts, faces, cols), ref)):
                raise AssertionError(f"{name} mesh: the dedup on the card differs from the numpy dedup")
            back = read_ply(path)
            med, p90 = scene_distance(scene, tv, T_world, dev)
            if not (len(faces) > 1000 and len(back["faces"]) == len(faces) and np.isfinite(verts).all()
                    and med < max_median and p90 < max_p90):
                raise AssertionError(f"{name} mesh: {len(faces)} faces ({len(back['faces'])} read back), "
                                     f"|scene sdf| median {med} (< {max_median}), p90 {p90} (< {max_p90})")
            print(f"{name} mesh: {len(tv)} triangles -> {len(verts)} vertices, {len(faces)} faces; extract_mesh "
                  f"{ex_ms:.2f} ms, dedup on the card {dd_ms:.2f} ms (bit-equal to the numpy dedup, "
                  f"{np_ms:.1f} ms), PLY {ply_ms:.2f} ms: {ex_ms + dd_ms + ply_ms:.1f} ms to a mesh; "
                  f"|scene sdf| at the vertices median {med * 1e3:.3f} mm, p90 {p90 * 1e3:.3f} mm", flush=True)

        # -- the fused volumes of phase 5 --
        _build.reset_launch_counts()
        for form, s in fused.items():
            mesh(f"fused {form}", s.to_volume(), poses[0], s.voxel_size / 2, s.voxel_size)
        launches.append(counted({**zero, "marching_cubes": len(fused)}, "fused meshes"))

        # -- DenseFusion's post-hoc reconstruction at DenseSlam's optimised poses --
        _build.reset_launch_counts()
        est = dslam.trajectory()
        vol = TSDFVolume(voxel_size=DENSE_FUSION_VOXEL, truncation=DENSE_FUSION_VOXEL * 5, device=dev)
        kept = range(0, len(est), DENSE_FUSION_STRIDE)
        for f in kept:
            vol.integrate(bilateral_filter(s_depths[f]), s_grays[f][..., None].expand(-1, -1, 3), est[f], cam)
        launches.append(counted({**zero, "tsdf_integrate": len(kept)}, "DenseFusion integration"))
        keys = [real_keys(bilateral_filter(s_depths[f]), est[f], cam, vol.voxel_size, vol.truncation) for f in kept]
        print(f"DenseFusion post-hoc: {len(kept)} frames integrated, {vol.num_active} blocks; distinct blocks a "
              f"frame touches: largest {max(keys)}, {sum(k >= INTEGRATE_KEY_CAP for k in keys)} frames at or over "
              f"the first {INTEGRATE_KEY_CAP} cap; key_saturated_frames {vol.key_saturated_frames} (key pass "
              f"redone, cap now {vol.max_blocks})", flush=True)
        _build.reset_launch_counts()
        mesh("DenseFusion", vol, slam_gt[0], DENSE_FUSION_VOXEL, 2 * DENSE_FUSION_VOXEL)
        launches.append(counted({**zero, "marching_cubes": 1}, "DenseFusion mesh"))
        del vol

        # -- PipelinedDenseFusion on the orbit --
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe = PipelinedDenseFusion(cam, dev)
        for g, d in zip(grays, depths):
            pipe.process_frame(g, d)
        est_p, _ = pipe.finalize()
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t) * 1e3 / len(grays)
        launches.append(counted({**zero, "tsdf_integrate": len(grays),
                                 "dense_normal_eq": sum(dense.DEFAULT_ITERS) * (len(grays) - 1)}, "pipeline"))
        ate = traj.ate_rmse(est_p, poses)
        if not (np.isfinite(est_p).all() and ate <= MAX_ATE_M):
            raise AssertionError(f"PipelinedDenseFusion ATE {ate} m > {MAX_ATE_M} m (or non-finite poses)")
        keys = [real_keys(bilateral_filter(d), T, cam, pipe.voxel_size, pipe.truncation)
                for d, T in zip(depths, est_p)]
        print(f"PipelinedDenseFusion {cam.width}x{cam.height} x {len(grays)} frames: ATE {ate * 1e3:.4f} mm, "
              f"{pipe.volume.num_active} blocks, {pipe_ms:.3f} ms/frame (one run, integration one frame late) on "
              f"{card}; distinct blocks a frame touches: largest {max(keys)}, "
              f"{sum(k >= INTEGRATE_KEY_CAP for k in keys)} frames at or over the first {INTEGRATE_KEY_CAP} cap; "
              f"key_saturated_frames {pipe.key_saturated_frames} (key pass redone, cap now {pipe.max_blocks})",
              flush=True)
        if max(keys) >= pipe.max_blocks:
            raise AssertionError(f"PipelinedDenseFusion: a frame touches {max(keys)} blocks, cap {pipe.max_blocks}")
        _build.reset_launch_counts()
        mesh("pipeline", pipe.volume, poses[0], pipe.voxel_size / 2, pipe.voxel_size)
        launches.append(counted({**zero, "marching_cubes": 1}, "pipeline mesh"))
    return dict(kernel=kernel, launches=launches)


def hamming_bytes_ops(a, b, vb, uv_pred=None, uv_b=None, window: float = 0.0) -> tuple[int, int]:
    """What `hamming_match` must move and compute on these inputs: each
    query's descriptor (32 B) and, windowed, its uv (8 B) read once; the
    validity of every target (1 B) and, of the valid targets only, the
    descriptor (32 B) and, windowed, the uv (8 B); 16 B a query written
    (int64 index, two int32 distances); 8 __popc for every (query, valid
    target in the window)."""
    n, m, n_valid = a.shape[0], b.shape[0], int(vb.sum())
    n_bytes = 32 * n + m + 32 * n_valid + 16 * n
    if uv_pred is None:
        pairs = n * n_valid
    else:
        n_bytes += 8 * (n + n_valid)
        inwin = ((uv_pred[:, None, 0] - uv_b[None, :, 0]).abs() <= window) & \
                ((uv_pred[:, None, 1] - uv_b[None, :, 1]).abs() <= window)
        pairs = int((inwin & vb[None]).sum())
    return n_bytes, 8 * pairs


def mild_bytes_ops(q_desc, q_valid, db_desc, db_valid, g) -> tuple[int, int]:
    """What `mild_feature_scores` must move and compute: the validity of
    every query (1 B) and of every feature of the live keyframes (1 B), the
    descriptors (32 B) of the valid ones only, g (8 B) and the table (256 B)
    read once; fs (4 B an entry) written; 8 __popc for every (valid query,
    valid feature of a keyframe k < g)."""
    n, (n_cap, f) = q_desc.shape[0], db_desc.shape[:2]
    live = min(n_cap, int(g))
    n_q, n_f = int(q_valid.sum()), int(db_valid[:live].sum())
    n_bytes = n + 32 * n_q + live * f + 32 * n_f + 4 * n * n_cap + 8 + 256
    return n_bytes, 8 * n_q * n_f


def hamming_forms(cam, dev, poses, grays, depths) -> dict:
    """The `hamming_match` inputs phase 9 holds and times: the 1000
    descriptors of orbit frames 0 and 1 (the path's shape, most invalid),
    unwindowed and windowed (20 px around the ground-truth prediction), and
    an all-valid 1000 x 1000 pair of random descriptors drawn from
    ALL_VALID_SEED, what a real camera frame with 1,000 keypoints gives."""
    from onepiece_tpu_torch.odometry import sparse

    fr = sparse.extract_sparse_frames_batch(grays[:2], depths[:2], cam, max_keypoints=1000, threshold=0.01)
    src, tgt = (sparse.map_frame(lambda t: t[i].contiguous(), fr) for i in (0, 1))
    T_ts = torch.from_numpy(np.linalg.inv(poses[1]) @ poses[0]).to(dev, torch.float32)
    uv_pred = cam.project(src.points @ T_ts[:3, :3].T + T_ts[:3, 3])[0].contiguous()
    rng = np.random.default_rng(ALL_VALID_SEED)
    rand = [torch.from_numpy(rng.integers(0, 2**32, (1000, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))
            .to(dev) for _ in range(2)]
    return {"1000x1000": (src.kp.desc, tgt.kp.desc, tgt.valid),
            "windowed 20 px": (src.kp.desc, tgt.kp.desc, tgt.valid, uv_pred, tgt.kp.uv, 20.0),
            "all-valid 1000x1000": (*rand, torch.ones(1000, dtype=torch.bool, device=dev))}


def mild_args(cam, loop, l_grays, l_depths) -> tuple:
    """`mild_feature_scores` at the loop's shape: the last loop frame's 1000
    descriptors against the loop's 128 x 1000 keyframe database, g = 39."""
    from onepiece_tpu_torch.odometry import sparse

    st = loop._state
    q = sparse.extract_sparse_frames_batch(l_grays[-1:], l_depths[-1:], cam, max_keypoints=1000, threshold=0.01)
    g = torch.full((), MILD_G, dtype=torch.int64, device=l_grays.device)
    return q.kp.desc[0].contiguous(), q.valid[0].contiguous(), st.kf.kp.desc, st.kf.valid, g


def timed_beside_floor(fn, name: str) -> dict:
    """Device ms of kernel `name` per fn() call, the kernels fn launches per
    call, and the launch floor: the device ms of a one-element `fill_`, the
    smallest kernel the card runs, in the same profiler session. `other` is
    the launches per call of any kernel but those two: a wrapper that
    launches one kernel a call has 0. Without a full profiler record: ms by
    CUDA events (`device_ms`), the rest None."""
    one = torch.zeros(1, device="cuda")
    rec = device_times(lambda: (fn(), one.fill_(1.0)), (name, "FillFunctor"))
    if rec["ms"] is None:
        return dict(ms=device_ms(fn, (name,)), kernels_per_call=None, other=None, floor_ms=None)
    return dict(ms=rec["ms"][name], kernels_per_call=rec["per_call"][name] + rec["other"], other=rec["other"],
                floor_ms=rec["ms"]["FillFunctor"])


def require_one_kernel(t: dict, what: str) -> None:
    """Fails unless the profiler saw no kernel but `what`'s own (and the
    floor's fill_) in its session; says so on stderr where it recorded none.
    The per-call count of the kernel itself is not used: the profiler drops
    some records, so it reads under 1."""
    if t["other"] is None:
        print(f"note: {what}: the profiler recorded no session, kernels a call not checked", file=sys.stderr,
              flush=True)
    elif t["other"] != 0:
        raise AssertionError(f"{what}: {t['other']} other kernels a call (one kernel a call required)")


def sparse_phase(cam, dev, scene, card, poses, grays, depths) -> dict:
    """Phase 9: the Hamming kernel against its plain version at the sparse
    path's shapes; FusedFBASlam on the orbit and on the 100-frame loop with
    counted launches and host syncs; the FBAFusion mesh of the loop."""
    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.integration.blocks import TSDFVolume
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.io.ply import dedup_triangle_soup
    from onepiece_tpu_torch.lcdetection import mild
    from onepiece_tpu_torch.ops import hamming
    from onepiece_tpu_torch.ops.image import bilateral_filter
    from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup as dedup_on_device
    from onepiece_tpu_torch.systems.fused_sparse import FusedFBASlam
    from onepiece_tpu_torch.utils import synthetic

    zero = {k.name: 0 for k in _build.KERNELS}
    res = {}

    # -- (a) hamming_match at 1000 x 1000: a real 640x480 frame pair, and all-valid --
    forms = hamming_forms(cam, dev, poses, grays, depths)
    for form, args in forms.items():
        k = hamming.hamming_match(*args)
        p = hamming.hamming_match_reference(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(k, p)):
            raise AssertionError(f"hamming_match {form}: kernel and plain version differ "
                                 f"({int((k[0] != p[0]).sum())} indices, {int((k[1] != p[1]).sum())} best, "
                                 f"{int((k[2] != p[2]).sum())} second distances)")
        t = timed_beside_floor(lambda: hamming.hamming_match(*args), "hamming_match_kernel")
        require_one_kernel(t, f"hamming_match {form}")
        event_ms = cuda_ms(lambda: hamming.hamming_match(*args))
        plain_ms = cuda_ms(lambda: hamming.hamming_match_reference(*args), reps=5)
        n_bytes, n_popc = hamming_bytes_ops(*args)
        b = bound(n_bytes, n_popc, PEAK_POPC_PER_S)
        res[form] = dict(ms=t["ms"], event_ms=event_ms, plain_ms=plain_ms, **b)
        res[form].update(kernels_per_call=t["kernels_per_call"], other_kernels=t["other"],
                         floor_ms=t["floor_ms"])
        print(f"hamming_match {form}: {args[0].shape[0]} queries, {args[1].shape[0]} targets "
              f"({int(args[2].sum())} valid): indices, best and second distances equal to the plain version "
              f"({int((k[1] <= 64).sum())} best <= 64); kernel {t['ms']:.4f} ms on the device ({event_ms:.4f} ms by "
              f"events; {t['other']} other kernels a call; launch floor, a one-element fill_ in the same "
              f"profiler session, {t['floor_ms']} ms), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}: {n_popc} popc, {n_bytes} B), roofline share {b['bound_ms'] / t['ms']:.3f}",
              flush=True)
    a, b_, _ = forms["1000x1000"]
    if not torch.equal(hamming.hamming_table(a, b_), hamming.hamming_table_reference(a, b_)):
        raise AssertionError("hamming_table: kernel and plain version differ at 1000 x 1000")
    print("hamming_table 1000 x 1000 (orbit frames 0 and 1, every target): equal to the plain version", flush=True)

    # -- (b) FusedFBASlam on the 16-frame orbit, one chunk --
    def run_orbit():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = FusedFBASlam(cam, device=dev)
        s.process_chunk(grays, depths)
        torch.cuda.synchronize()
        return s, (time.perf_counter() - t) * 1e3 / len(grays)

    run_orbit()  # warm
    launches = []
    _build.reset_launch_counts()
    with SyncCounter() as sc:
        slam, _ = run_orbit()
    launches.append(counted({**zero, "hamming": _build.HAMMING.launches}, "sparse orbit"))
    syncs = orbit_syncs = sc.count
    ate = orbit_ate = traj.ate_rmse(slam.trajectory(), poses)
    orbit_reads = slam.host_reads
    if not (launches[-1]["hamming"] >= 2 * (len(grays) - 1) and np.isfinite(slam.trajectory()).all()
            and ate <= MAX_SPARSE_ATE_M and slam.edge_overflow == 0):
        raise AssertionError(f"FusedFBASlam orbit: ATE {ate} m (<= {MAX_SPARSE_ATE_M}), overflow "
                             f"{slam.edge_overflow}, launches {launches[-1]}")
    times = [run_orbit()[1] for _ in range(SPARSE_TIMED_RUNS)]
    print(f"FusedFBASlam 640x480 x {len(grays)} frames of the orbit, one chunk: ATE {ate * 1e3:.4f} mm, "
          f"{slam.num_kf} keyframes, {slam.num_edges} edges ({slam.lc_edges_total} LC), overflow "
          f"{slam.edge_overflow}, hamming launches {launches[-1]['hamming']}; host syncs {syncs} "
          f"({syncs / len(grays):.2f} per frame; {slam.host_reads} of them the slice's own reads); ms/frame "
          f"over {SPARSE_TIMED_RUNS} runs after a warm run: median {np.median(times):.3f} "
          f"(runs {[round(t, 3) for t in times]}) on {card}", flush=True)

    # -- (c) the 100-frame loop in chunks of 25 --
    loop_gt = synthetic.loop_trajectory(LOOP_FRAMES)
    rendered = [synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy,
                                 cam.height, cam.width, num_steps=RENDER_STEPS) for p in loop_gt]
    l_depths = torch.stack([d for d, _ in rendered])
    l_grays = torch.stack([g for _, g in rendered])
    del rendered

    def run_loop():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = FusedFBASlam(cam, device=dev)
        for i in range(0, LOOP_FRAMES, LOOP_CHUNK):
            s.process_chunk(l_grays[i : i + LOOP_CHUNK], l_depths[i : i + LOOP_CHUNK])
        torch.cuda.synchronize()
        return s, (time.perf_counter() - t) * 1e3 / LOOP_FRAMES

    run_loop()  # warm
    _build.reset_launch_counts()
    with SyncCounter() as sc:
        loop, _ = run_loop()
    launches.append(counted({**zero, "hamming": _build.HAMMING.launches}, "sparse loop"))
    syncs = sc.count
    est = loop.trajectory()
    ate = traj.ate_rmse(est, loop_gt)
    if not (np.isfinite(est).all() and ate <= MAX_LOOP_ATE_M and loop.lc_edges_total >= 1
            and loop.capacity_doublings >= 1 and loop.edge_overflow == 0):
        raise AssertionError(f"FusedFBASlam loop: ATE {ate} m (<= {MAX_LOOP_ATE_M}), LC edges "
                             f"{loop.lc_edges_total}, doublings {loop.capacity_doublings}, overflow {loop.edge_overflow}")
    times = [run_loop()[1] for _ in range(LOOP_TIMED_RUNS)]
    print(f"FusedFBASlam 640x480 x {LOOP_FRAMES} frames of loop_trajectory in chunks of {LOOP_CHUNK}: ATE "
          f"{ate * 1e3:.4f} mm, {loop.num_kf} keyframes, {loop.num_edges} edges ({loop.lc_edges_total} LC), "
          f"capacities {loop.kf_capacity} keyframes / {loop.edge_capacity} edges ({loop.capacity_doublings} "
          f"doublings), overflow {loop.edge_overflow}, hamming launches {launches[-1]['hamming']}; host syncs "
          f"{syncs} ({syncs / LOOP_FRAMES:.2f} per frame; {loop.host_reads} of them the slice's own reads); "
          f"ms/frame over {LOOP_TIMED_RUNS} runs after a warm run: median {np.median(times):.3f} "
          f"(runs {[round(t, 3) for t in times]}) on {card}", flush=True)

    # -- (a) mild_feature_scores: 1000 queries x the loop's 128 x 1000 database, g = 39 --
    margs = mild_args(cam, loop, l_grays, l_depths)
    q_desc, q_valid, db_desc, db_valid, g = margs
    fk = mild.mild_feature_scores(*margs)
    fk2 = mild.mild_feature_scores(*margs)
    fp = mild.mild_feature_scores_reference(*margs)
    rest = (g, g - 1, torch.full((), -1, dtype=torch.int64, device=dev))
    ck, okk = mild.lc_candidates_device(q_desc, q_valid, db_desc, db_valid, *rest)
    cp, okp = mild.candidates_from_scores(fp, q_valid, *rest)
    torch.cuda.synchronize()
    err = float((fk - fp).abs().max())
    rel = err / max(float(fp.abs().max()), 1e-30)
    if not (db_desc.shape[0] == MILD_DB_ROWS and float(fp.max()) > 0 and rel <= 1e-5
            and torch.equal(ck, cp) and torch.equal(okk, okp) and torch.equal(fk, fk2)):
        raise AssertionError(f"mild_feature_scores: DB {tuple(db_desc.shape)}, rel err {rel} (<= 1e-5), "
                             f"candidates {ck.tolist()} {okk.tolist()} vs plain {cp.tolist()} {okp.tolist()}, "
                             f"two calls bit-equal {torch.equal(fk, fk2)}")
    t = timed_beside_floor(lambda: mild.mild_feature_scores(*margs), "mild_feature_scores_kernel")
    require_one_kernel(t, "mild_feature_scores")
    ms = t["ms"]
    event_ms = cuda_ms(lambda: mild.mild_feature_scores(*margs))
    plain_ms = cuda_ms(lambda: mild.mild_feature_scores_reference(*margs), reps=3, warmup=1)
    n_bytes, n_popc = mild_bytes_ops(*margs)
    b = bound(n_bytes, n_popc, PEAK_POPC_PER_S)
    print(f"mild_feature_scores: {q_desc.shape[0]} queries ({int(q_valid.sum())} valid) x DB {tuple(db_desc.shape)}, "
          f"g = {MILD_G} ({int(db_valid[:MILD_G].sum())} valid features): max abs err {err:.3g} (rel {rel:.3g}), "
          f"two calls bit-equal, candidates {ck.tolist()} ({int(okk.sum())} salient) equal; kernel {ms:.4f} ms on "
          f"the device ({event_ms:.4f} ms by events; {t['other']} other kernels a call; launch floor "
          f"{t['floor_ms']} ms), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']}: "
          f"{n_popc} popc, {n_bytes} B), roofline share {b['bound_ms'] / ms:.3f}", flush=True)
    m1, win, full = res["1000x1000"], res["windowed 20 px"], res["all-valid 1000x1000"]
    kernel = dict(max_abs_err=err, **m1, windowed_ms=win["ms"], windowed_plain_ms=win["plain_ms"],
                  windowed_bound_ms=win["bound_ms"], windowed_share=win["bound_ms"] / win["ms"],
                  all_valid_ms=full["ms"], all_valid_plain_ms=full["plain_ms"], all_valid_bound_ms=full["bound_ms"],
                  all_valid_share=full["bound_ms"] / full["ms"], mild_ms=ms, mild_event_ms=event_ms,
                  mild_plain_ms=plain_ms, mild_bound_ms=b["bound_ms"], mild_share=b["bound_ms"] / ms,
                  mild_kernels_per_call=t["kernels_per_call"], mild_other_kernels=t["other"],
                  launch_floor_ms=t["floor_ms"], table_equal=True)

    # -- (d) the FBAFusion mesh of the loop: every 8th frame at the optimised poses --
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    vol = TSDFVolume(voxel_size=FBA_VOXEL, truncation=5 * FBA_VOXEL, device=dev)
    kept = range(0, LOOP_FRAMES, FBA_STRIDE)
    for fi in kept:
        vol.integrate(bilateral_filter(l_depths[fi]), l_grays[fi][..., None].expand(-1, -1, 3), est[fi], cam)
    tv, tc = vol.extract_mesh_tensors()
    verts, faces, cols = (x.cpu().numpy() for x in dedup_on_device(tv, tc))
    mesh_ms = (time.perf_counter() - t) * 1e3
    mesh_launches = counted({**zero, "tsdf_integrate": len(kept), "marching_cubes": 1}, "FBAFusion mesh")
    tv, tc = tv.cpu().numpy(), tc.cpu().numpy()
    if not all(np.array_equal(x, y) for x, y in zip((verts, faces, cols), dedup_triangle_soup(tv, tc))):
        raise AssertionError("FBAFusion mesh: the dedup on the card differs from the numpy dedup")
    # the volume's frame is the first camera's (the trajectory starts at the
    # identity), so the first ground-truth pose maps it to the scene's, as in phase 8
    med, p90 = scene_distance(scene, tv, loop_gt[0], dev)
    if not (len(faces) > 1000 and np.isfinite(verts).all() and med < FBA_VOXEL / 2):
        raise AssertionError(f"FBAFusion mesh: {len(faces)} faces, |scene sdf| median {med} (< {FBA_VOXEL / 2})")
    print(f"FBAFusion mesh of the loop: {len(kept)} frames at the optimised poses, {vol.num_active} blocks "
          f"(key_saturated_frames {vol.key_saturated_frames}), {len(tv)} triangles -> {len(verts)} vertices, "
          f"{len(faces)} faces (the dedup on the card bit-equal to numpy's) in {mesh_ms:.1f} ms; launches "
          f"{mesh_launches}; |scene sdf| at the vertices median {med * 1e3:.3f} mm, p90 {p90 * 1e3:.3f} mm",
          flush=True)
    return dict(kernel=kernel, launches=launches, loop=(loop_gt, l_grays, l_depths),
                orbit=dict(ate=orbit_ate, syncs=orbit_syncs, host_reads=orbit_reads))


def ba_bytes_ops(args, lists, live: bool = False) -> tuple[int, int, int]:
    """What one LM step's Schur work (`reduced_system` and `back_substitute`)
    must move and compute on these inputs: (bytes, float32 operations,
    observation pairs). Over the capacities (the kernels write S, V^-1, b_p
    and dp at their full size) or, with `live`, over the frames and points
    that hold an observation. Read once: each valid observation's frame and point
    indices (16 B), its measurement (12 B camera point or 8 B pixel) and its
    two list entries (16 B); each pose (64 B), list offset (8 B) and camera
    step (24 B) of a frame; each point (12 B) and its offset (8 B).
    Written once: S (36 F^2 floats), rhs_c (24 B a frame), V^-1, b_p and dp
    (60 B a point). Operations, counted from the kernels' code: 216 per
    pair of observations of one point (a 6x6 block of 3-term dot products),
    BA_OPS_PER_OBS per observation, BA_OPS_PER_POINT per point,
    BA_OPS_PER_FRAME per frame."""
    poses, points, frame, point, uv, valid, lam, intr, pc = args
    n_f, n_p = poses.shape[0], points.shape[0]
    if live:
        n_f, n_p = int((lists.frame_ptr.diff() > 0).sum()), int((lists.point_ptr.diff() > 0).sum())
    n_obs = int(lists.frame_ptr[-1])
    n_pairs = int((lists.point_ptr.diff() ** 2).sum())
    meas = 12 if pc is not None else 8
    n_bytes = (n_obs * (16 + meas + 16) + n_f * (64 + 8 + 24) + n_p * (12 + 8) + 4
               + 36 * n_f * n_f * 4 + 24 * n_f + 60 * n_p)
    n_ops = BA_OPS_PER_PAIR * n_pairs + BA_OPS_PER_OBS * n_obs + BA_OPS_PER_POINT * n_p + BA_OPS_PER_FRAME * n_f
    return n_bytes, n_ops, n_pairs


def ba_phase(cam, dev, card, poses, grays, depths, sparse: dict) -> dict:
    """Phase 10: the BA Schur kernel against its plain version on the inputs
    of FusedBASlam's own BA calls, timed; FusedBASlam on the orbit and on
    the 100-frame loop with counted launches and host syncs; the corrupted
    orbit."""
    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.ops import ba_schur
    from onepiece_tpu_torch.systems import fused_ba
    from onepiece_tpu_torch.utils import synthetic

    zero = {k.name: 0 for k in _build.KERNELS}
    loop_gt, l_grays, l_depths = sparse["loop"]

    def run(g, d, chunk):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = fused_ba.FusedBASlam(cam, device=dev)
        for i in range(0, len(g), chunk):
            s.process_chunk(g[i : i + chunk], d[i : i + chunk])
        torch.cuda.synchronize()
        return s, (time.perf_counter() - t) * 1e3 / len(g)

    # -- (a) warm runs, recording the inputs of every BA step's reduced_system --
    calls = []

    def recording(fn):
        def wrapped(*args, **kwargs):  # copies: the linker writes the track buffers in place
            calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args[:9]))
            return fn(*args, **kwargs)
        return wrapped

    with patched(ba_schur, "reduced_system", recording):
        run(grays, depths, len(grays))
        orbit_call = calls[0]
        lam_reached = {"orbit": max(float(a[6]) for a in calls)}
        calls.clear()
        run(l_grays, l_depths, LOOP_CHUNK)
        loop_call = calls[-BA_ITERS]  # the last chunk's first step
        lam_reached["loop"] = lam_reached["wide loop"] = max(float(a[6]) for a in calls)
        del calls[:]

    # the loop's inputs again at F = BA_WIDE_FRAMES keyframe slots (identity
    # poses past the loop's 128): above the 1,613 frames a shared-memory strip
    # of S would cap
    n_wide = BA_WIDE_FRAMES - loop_call[0].shape[0]
    wide_call = (torch.cat([loop_call[0], torch.eye(4, device=dev).expand(n_wide, 4, 4)]), *loop_call[1:])

    # -- (b) the kernel against its plain version on those inputs, timed --
    res = {}
    for shape, args in (("orbit", orbit_call), ("loop", loop_call), ("wide loop", wide_call)):
        # poses, points, frame, point, uv, valid, lam, intrinsics, pc_obs
        frame, point = args[2], args[3]
        lists = ba_schur.build_lists(frame, point, args[5], args[0].shape[0], args[1].shape[0])
        kw = dict(lists=lists)
        k = ba_schur.reduced_system(*args, **kw)
        k2 = ba_schur.reduced_system(*args, **kw)
        p = ba_schur.reduced_system_reference(*args)
        dc = torch.from_numpy(np.random.default_rng(0).normal(size=k.rhs_c.shape[0]).astype(np.float32)
                              * 1e-3).to(dev)
        dk = ba_schur.back_substitute(k, dc, frame, point, lists)
        dk2 = ba_schur.back_substitute(k2, dc, frame, point, lists)
        dp = ba_schur.back_substitute_reference(p, dc, frame, point)
        torch.cuda.synchronize()
        observed = lists.point_ptr.diff() > 0
        if not bool(observed.any()):
            raise AssertionError(f"ba_schur at the {shape} call: no valid observation recorded")
        pairs = dict(S=(k.S, p.S), rhs_c=(k.rhs_c, p.rhs_c), b_p=(k.b_p, p.b_p),
                     Vinv=(k.Vinv[observed], p.Vinv[observed]), dp=(dk, dp))
        errs = {n: rel_err(a, b) for n, (a, b) in pairs.items()}
        abs_err = max(float((a - b).abs().max()) for a, b in pairs.values())
        same = all(torch.equal(x, y) for x, y in zip((*k[:4], dk), (*k2[:4], dk2)))
        if not (max(errs.values()) <= KERNEL2_TOL and torch.equal(k.Vinv[~observed], p.Vinv[~observed]) and same
                and bool(observed.any())):
            raise AssertionError(f"ba_schur at the {shape} call: rel errs {errs} (<= {KERNEL2_TOL}), padding "
                                 f"V^-1 equal {torch.equal(k.Vinv[~observed], p.Vinv[~observed])}, two calls "
                                 f"bit-equal {same}")
        # the damping: at dampings LM reaches after rejections the kernel stays
        # within the tolerance, and the damping moves the plain system by far
        # more than it, so a kernel that dropped or misplaced lam would fail
        def at(lam):
            return (*args[:6], torch.tensor(lam, dtype=torch.float32, device=dev), *args[7:])

        p0 = ba_schur.reduced_system_reference(*at(0.0))
        dp0 = ba_schur.back_substitute_reference(p0, dc, frame, point)
        damping = {}
        for lam in BA_DAMPINGS:
            kl = ba_schur.reduced_system(*at(lam), **kw)
            pl = ba_schur.reduced_system_reference(*at(lam))
            dkl = ba_schur.back_substitute(kl, dc, frame, point, lists)
            dpl = ba_schur.back_substitute_reference(pl, dc, frame, point)
            err = {n: rel_err(a, b) for n, (a, b) in dict(
                S=(kl.S, pl.S), rhs_c=(kl.rhs_c, pl.rhs_c), Vinv=(kl.Vinv[observed], pl.Vinv[observed]),
                dp=(dkl, dpl)).items()}
            moved = {n: rel_err(a, b) for n, (a, b) in dict(
                S=(pl.S, p0.S), rhs_c=(pl.rhs_c, p0.rhs_c), Vinv=(pl.Vinv[observed], p0.Vinv[observed]),
                dp=(dpl, dp0)).items()}
            damping[lam] = (err, moved)
            if not (max(err.values()) <= KERNEL2_TOL
                    and min(moved[n] for n in ("S", "Vinv", "dp")) >= BA_DAMPING_MARGIN * KERNEL2_TOL):
                raise AssertionError(f"ba_schur at the {shape} call, lam {lam}: rel errs {err} (<= {KERNEL2_TOL}); "
                                     f"the damping moves the plain system by {moved} (S, Vinv, dp >= "
                                     f"{BA_DAMPING_MARGIN * KERNEL2_TOL})")
        print(f"ba_schur at the {shape}'s BA call, damped as LM damps after rejections (its steps reached lam "
              f"{lam_reached[shape]:.4g}): " + "; ".join(
                  f"lam {lam:.4g}: rel errs {', '.join(f'{n} {e:.3g}' for n, e in err.items())}, the damping "
                  f"moves the plain system by {', '.join(f'{n} {e:.3g}' for n, e in moved.items())}"
                  for lam, (err, moved) in damping.items()), flush=True)
        t_red = device_times(lambda: ba_schur.reduced_system(*args, **kw), BA_REDUCED_KERNELS)
        t_back = device_times(lambda: ba_schur.back_substitute(k, dc, frame, point, lists), BA_BACK_KERNELS)
        for what, t in (("reduced_system", t_red), ("back_substitute", t_back)):
            if t["other"] is None:
                print(f"note: ba_schur {what} at the {shape} call: the profiler recorded no full session, kernels "
                      f"a call not checked", file=sys.stderr, flush=True)
            elif t["other"] != 0:
                raise AssertionError(f"ba_schur {what}: {t['other']} other kernels a call (its own kernels only)")
        ms = (sum(t_red["ms"].values()) if t_red["ms"] else device_ms(
            lambda: ba_schur.reduced_system(*args, **kw), BA_REDUCED_KERNELS)) + \
            (sum(t_back["ms"].values()) if t_back["ms"] else device_ms(
                lambda: ba_schur.back_substitute(k, dc, frame, point, lists), BA_BACK_KERNELS))
        event_ms = cuda_ms(lambda: ba_schur.back_substitute(ba_schur.reduced_system(*args, **kw), dc, frame,
                                                               point, lists))
        plain_ms = cuda_ms(lambda: ba_schur.back_substitute_reference(
            ba_schur.reduced_system_reference(*args), dc, frame, point), reps=5)
        n_bytes, n_ops, n_pairs = ba_bytes_ops(args, lists)
        b = bound(n_bytes, n_ops)
        live = bound(*ba_bytes_ops(args, lists, live=True)[:2])
        per_kernel = {**(t_red["ms"] or {}), **(t_back["ms"] or {})}
        res[shape] = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, max_abs_err=abs_err,
                          max_rel_err=max(errs.values()), live_bound_ms=live["bound_ms"],
                          kernel_ms={n: per_kernel.get(n) for n in (*BA_REDUCED_KERNELS, *BA_BACK_KERNELS)}, **b)
        print(f"ba_schur at the {shape}'s BA call: F {args[0].shape[0]}, P {args[1].shape[0]}, O "
              f"{args[2].shape[0]} ({int(lists.frame_ptr[-1])} valid, {n_pairs} pairs, {int(observed.sum())} "
              f"points observed): rel errs {', '.join(f'{n} {e:.3g}' for n, e in errs.items())} (<= "
              f"{KERNEL2_TOL}), padding V^-1 equal, two calls bit-equal; device ms a step {ms:.4f} ("
              f"{', '.join(f'{n} {v if v is None else round(v, 4)}' for n, v in res[shape]['kernel_ms'].items())}; "
              f"0 other kernels), "
              f"{event_ms:.4f} by events, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms "
              f"({b['bound_by']}: {n_ops} operations, {n_bytes} B), roofline share {b['bound_ms'] / ms:.4f}; over "
              f"the live frames and points only: bound {live['bound_ms']:.5f} ms ({live['bound_by']}), share "
              f"{live['bound_ms'] / ms:.4f}", flush=True)
    del orbit_call, loop_call, wide_call

    # -- (c) FusedBASlam on the orbit, one chunk: launches, syncs, ATE, repeatability --
    launches = []
    _build.reset_launch_counts()
    with SyncCounter() as sc:
        slam, _ = run(grays, depths, len(grays))
    launches.append(counted({**zero, "hamming": _build.HAMMING.launches, "ba_schur": 2 * BA_ITERS}, "BA orbit"))
    syncs = sc.count
    est = slam.trajectory()
    ate = traj.ate_rmse(est, poses)
    fba = sparse["orbit"]
    limit = min(MAX_SPARSE_ATE_M, MAX_BA_WARM_RATIO * fba["ate"] + BA_WARM_SLACK_M)
    if not (launches[-1]["hamming"] > 0 and np.isfinite(est).all() and ate <= limit
            and np.isfinite(slam.ba_mse) and slam.pt_overflow == 0 and slam.obs_overflow == 0
            and slam.edge_overflow == 0 and syncs == fba["syncs"] and slam.host_reads == fba["host_reads"]):
        raise AssertionError(f"FusedBASlam orbit: ATE {ate} m (<= {limit}: FusedFBASlam's {fba['ate']}), BA mse "
                             f"{slam.ba_mse}, overflow points {slam.pt_overflow} observations {slam.obs_overflow} "
                             f"edges {slam.edge_overflow}, host syncs {syncs} (FusedFBASlam {fba['syncs']}), reads "
                             f"{slam.host_reads} ({fba['host_reads']}), launches {launches[-1]}")
    timed = [run(grays, depths, len(grays)) for _ in range(SPARSE_TIMED_RUNS)]
    if not np.array_equal(timed[0][0].trajectory(), est):
        raise AssertionError("FusedBASlam orbit: two runs gave different trajectories")
    times = [t for _, t in timed]
    del timed
    stage = {}
    stage_calls = {}

    def timing(name):
        def wrap(fn):
            def wrapped(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                stage[name] = stage.get(name, 0.0) + (time.perf_counter() - t) * 1e3
                stage_calls[name] = stage_calls.get(name, 0) + 1
                return out
            return wrapped
        return wrap

    def staged(g, d, chunk):
        stage.clear()
        stage_calls.clear()
        with patched(fused_ba, "link_edges", timing("linker")), \
                patched(fused_ba.bundle, "optimize_device", timing("LM loop")):
            run(g, d, chunk)
        return {k: v / stage_calls[k] for k, v in stage.items()}

    orbit_stage = staged(grays, depths, len(grays))
    print(f"FusedBASlam 640x480 x {len(grays)} frames of the orbit, one chunk: ATE {ate * 1e3:.4f} mm "
          f"(FusedFBASlam {fba['ate'] * 1e3:.4f} mm; bound {limit * 1e3:.4f} mm), {slam.num_kf} keyframes, "
          f"{slam.n_pts} world points, {slam.n_obs} observations, BA mse {slam.ba_mse:.4g}, overflow points "
          f"{slam.pt_overflow} observations {slam.obs_overflow} edges {slam.edge_overflow}; launches "
          f"{launches[-1]}; host syncs {syncs} (FusedFBASlam {fba['syncs']}; {slam.host_reads} of them the "
          f"slice's own reads), two runs bit-equal; ms/frame over {SPARSE_TIMED_RUNS} runs after a warm run: "
          f"median {np.median(times):.3f} (runs {[round(t, 3) for t in times]}); ms a chunk: linker "
          f"{orbit_stage['linker']:.3f}, LM loop {orbit_stage['LM loop']:.3f} on {card}", flush=True)
    orbit_ms = float(np.median(times))

    # -- (d) the 100-frame loop in chunks of 25 --
    n_chunks = -(-LOOP_FRAMES // LOOP_CHUNK)
    _build.reset_launch_counts()
    with SyncCounter() as sc:
        loop, _ = run(l_grays, l_depths, LOOP_CHUNK)
    launches.append(counted({**zero, "hamming": _build.HAMMING.launches, "ba_schur": 2 * BA_ITERS * n_chunks},
                            "BA loop"))
    syncs = sc.count
    est = loop.trajectory()
    ate = traj.ate_rmse(est, loop_gt)
    if not (np.isfinite(est).all() and ate <= MAX_LOOP_ATE_M and loop.lc_edges_total >= 1 and loop.n_pts > 0
            and launches[-1]["hamming"] > 0):
        raise AssertionError(f"FusedBASlam loop: ATE {ate} m (<= {MAX_LOOP_ATE_M}), LC edges "
                             f"{loop.lc_edges_total}, world points {loop.n_pts}")
    times = [run(l_grays, l_depths, LOOP_CHUNK)[1] for _ in range(LOOP_TIMED_RUNS)]
    loop_stage = staged(l_grays, l_depths, LOOP_CHUNK)
    print(f"FusedBASlam 640x480 x {LOOP_FRAMES} frames of loop_trajectory in chunks of {LOOP_CHUNK}: ATE "
          f"{ate * 1e3:.4f} mm, {loop.num_kf} keyframes, {loop.num_edges} edges ({loop.lc_edges_total} LC), "
          f"{loop.n_pts} world points, {loop.n_obs} observations (capacities {loop.pt_capacity} / "
          f"{loop.obs_capacity}, keyframes {loop.kf_capacity}), BA mse {loop.ba_mse:.4g}, overflow points "
          f"{loop.pt_overflow} observations {loop.obs_overflow} edges {loop.edge_overflow}; launches "
          f"{launches[-1]}; host syncs {syncs} ({syncs / LOOP_FRAMES:.2f} per frame; {loop.host_reads} the "
          f"slice's own reads); ms/frame over {LOOP_TIMED_RUNS} runs after a warm run: median "
          f"{np.median(times):.3f} (runs {[round(t, 3) for t in times]}); ms a chunk: linker "
          f"{loop_stage['linker']:.3f}, LM loop {loop_stage['LM loop']:.3f} on {card}", flush=True)

    # -- (e) the corrupted orbit (the sensor model bench.py applies) --
    g_n, d_n = synthetic.corrupt_sequence(grays.cpu().numpy(), depths.cpu().numpy())
    noisy, _ = run(torch.from_numpy(g_n).to(dev), torch.from_numpy(d_n).to(dev), len(grays))
    est = noisy.trajectory()
    if not (np.isfinite(est).all() and noisy.num_kf >= 3):
        raise AssertionError(f"FusedBASlam on the corrupted orbit: {noisy.num_kf} keyframes, finite "
                             f"{np.isfinite(est).all()}")
    print(f"FusedBASlam on the corrupted orbit (corrupt_sequence: depth noise, holes, gray noise, quantised): ATE "
          f"{traj.ate_rmse(est, poses) * 1e3:.4f} mm, {noisy.num_kf} keyframes (beside "
          f"{', '.join(f'{k} {v * 1e3:.2f} mm' for k, v in BENCH_NOISY_BA_ATE_M.items())}, other chips)",
          flush=True)

    o, lo, wide = res["orbit"], res["loop"], res["wide loop"]
    kernel = dict(**o, loop_ms=lo["ms"], loop_event_ms=lo["event_ms"], loop_plain_ms=lo["plain_ms"],
                  loop_bound_ms=lo["bound_ms"], loop_share=lo["bound_ms"] / lo["ms"],
                  loop_live_bound_ms=lo["live_bound_ms"], loop_kernel_ms=lo["kernel_ms"],
                  wide_frames=BA_WIDE_FRAMES, wide_ms=wide["ms"], wide_plain_ms=wide["plain_ms"],
                  wide_bound_ms=wide["bound_ms"], wide_max_rel_err=wide["max_rel_err"],
                  loop_max_abs_err=lo["max_abs_err"], loop_max_rel_err=lo["max_rel_err"], orbit_ms_per_frame=orbit_ms,
                  linker_ms_per_chunk=dict(orbit=orbit_stage["linker"], loop=loop_stage["linker"]),
                  lm_loop_ms_per_chunk=dict(orbit=orbit_stage["LM loop"], loop=loop_stage["LM loop"]))
    kernel.update(max_abs_err=max(r["max_abs_err"] for r in res.values()),
                  max_rel_err=max(r["max_rel_err"] for r in res.values()))
    return dict(kernel=kernel, launches=launches)


def main() -> int:
    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.geometry import se3
    from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as cam
    from onepiece_tpu_torch.integration import device_hash as dh
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.odometry import dense
    from onepiece_tpu_torch.ops import dense_odometry as dops
    from onepiece_tpu_torch.ops import tsdf as tsdf_ops
    from onepiece_tpu_torch.ops import tsdf_slots
    from onepiece_tpu_torch.ops.image import bilateral_filter
    from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
    from onepiece_tpu_torch.utils import synthetic

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build(verbose=True)
    _build.library()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    poses = synthetic.orbit_trajectory(N_FRAMES)
    scene = synthetic.default_scene(dev)
    frames = [
        synthetic.render(
            scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy,
            cam.height, cam.width, num_steps=RENDER_STEPS,
        )
        for p in poses
    ]
    depths = torch.stack([d for d, _ in frames])
    grays = torch.stack([g for _, g in frames])
    results = {}

    # ---- 3. TSDF integrate vs plain, gray and rgb ----------------------------
    # seeded uniform colour, as tests/test_device_volume.py makes it
    rgbs = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (N_FRAMES, cam.height, cam.width, 3)).astype(np.float32)).to(dev)
    slam = FusedDenseFusion(cam, device=dev)
    vsz, trunc, kmax = slam.voxel_size, slam.truncation, slam.kmax
    intr = (cam.fx, cam.fy, cam.cx, cam.cy)
    pool = tsdf_slots.make_pool(slam.capacity, dev)
    table = dh.make_table(slam.table_size, slam.capacity, dev)
    T_w = [torch.eye(4, device=dev), torch.from_numpy(np.linalg.inv(poses[0]) @ poses[1]).to(dev)]
    for i in range(2):  # fuse frame 0 (plain, gray), then integrate frame 1 both ways
        d_f = bilateral_filter(depths[i])
        keys = tsdf_ops.touched_block_keys(d_f, T_w[i], *intr, vsz, trunc, max_blocks=kmax, stride=slam.stride)
        table, slots = dh.insert(table, keys, claim_rounds=12 if i == 0 else 2)
        slots = torch.where(slots < 0, slam.capacity, slots).to(torch.int32)
        rest = (se3.inverse_T(T_w[i]), *intr, vsz, trunc)
        if i == 0:
            tsdf_slots.integrate_slots_reference(pool, keys, slots, torch.stack([d_f, grays[i]]), *rest)
    images = {"gray": torch.stack([d_f, grays[1]]), "rgb": torch.cat([d_f[None], rgbs[1].permute(2, 0, 1)])}
    pad = torch.full((kmax,), tsdf_ops.INVALID_KEY, dtype=torch.int32, device=dev)
    entries = {kmax: (keys, slots),
               2 * kmax: (torch.cat([keys, pad]), torch.cat([slots, torch.full_like(pad, slam.capacity)]))}
    n_keys = int((keys != tsdf_ops.INVALID_KEY).sum())
    body = slice(0, slam.capacity)  # the trash row holds garbage by design
    scratch = pool.clone()
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    err1, tsdf = 0.0, {}
    for form, img in images.items():
        for k, (ks, ss) in entries.items():
            args = (ks, ss, img, *rest)
            vk = tsdf_slots.integrate_slots(pool.clone(), *args)
            vp = tsdf_slots.integrate_slots_reference(pool.clone(), *args)
            torch.cuda.synchronize()
            if not torch.equal(vk[body, 1], vp[body, 1]):
                raise AssertionError(f"tsdf_integrate {form} K={k}: weights differ from the plain version")
            err = float((vk[body] - vp[body]).abs().max())
            if not err <= KERNEL1_TOL:
                raise AssertionError(f"tsdf_integrate {form} K={k}: max |sdf/colour err| {err} > {KERNEL1_TOL}")
            err1 = max(err1, err)
            ms = device_ms(lambda: tsdf_slots.integrate_slots(scratch, *args), ("tsdf_integrate_kernel",))
            event_ms = cuda_ms(lambda: tsdf_slots.integrate_slots(scratch, *args))
            plain_ms = cuda_ms(lambda: tsdf_slots.integrate_slots_reference(scratch, *args))
            # bytes: keys and slots, the image, and for each updated voxel its 5
            # channels written and its weight read, its old sdf and colour read
            # only where that weight is > 0; other voxels are neither read nor written
            updated = vp[body, 1] != pool[body, 1]
            n_upd = int(updated.sum())
            n_new = int((updated & (pool[body, 1] == 0)).sum())
            b = bound(8 * k + img.numel() * 4 + 40 * (n_upd - n_new) + 24 * n_new,
                      TSDF_OPS_PER_VOXEL * 512 * n_keys + TSDF_OPS_PER_UPDATE * n_upd)
            tsdf[form, k] = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, **b)
            line = (f"tsdf_integrate {form} {tuple(img.shape)}: K={k} ({n_keys} real keys, {n_upd} voxels "
                    f"updated, {n_new} of them with weight 0 before), pool {tuple(pool.shape)}: max abs err "
                    f"{err:.3g}, weights equal; kernel {ms:.4f} "
                    f"ms on the device ({event_ms:.4f} ms by events), plain {plain_ms:.4f} ms, bound "
                    f"{b['bound_ms']:.5f} ms ({b['bound_by']}), roofline share {b['bound_ms'] / ms:.3f}")
            if (form, k) == ("gray", kmax):
                # every call finds the pool rows in device memory, not in L2
                cold = device_ms(lambda: (flush.sum(), tsdf_slots.integrate_slots(scratch, *args)),
                                 ("tsdf_integrate_kernel",))
                tsdf[form, k]["cold_ms"] = cold
                line += f"; {cold:.4f} ms with the L2 flushed before each call (share {b['bound_ms'] / cold:.3f})"
            print(line, flush=True)
    rgb8 = tsdf["rgb", kmax]
    results["tsdf_integrate"] = dict(
        max_abs_err=err1, **tsdf["gray", kmax], k16384_ms=tsdf["gray", 2 * kmax]["ms"],
        rgb_ms=rgb8["ms"], rgb_event_ms=rgb8["event_ms"], rgb_plain_ms=rgb8["plain_ms"],
        rgb_bound_ms=rgb8["bound_ms"], rgb_k16384_ms=tsdf["rgb", 2 * kmax]["ms"])
    del pool, vk, vp, scratch, flush, entries, images

    # ---- 4. dense Gauss-Newton kernel vs plain ----------------------------
    src = dense.preprocess_frame(grays[0], depths[0], cam)
    tgt = dense.preprocess_frame(grays[1], depths[1], cam)
    eye = torch.eye(4, device=dev)  # the first iteration's pose (rel = I)
    err2 = 0.0
    for li, c in enumerate(cam.pyramid(3)):
        term = dops.build_term_data(tgt.grays[li], tgt.depths[li], dense.SOBEL_SCALE)
        pts = src.xyzs[li].reshape(-1, 3)
        gray = src.grays[li].reshape(-1)
        rest = (c.fx, c.fy, c.cx, c.cy, dense.LAMBDA_HYBRID_DEPTH, dense.DEPTH_DIFF_MAX)
        args = (eye, pts, gray, pts[:, 2] > 0, term, *rest)
        nk = dops.normal_equations(*args)
        npl = dops.normal_equations_reference(*args)
        rel = [rel_err(a, b) for a, b in zip(nk[:3], npl[:3])]
        if not max(rel) <= KERNEL2_TOL:
            raise AssertionError(f"dense_normal_eq level {li}: rel err {rel} > {KERNEL2_TOL}")
        if float(nk.num_inliers) != float(npl.num_inliers):
            raise AssertionError(
                f"dense_normal_eq level {li}: inliers {float(nk.num_inliers)} != {float(npl.num_inliers)}")
        ne_ms = cuda_ms(lambda: dops.normal_equations(*args))
        # one whole step from the same T
        T_k = eye.clone()
        sk = dops.gauss_newton(T_k, pts, gray, term, *rest, iters=1)
        T_p, sp = dops.gn_step_reference(*args)
        dT = float((T_k - T_p).abs().max())
        if float(sk.num_inliers) != float(sp.num_inliers) or not dT <= GN_STEP_TOL:
            raise AssertionError(f"dense_normal_eq GN step level {li}: inliers {float(sk.num_inliers)} vs "
                                 f"{float(sp.num_inliers)}, max |dT| {dT} > {GN_STEP_TOL}")
        T_w = eye.clone()
        step_ms = device_ms(lambda: dops.gauss_newton(T_w, pts, gray, term, *rest, iters=1),
                            ("gn_step_kernel",))
        step_event_ms = cuda_ms(lambda: dops.gauss_newton(T_w, pts, gray, term, *rest, iters=20), reps=5) / 20
        n_it = dense.DEFAULT_ITERS[2 - li]
        level_ms = cuda_ms(lambda: dops.gauss_newton(T_w, pts, gray, term, *rest, iters=n_it), reps=10)
        plain_ms = cuda_ms(lambda: dops.gn_step_reference(*args))
        # bytes: x, y, z, gray of every source pixel, six target planes
        n_valid = int((pts[:, 2] > 0).sum())
        b2 = bound(pts.shape[0] * 16 + term.texels[..., :6].numel() * 4,
                   GN_OPS_PER_PIXEL * n_valid + GN_OPS_PER_INLIER * float(sk.num_inliers))
        abs_err = max(float((a - b).abs().max()) for a, b in zip(nk[:3], npl[:3]))
        print(f"dense_normal_eq {c.width}x{c.height}: normal equations rel err JTJ {rel[0]:.3g} "
              f"JTr {rel[1]:.3g} cost {rel[2]:.3g}, inliers {int(nk.num_inliers)} equal, {ne_ms:.4f} ms; "
              f"GN step max |dT| {dT:.3g}, inliers equal; kernel {step_ms:.4f} ms per step on the device "
              f"({step_event_ms:.4f} ms by events over 20 steps), {level_ms:.4f} ms per level call of "
              f"{n_it} steps, plain step {plain_ms:.4f} ms, "
              f"bound {b2['bound_ms']:.5f} ms ({b2['bound_by']})", flush=True)
        err2 = max(err2, abs_err, dT)
        if li == 0:
            results["dense_normal_eq"] = dict(ms=step_ms, event_ms=step_event_ms, plain_ms=plain_ms, **b2)
    results["dense_normal_eq"]["max_abs_err"] = err2

    # ---- 5. the slice, gray and rgb --------------------------------------------
    def run(forbid_syncs: bool = False, colour=None) -> tuple[FusedDenseFusion, np.ndarray, float]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = FusedDenseFusion(cam, device=dev)
        # the frame loop must never wait for the device: any synchronizing
        # operation inside it raises in this mode
        torch.cuda.set_sync_debug_mode("error" if forbid_syncs else "default")
        try:
            s.process_chunk(grays, depths, colour)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        est, _ = s.finalize()
        torch.cuda.synchronize()
        return s, est, (time.perf_counter() - t) * 1e3 / N_FRAMES

    run()  # warm: allocator, kernel library, cuBLAS/cuSOLVER handles
    slice_launches, slice_runs, slice_slams = {}, {}, {}
    for form, colour in (("gray", None), ("rgb", rgbs)):
        _build.reset_launch_counts()
        slam, est, _ = run(forbid_syncs=True, colour=colour)
        launches = {k.name: k.launches for k in _build.KERNELS}
        expect = {"tsdf_integrate": N_FRAMES, "dense_normal_eq": sum(slam.iters) * (N_FRAMES - 1), "nn1": 0,
                  "marching_cubes": 0, "hamming": 0, "ba_schur": 0}
        if launches != expect:
            raise AssertionError(f"{form} slice: kernel launches on the main path {launches}, expected {expect}")
        slice_launches[form] = launches
        ate = traj.ate_rmse(est, poses)
        vol = slam.to_volume()
        active = vol.weight[: vol.num_active] > 0
        if not (np.isfinite(est).all() and ate <= MAX_ATE_M):
            raise AssertionError(f"{form} slice: ATE {ate} m > {MAX_ATE_M} m (or non-finite poses)")
        if slam.overflow != 0:
            raise AssertionError(f"{form} slice: block overflow {slam.overflow}")
        if not (vol.num_active == len(vol.slot_of) > 0 and bool(active.any())
                and bool(torch.isfinite(vol.sdf[: vol.num_active][active]).all())
                and bool(torch.isfinite(vol.color[: vol.num_active][active]).all())):
            raise AssertionError(f"{form} slice: to_volume: empty or non-finite volume")
        times = [run(colour=colour)[2] for _ in range(TIMED_RUNS)]
        print(f"slice {form} 640x480 x {N_FRAMES} frames: ATE {ate * 1e3:.4f} mm, num_active {slam.num_active}, "
              f"overflow {slam.overflow}, key_saturated_frames {slam.key_saturated_frames}, "
              f"launches {launches}, host syncs in the frame loop 0", flush=True)
        print(f"slice {form} ms/frame over {TIMED_RUNS} fresh runs: median {np.median(times):.3f}, "
              f"p95 {np.percentile(times, 95):.3f} (runs {[round(t, 3) for t in times]}) on {card}",
              flush=True)
        slice_runs[form] = (est, slam._state.vox[body])
        slice_slams[form] = slam  # meshed in phase 8
        del slam, vol
    # tracking reads gray only: the rgb run has the gray run's poses, sdf and
    # weights, bit for bit; only its colours differ
    (est_g, vox_g), (est_c, vox_c) = slice_runs["gray"], slice_runs["rgb"]
    if not (np.array_equal(est_c, est_g) and torch.equal(vox_c[:, :2], vox_g[:, :2])):
        raise AssertionError("rgb slice: poses, sdf or weights differ from the gray run's")
    if torch.equal(vox_c[:, 2:], vox_g[:, 2:]):
        raise AssertionError("rgb slice: the colours are the gray run's")
    print("slice rgb: poses, sdf and weights bit-equal to the gray run's; colours differ", flush=True)
    del frames, rgbs, slice_runs, vox_g, vox_c

    # ---- 6. DenseSlam warm run; nn1 vs plain at its ICP shapes ------------
    from onepiece_tpu_torch.ops import nn1 as nn1_ops
    from onepiece_tpu_torch.registration import icp

    slam_gt = synthetic.loop_trajectory(SLAM_FRAMES)
    t0 = time.perf_counter()
    rendered = [
        synthetic.render(scene, torch.from_numpy(p).to(dev), cam.fx, cam.fy, cam.cx, cam.cy,
                         cam.height, cam.width, num_steps=RENDER_STEPS)
        for p in slam_gt
    ]
    s_depths = torch.stack([d for d, _ in rendered])
    s_grays = torch.stack([g for _, g in rendered])
    del rendered
    torch.cuda.synchronize()
    print(f"rendered {SLAM_FRAMES} frames of loop_trajectory at 640x480 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    icp_inputs = []  # (query at the ICP's initial pose, target, target valid) per ICP call
    with patched(icp, "point_to_point", lambda f: recording_icp_inputs(f, icp_inputs)):
        run_slam(cam, dev, s_grays, s_depths)  # warm: kernels, allocator, cuBLAS / cuSOLVER handles
    if not icp_inputs:
        raise AssertionError("the DenseSlam run made no ICP call")
    gen = torch.Generator(device=dev).manual_seed(0)
    big = (torch.randn((NN1_BIG, 3), generator=gen, device=dev),
           torch.randn((NN1_BIG, 3), generator=gen, device=dev),
           torch.rand(NN1_BIG, generator=gen, device=dev) > 0.2)
    cases = [(f"ICP call {i}", *c) for i, c in enumerate(icp_inputs)]
    cases.append((f"{NN1_BIG} x {NN1_BIG}, 20 % invalid", *big))
    err3 = 0.0
    for i, (name, q, r, v) in enumerate(cases):
        ik, dk = nn1_ops.nn1(q, r, v)
        ip, dp = nn1_ops.nn1_reference(q, r, v)
        torch.cuda.synchronize()
        err3 = max(err3, float((dk - dp).abs().max()))
        if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
            raise AssertionError(f"nn1 {name}: kernel and plain version differ ({int((ik != ip).sum())} "
                                 f"indices, max d2 err {float((dk - dp).abs().max())})")
        line = (f"nn1 {name}: query {tuple(q.shape)}, ref {tuple(r.shape)} ({int(v.sum())} valid): "
                f"indices equal, d2 bit-equal")
        if i in (0, len(cases) - 1):  # the slice's shape (submap 1 against submap 0), and the largest
            ms = device_ms(lambda: nn1_ops.nn1(q, r, v), ("nn1_chunk_kernel", "nn1_merge_kernel"))
            event_ms = cuda_ms(lambda: nn1_ops.nn1(q, r, v))
            plain_ms = cuda_ms(lambda: nn1_ops.nn1_reference(q, r, v), reps=5)
            b3 = bound(q.numel() * 4 + r.numel() * 4 + v.numel() + q.shape[0] * 8,
                       NN1_OPS_PER_PAIR * q.shape[0] * int(v.sum()))
            line += (f"; kernel {ms:.4f} ms on the device ({event_ms:.4f} ms by events), plain "
                     f"{plain_ms:.4f} ms, bound {b3['bound_ms']:.5f} ms ({b3['bound_by']}), roofline share "
                     f"{b3['bound_ms'] / ms:.3f}")
            if i == 0:
                results["nn1"] = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, **b3)
        print(line, flush=True)
    results["nn1"]["max_abs_err"] = err3
    del cases, icp_inputs, big, ik, dk, ip, dp

    # ---- 7. the DenseSlam slice -------------------------------------------
    icp_syncs, finish_syncs = [], []
    _build.reset_launch_counts()
    with SyncCounter() as sc, patched(icp, "point_to_point", lambda f: sc.counting(f, icp_syncs)):
        slam = run_slam(cam, dev, s_grays, s_depths, wrap_finish=lambda f: sc.counting(f, finish_syncs))[0]
    slam_launches = {k.name: k.launches for k in _build.KERNELS}
    n_icp = len(icp_syncs)
    expect = {"tsdf_integrate": 0, "dense_normal_eq": sum(dense.DEFAULT_ITERS) * (SLAM_FRAMES - 1),
              "nn1": (icp.DEFAULT_ITERS + 1) * n_icp, "marching_cubes": 0, "hamming": 0, "ba_schur": 0}
    if slam_launches != expect:
        raise AssertionError(f"DenseSlam kernel launches {slam_launches}, expected {expect} ({n_icp} ICP calls)")
    est = slam.trajectory()
    ate = traj.ate_rmse(est, slam_gt)
    flags = [m["icp_ok"] for m in slam.metrics if "icp_ok" in m]
    loops = [(e["src"], e["dst"]) for e in slam.edges if e["src"] - e["dst"] > 1]
    if not (np.isfinite(est).all() and ate <= MAX_SLAM_ATE_M):
        raise AssertionError(f"DenseSlam ATE {ate} m > {MAX_SLAM_ATE_M} m (or non-finite poses); icp_ok {flags}, "
                             f"edges {[(e['src'], e['dst']) for e in slam.edges]}, loop edges {loops}")
    if not (len(flags) == SLAM_FRAMES // slam.submap_size and all(flags[1:])):
        raise AssertionError(f"DenseSlam icp_ok per submap {flags}")
    frame_syncs = (sc.count - sum(finish_syncs)) / SLAM_FRAMES
    runs = [run_slam(cam, dev, s_grays, s_depths) for _ in range(SLAM_TIMED_RUNS)]
    ms_frame = [r[1] for r in runs]
    finish_ms = [m for r in runs for m in r[2]]
    print(f"DenseSlam 640x480 x {SLAM_FRAMES} frames of loop_trajectory: ATE {ate * 1e3:.4f} mm, "
          f"icp_ok {flags}, submap points {[int(c.count()) for c in slam.submap_clouds]} "
          f"(capacities {[c.capacity for c in slam.submap_clouds]}), loop edges {loops}, "
          f"edges {len(slam.edges)}, ICP calls {n_icp}, launches {slam_launches}", flush=True)
    print(f"DenseSlam host syncs: {frame_syncs:.2f} per frame, per _finish_submap {finish_syncs}, "
          f"inside each ICP call {icp_syncs}", flush=True)
    print(f"DenseSlam ms/frame over {SLAM_TIMED_RUNS} runs after a warm run: median {np.median(ms_frame):.3f} "
          f"(runs {[round(t, 3) for t in ms_frame]}); ms per _finish_submap: median "
          f"{np.median(finish_ms):.3f} (all {[round(t, 1) for t in finish_ms]}) on {card}", flush=True)

    # ---- 8. meshing --------------------------------------------------------
    phase8 = mesh_phase(cam, dev, scene, card, poses, grays, depths, slice_slams, slam, s_grays, s_depths, slam_gt)
    results["marching_cubes"] = phase8["kernel"]
    path_launches = [*slice_launches.values(), slam_launches, *phase8["launches"]]

    # ---- 9. sparse: the Hamming kernel, FusedFBASlam, the FBAFusion mesh ----
    phase9 = sparse_phase(cam, dev, scene, card, poses, grays, depths)
    results["hamming"] = phase9["kernel"]

    # ---- 10. BAFusion: the BA Schur kernel, FusedBASlam ----------------------
    phase10 = ba_phase(cam, dev, card, poses, grays, depths, phase9)
    results["ba_schur"] = phase10["kernel"]

    # the hamming launches are phase 9's counted runs, the ba_schur launches
    # phase 10's; the other four keep the counts of phases 5, 7 and 8. No
    # single PyTorch call computes any of the six functions.
    counted_in = {_build.HAMMING.name: phase9["launches"], _build.BA_SCHUR.name: phase10["launches"]}
    kernels = [
        dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
             launches=sum(n[k.name] for n in counted_in.get(k.name, path_launches)),
             **results[k.name],
             roofline_share=results[k.name]["bound_ms"] / results[k.name]["ms"], library_ms=None)
        for k in _build.KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
