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
 11. real input and state: (a) `io/tum.write_synthetic_tum` renders the
     16-frame orbit on the card and writes it as a TUM folder with the
     port's PNG encoder (encode ms per frame, the folder's MB); (b) the
     folder read back through `tools/_torch_common.load_frames`, each gray
     and depth bit-equal to `quantize_rgbd` of the in-memory render of
     phase 5 (decode ms per frame); (c) `FusedDenseFusion` from disk in
     chunks of 8, the frames decoded by the prefetch ring as a CLI runs them and
     uploaded through pinned memory: ATE <= 2 mm, no block overflow, no host
     sync in the frame loop, the TSDF and GN-step launches counted; ms per
     frame over 5 runs beside the same frames preloaded on the card; (d)
     frames 0-7, `utils/checkpoint.save`, `load(..., device="cuda")` into a
     fresh instance, frames 8-15: poses, pool and hash table bit-equal to
     (c)'s uninterrupted run (save and load ms, the file's MB); (e) the
     dataset CLIs `torch_fused_fusion --checkpoint`, `torch_fba_fusion`,
     `torch_dense_odometry`, `torch_sparse_odometry` and
     `torch_image_sequence_integration` on the folder, started together:
     each exits 0 with a finite ATE, the fused one's <= 2 mm
 12. the prefetch ring and the tools of the real-input slice: (a) the
     100-frame 640x480 `loop_trajectory` written as a TUM folder; every
     frame through the ring (`io/native_loader.py`) bit-equal to the eager
     decode, gray and rgb, at the JAX defaults (2 workers, 4 slots) and at
     the port's; decode ms per frame of each and the time to the first
     frame, beside os.cpu_count(); (b) `FusedDenseFusion` on that folder in
     chunks of 8 through the ring (as `torch_fused_fusion --dataset`):
     ATE <= 10 mm, no overflow, no host sync in the frame loop, TSDF and
     GN-step launches counted; ms per frame, medians of 5 in turns after a
     warm run, through the ring, with eager decode (phase 11's way) and
     preloaded on the card; (c) phase 11's folder with frame 4's depth PNG
     truncated: the ring raises ValueError at frame 4 naming the file and
     leaves no worker process; (d) `tools/torch_long_run.py` at 200 frames:
     its checks, a pool growth and a loop-closure edge, fps, ATE, warm-up
     and steady seconds and the launches (Hamming among them); (e)
     `tools/torch_ba_test.py`: full BA in the 2-D model (rms <= 2x the
     injected pixel noise, finite pose error, 2 BA Schur launches an LM
     step), the BA Schur kernel against its plain version on every step's
     recorded inputs within KERNEL2_TOL, one step timed with its bound;
     the pose-graph mode; (f) `torch_icp_test --synthetic` point and plane
     (|T - T_gt| <= 1e-4, 31 nn1 launches a run), `torch_convert_tsdf` on
     phase 5's gray volume (npz -> cube -> npz bit-equal on the observed
     voxels, cube -> PLY through one marching-cubes launch),
     `torch_convert_to_pcd` and `torch_transfer_labels` on phase 11's
     folder, `torch_acquire_live_data` replaying it at 30 Hz (wall time >=
     15 / 30 s)
 13. the host-loop systems, each run with the launch counts at 0 and host
     syncs counted, each held to HOST_LOOP_JAX's bars (ATE: the phase-9/10
     bar where the median of the JAX package's own host-loop system over 10
     seeds of `tools/host_loop_ate_gap.py` meets it, else 1.5x its largest
     ATE; the rotation's RPE over 8 frames within 1.5x its largest; on the
     loop a loop-closure link): (a) `FBASlam.update_frame` (TUM_CAMERA
     defaults) on the 16-frame orbit: every frame tracked, Hamming
     launches; keyframes, edges, syncs a frame and ms/frame (the median of
     3 runs after a warm run, beside phase 9's FusedFBASlam); the Hamming
     kernel on the run's first recorded `hamming_match` input and MILD on
     its first recorded query against their plain versions (equal; 1e-5
     relative); (b) `FBASlam.process_chunk` on the 100-frame loop in chunks
     of 25, ms/frame beside phase 9's; (c) `BASlam.update_frame` on the
     orbit and `process_chunk` on the loop: Hamming and BA Schur launches,
     ms/frame (the median of 3 clean runs after the counted one), the final
     BA rmse, and the BA Schur kernel against its plain version on the
     first LM step of the loop run's last BA call (2-D model: 1e-4
     relative, or against float64 within 2x the float32 plain versions, as
     the card tests hold the 2-D model; 1e-4 at BA_DAMPINGS); (d) the CLIs
     `torch_fba_fusion --per-frame --out-mesh` and `torch_ba_fusion
     --host-loop --chunk 0` on phase 11's folder, `torch_ransac_test` and
     `torch_ate_sweep` (runs A-I), started together: each exits 0 (ATE
     lines, the BA rmse, PASS, nine sweep lines); phase 13's seconds and
     the script's so far
 14. scene analysis and visualisation on the fused gray orbit's mesh (phase
     5's volume meshed again, deduplicated on the card: one marching-cubes
     launch, counted): (a) `TriangleMesh` on the card and on the CPU:
     `compute_vertex_normals`, `clustering_simplify` at 0.02 m,
     `quadric_simplify` to 50,000 faces, `prune(min_faces=100)`, each timed
     on both, faces equal and vertices, normals and colours within 1e-6 m;
     the QEM vertices against the scene SDF (median < voxel); (b)
     `render_mesh` at 640x480 of 8 turntable views and the orbit's first
     view, each against the CPU render (at least 99.9 % of pixels equal,
     the differing count printed), ms a view, each PNG read back equal
     through `io/png`; (c) `detect_patches` over 30,000 sampled vertices in
     the scene's frame, kNN at k = 12 on the card, each scene plane (floor,
     three walls) with at least 2,000 sampled vertices within 1 cm found by
     a patch within 5 deg and 2 cm, the kNN and the region growing timed;
     (d) rooms: the divider case (two faces) split at x = 0 on the card,
     `torch_room_detection`'s two-room plan giving two rooms with labels
     equal on the card and the CPU (whether they split at the divider is
     printed: the reference's pipeline splits that plan elsewhere); (e)
     k-means, k-medoids and mean shift on `torch_clustering_demo`'s blobs,
     labels equal on the card and the CPU from one start; (f) the CLIs
     `torch_render_turntable`, `torch_mesh_tools simplify-quadric` and
     `torch_detect_plane` on phase 11's fused.ply, `torch_read_ply rgbd`
     on phase 11's folder, `torch_clustering_demo`, `torch_room_detection`
     and `torch_fused_fusion --synthetic 16 --turntable`, started
     together: each exits 0, the turntables write their PNGs and GIFs
 15. `parallel/` across ranks (`parallel/launch.spawn`, `parallel/drive`):
     every module at world 1 over NCCL, then, in one set of 4 gloo ranks
     (subgroups of the first 2 and all 4; the ranks share the card and
     each collective is staged through host memory), at worlds 2 and 4,
     each rank's kernels on CUDA tensors, and world 1 held to paths
     outside `parallel/` (`world1_against_unsharded`: the unsharded
     tracker within GN_STEP_TOL, the unsharded extraction of phase 5's
     pool bit-equal in order, the plain BA step within 1e-4 relative or,
     against float64, within 2x the float32 plain step):
     pixel-sharded tracking
     of the orbit pair (T within GN_STEP_TOL of world 1, inliers equal, 28
     GN launches a rank), 4,096 blocks integrated block-sharded (bit-equal),
     the 16 orbit frames fused slot-sharded at phase 5's poses, filtered
     depths and pool settings (the gathered pool and the table bit-equal to
     world 1's, and world 1's to phase 5's FusedDenseFusion; 16 TSDF
     launches a rank), ring-halo marching cubes on that pool (triangles
     bit-equal and in order to world 1's) and the all_to_all migration (the
     mesh equal as a sorted set, num_active kept, overflow 0), one
     point-sharded BA step on phase 10's orbit BA call (within 1e-4 relative
     of world 1, 2 ba_schur launches a rank), the edge-sharded pose graph of
     a 64-pose ring (within 1e-5 of world 1, ranks bit-identical); then the
     submap pipeline on phase 6's 150-frame loop, three submaps of 50
     frames over the first 3 of those gloo ranks, against its serial run on
     the card (stages
     within 1e-4, frame positions within 1 mm; whether they are bit-equal,
     the largest differences, the launches and the ATE printed). Prints each
     world's seconds and rank 0's collectives (calls, bytes, bytes staged
     through the host, ms)
 16. ScanNet input (`scannet_phase`) on the committed synthetic export
     `tests/data/scannet_synth/` (8 colour JPEGs at 1296x968, 4:2:0, with
     cv2's decode and remap hashes in its manifest), its 640x480 depth
     rendered here at the fixture's poses and written as 16-bit PGM, frame
     7's pose -inf: (a) every JPEG decoded bit-equal to cv2's; (b) aligned
     to the depth grid bit-equal to cv2.remap's; (c) `torch_scannet_model.
     reconstruct` at stride 1 with the counts at 0 (7 frames, 7 TSDF
     launches, then 1 marching-cubes launch for the mesh), against its
     device="cpu" run by the card tests' rule (blocks within 1 %, triangles
     within 2 %, the two pools voxel by voxel with blocks matched by key:
     weights equal, sdf within 5e-4, colour within 5e-3, at most 1e-4 of
     the seen voxels outside; the card's pool meshed by the plain version
     bit-equal to the kernel's mesh), scene distance median within one
     voxel, the CLI as
     a subprocess; (d) `torch_scannet_to_tum --max-frames 7` read back by
     `TumSequence` (depth equal to the float32 formula on the PGMs, colour
     to the aligned decode, groundtruth.txt within 1e-6). Prints ms a frame
     of the JPEG decode, PGM read, align and bilateral + integrate, the
     time to a mesh, the key pass's read-back and the neighbour slots
Prints one JSON line of per-kernel results (launches: the counted runs of
phases 5 (gray and rgb), 7, 8, 14 and 16 together, for hamming phases 9's and
13's, for ba_schur phases 10's and 13's; phase15_launches: phase 15's
launches over every rank of every world and its serial submap run); ms: the kernels' device time per
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
ms a chunk of the linker and the LM loop, and phase 12's step of
`torch_ba_test` in the 2-D model (ba_test_2d_*) and phase 13's errors on
the host loop's recorded inputs (host_loop_*)), the script's seconds, the
card line, then {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

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
BA_OPS_PER_POINT = 105  # damping 17, pivoted inverse 66 (5 |x|, 3 comparisons, 58 arithmetic), dp 21 and its sign
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


class ProgramSyncs:
    """The program's own count of its waits for the device inside the block:
    its `sync.*` counters (`onepiece_tpu_torch/utils/tracing.py`), which
    count while a profiler records. Enter it outside a `SyncCounter`, so
    that the profiler starts and stops outside the sync debug mode."""

    def __enter__(self) -> "ProgramSyncs":
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        self._prof.__enter__()
        self._start = self._total()
        return self

    def __exit__(self, *exc):
        self.count = self._total() - self._start
        return self._prof.__exit__(*exc)

    @staticmethod
    def _total() -> int:
        from onepiece_tpu_torch.utils import tracing

        return sum(n for name, n in tracing.counters().items() if name.startswith("sync."))


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
    with ProgramSyncs() as ps, SyncCounter() as sc:
        slam, _ = run_orbit()
    launches.append(counted({**zero, "hamming": _build.HAMMING.launches}, "sparse orbit"))
    syncs = orbit_syncs = sc.count
    ate = orbit_ate = traj.ate_rmse(slam.trajectory(), poses)
    orbit_program_syncs = ps.count
    if not (launches[-1]["hamming"] >= 2 * (len(grays) - 1) and np.isfinite(slam.trajectory()).all()
            and ate <= MAX_SPARSE_ATE_M and slam.edge_overflow == 0 and ps.count == syncs):
        raise AssertionError(f"FusedFBASlam orbit: ATE {ate} m (<= {MAX_SPARSE_ATE_M}), overflow "
                             f"{slam.edge_overflow}, launches {launches[-1]}, host syncs {syncs}, counted by "
                             f"the program {ps.count}")
    times = [run_orbit()[1] for _ in range(SPARSE_TIMED_RUNS)]
    print(f"FusedFBASlam 640x480 x {len(grays)} frames of the orbit, one chunk: ATE {ate * 1e3:.4f} mm, "
          f"{slam.num_kf} keyframes, {slam.num_edges} edges ({slam.lc_edges_total} LC), overflow "
          f"{slam.edge_overflow}, hamming launches {launches[-1]['hamming']}; host syncs {syncs} "
          f"({syncs / len(grays):.2f} per frame; {ps.count} counted at the program's sites); ms/frame "
          f"over {SPARSE_TIMED_RUNS} runs after a warm run: median {np.median(times):.3f} "
          f"(runs {[round(t, 3) for t in times]}) on {card}", flush=True)
    orbit_ms = float(np.median(times))

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
    with ProgramSyncs() as ps, SyncCounter() as sc:
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
          f"{syncs} ({syncs / LOOP_FRAMES:.2f} per frame; {ps.count} counted at the program's sites); "
          f"ms/frame over {LOOP_TIMED_RUNS} runs after a warm run: median {np.median(times):.3f} "
          f"(runs {[round(t, 3) for t in times]}) on {card}", flush=True)
    loop_ms = float(np.median(times))

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
                orbit=dict(ate=orbit_ate, syncs=orbit_syncs, program_syncs=orbit_program_syncs, ms=orbit_ms),
                loop_ms=loop_ms)


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
    orbit_ba = tuple(a.cpu() if torch.is_tensor(a) else a for a in orbit_call)  # phase 15's BA problem
    del orbit_call, loop_call, wide_call

    # -- (c) FusedBASlam on the orbit, one chunk: launches, syncs, ATE, repeatability --
    launches = []
    _build.reset_launch_counts()
    with ProgramSyncs() as ps, SyncCounter() as sc:
        slam, _ = run(grays, depths, len(grays))
    launches.append(counted({**zero, "hamming": _build.HAMMING.launches, "ba_schur": 2 * BA_ITERS}, "BA orbit"))
    syncs = sc.count
    est = slam.trajectory()
    ate = traj.ate_rmse(est, poses)
    fba = sparse["orbit"]
    limit = min(MAX_SPARSE_ATE_M, MAX_BA_WARM_RATIO * fba["ate"] + BA_WARM_SLACK_M)
    if not (launches[-1]["hamming"] > 0 and np.isfinite(est).all() and ate <= limit
            and np.isfinite(slam.ba_mse) and slam.pt_overflow == 0 and slam.obs_overflow == 0
            and slam.edge_overflow == 0 and syncs == fba["syncs"] and ps.count == fba["program_syncs"]):
        raise AssertionError(f"FusedBASlam orbit: ATE {ate} m (<= {limit}: FusedFBASlam's {fba['ate']}), BA mse "
                             f"{slam.ba_mse}, overflow points {slam.pt_overflow} observations {slam.obs_overflow} "
                             f"edges {slam.edge_overflow}, host syncs {syncs} (FusedFBASlam {fba['syncs']}), counted "
                             f"by the program {ps.count} ({fba['program_syncs']}), launches {launches[-1]}")
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
          f"{launches[-1]}; host syncs {syncs} (FusedFBASlam {fba['syncs']}; {ps.count} counted at the "
          f"program's sites), two runs bit-equal; ms/frame over {SPARSE_TIMED_RUNS} runs after a warm run: "
          f"median {np.median(times):.3f} (runs {[round(t, 3) for t in times]}); ms a chunk: linker "
          f"{orbit_stage['linker']:.3f}, LM loop {orbit_stage['LM loop']:.3f} on {card}", flush=True)
    orbit_ms = float(np.median(times))

    # -- (d) the 100-frame loop in chunks of 25 --
    n_chunks = -(-LOOP_FRAMES // LOOP_CHUNK)
    _build.reset_launch_counts()
    with ProgramSyncs() as ps, SyncCounter() as sc:
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
          f"{launches[-1]}; host syncs {syncs} ({syncs / LOOP_FRAMES:.2f} per frame; {ps.count} counted at "
          f"the program's sites); ms/frame over {LOOP_TIMED_RUNS} runs after a warm run: median "
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
    return dict(kernel=kernel, launches=launches, orbit_ba=orbit_ba)


ATE_LINE = re.compile(r"ATE RMSE \(first (\d+) frames\): (\S+) m")
DISK_CHUNK = 8  # phase 11's chunks: frames 0-7 are checkpointed, 8-15 resumed
DISK_CLI_TIMEOUT_S = 300
DISK_CLIS = (  # (tool, arguments besides --dataset; outputs go to the run's folder)
    ("torch_fused_fusion", ("--checkpoint", "fused.npz", "--out-mesh", "fused.ply", "--out-traj", "fused.txt")),
    ("torch_fba_fusion", ("--out-traj", "fba.txt")),
    ("torch_dense_odometry", ("--out", "dense_odom.txt")),
    ("torch_sparse_odometry", ("--out", "sparse_odom.txt")),
    ("torch_image_sequence_integration", ("--out-mesh", "integration.ply")),
)


def run_clis(clis, root: str, timeout: float) -> tuple[dict, float]:
    """Start the tools `clis` ((name, arguments), each `tools/<name>.py`)
    together in `root`, one card for all, and wait for them: ({name:
    (exit code, stdout, stderr)}, seconds). Whatever still runs when this
    returns or raises is stopped."""
    tools = Path(__file__).resolve().parent / "tools"
    env = dict(os.environ, PYTHONPATH=str(tools.parent))
    procs = {name: subprocess.Popen([sys.executable, str(tools / f"{name}.py"), *args], cwd=root, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, args in clis}
    t = time.perf_counter()
    done = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout)
            done[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done, time.perf_counter() - t


def disk_phase(cam, dev, card, poses, grays, depths, root: str) -> dict:
    """Phase 11: the 16-frame orbit written as a TUM folder under `root`
    (`root`/orbit, which phase 12 reads too), read back, run from disk,
    checkpointed and resumed, and fed to the dataset CLIs."""
    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.io import png, tum
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
    from onepiece_tpu_torch.utils import checkpoint, synthetic

    tools = Path(__file__).resolve().parent / "tools"
    sys.path.insert(0, str(tools))
    from _torch_common import chunks, load_frames

    out = {}
    data = Path(root) / "orbit"
    # -- (a) write: render on the card, encode on the host --
    encode_s = []

    def timed_encode(encode):
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            res = encode(*args, **kwargs)
            encode_s.append(time.perf_counter() - t)
            return res
        return wrapped

    t = time.perf_counter()
    with patched(png, "encode", timed_encode):
        gt = tum.write_synthetic_tum(str(data), num_frames=N_FRAMES, camera=cam, device=dev)
    write_s = time.perf_counter() - t
    mb = sum(f.stat().st_size for f in data.rglob("*") if f.is_file()) / 1e6
    pixel_mb = N_FRAMES * cam.height * cam.width * (3 + 2) / 1e6
    if not np.array_equal(gt, poses):
        raise AssertionError("write_synthetic_tum: ground truth differs from the orbit's poses")
    out["encode_ms_per_frame"] = sum(encode_s) * 1e3 / N_FRAMES
    print(f"disk (a) write_synthetic_tum: {N_FRAMES} frames {cam.width}x{cam.height} in {write_s:.3f} s "
          f"(render on the card, PNG encode {out['encode_ms_per_frame']:.2f} ms/frame for rgb + depth); folder "
          f"{mb:.3f} MB for {pixel_mb:.3f} MB of pixels", flush=True)

    # -- (b) read back through the CLIs' loader: bit-equal to the quantised render --
    args = argparse.Namespace(dataset=str(data), synthetic=0, camera="tum", max_frames=None, scale=1,
                              device=str(dev))
    frames, _, gt_read = load_frames(args)
    t = time.perf_counter()
    disk = [(g, d) for _, g, d in frames]
    out["decode_ms_per_frame"] = (time.perf_counter() - t) * 1e3 / N_FRAMES
    for i, (g, d) in enumerate(disk):
        qg, qd = synthetic.quantize_rgbd(grays[i].cpu().numpy(), depths[i].cpu().numpy())
        if not (np.array_equal(g, qg) and np.array_equal(d, qd)):
            raise AssertionError(f"disk frame {i}: gray or depth differs from quantize_rgbd of the render "
                                 f"({int((g != qg).sum())} gray, {int((d != qd).sum())} depth pixels)")
    if not np.allclose(gt_read, poses, atol=2e-6):
        raise AssertionError("groundtruth.txt does not read back as the orbit's poses")
    print(f"disk (b) read back through _torch_common.load_frames: {N_FRAMES} frames bit-equal to "
          f"quantize_rgbd of the in-memory render; the ring's pass {out['decode_ms_per_frame']:.2f} ms/frame "
          f"(depth + rgb PNGs, luma fold, float32)", flush=True)

    # -- (c) FusedDenseFusion from disk, chunks of DISK_CHUNK, frames decoded by the prefetch ring --
    def from_disk():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = FusedDenseFusion(cam, device=dev)
        for g, d in chunks(load_frames(args)[0], DISK_CHUNK, dev):
            s.process_chunk(g, d)
        est, _ = s.finalize()
        torch.cuda.synchronize()
        return s, est, (time.perf_counter() - t) * 1e3 / N_FRAMES

    pre = [tuple(torch.from_numpy(np.stack([f[k] for f in disk[i : i + DISK_CHUNK]])).to(dev) for k in (0, 1))
           for i in range(0, N_FRAMES, DISK_CHUNK)]

    def preloaded():
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = FusedDenseFusion(cam, device=dev)
        for g, d in pre:
            s.process_chunk(g, d)
        est, _ = s.finalize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / N_FRAMES

    from_disk()  # warm
    _build.reset_launch_counts()
    with SyncCounter() as sc:
        s = FusedDenseFusion(cam, device=dev)
        for g, d in chunks(load_frames(args)[0], DISK_CHUNK, dev):
            s.process_chunk(g, d)
        loop_syncs = sc.count
    out["disk_launches"] = counted(
        {"tsdf_integrate": N_FRAMES, "dense_normal_eq": sum(s.iters) * (N_FRAMES - 1), "nn1": 0,
         "marching_cubes": 0, "hamming": 0, "ba_schur": 0}, "fused loop from disk")
    est, _ = s.finalize()
    ate = traj.ate_rmse(est, poses)
    if not (np.isfinite(est).all() and ate <= MAX_ATE_M and s.overflow == 0 and loop_syncs == 0):
        raise AssertionError(f"fused loop from disk: ATE {ate} m (<= {MAX_ATE_M}), overflow {s.overflow}, "
                             f"host syncs in the frame loop {loop_syncs} (0)")
    ref = s
    disk_ms = [from_disk()[2] for _ in range(TIMED_RUNS)]
    pre_ms = [preloaded() for _ in range(TIMED_RUNS)]
    out.update(disk_ms_per_frame=float(np.median(disk_ms)), preloaded_ms_per_frame=float(np.median(pre_ms)),
               ate_m=ate)
    print(f"disk (c) FusedDenseFusion from disk in chunks of {DISK_CHUNK}: ATE {ate * 1e3:.4f} mm, overflow "
          f"{s.overflow}, host syncs in the frame loop {loop_syncs}, launches {out['disk_launches']}; "
          f"ms/frame over {TIMED_RUNS} runs, frames from the prefetch ring: median {out['disk_ms_per_frame']:.3f} (runs "
          f"{[round(x, 3) for x in disk_ms]}); preloaded on the card: median "
          f"{out['preloaded_ms_per_frame']:.3f} (runs {[round(x, 3) for x in pre_ms]}) on {card}", flush=True)

    # -- (d) checkpoint after frames 0-7, resume in a fresh instance, frames 8-15 --
    a = FusedDenseFusion(cam, device=dev)
    a.process_chunk(*pre[0])
    path = str(Path(root) / "fused_ckpt.npz")
    torch.cuda.synchronize()
    t = time.perf_counter()
    checkpoint.save(a, path)
    save_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    b = checkpoint.load(path, cam, device=dev)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    b.process_chunk(*pre[1])
    est_b, _ = b.finalize()
    same = (np.array_equal(est_b, est) and torch.equal(b._state.vox, ref._state.vox)
            and all(torch.equal(x, y) for x, y in zip(b._state.table, ref._state.table)))
    if not same:
        raise AssertionError("resume from the checkpoint: poses, pool or hash table differ from the "
                             "uninterrupted run's")
    out.update(save_ms=save_ms, load_ms=load_ms, checkpoint_mb=Path(path).stat().st_size / 1e6)
    print(f"disk (d) checkpoint after frame {DISK_CHUNK - 1}, resumed in a fresh instance: poses, pool and "
          f"hash table bit-equal to the uninterrupted run's; save {save_ms:.1f} ms, load {load_ms:.1f} ms, "
          f"file {out['checkpoint_mb']:.3f} MB on {card}", flush=True)
    del a, b, ref, s, pre

    # -- (e) the dataset CLIs, all started together, one card --
    done, cli_s = run_clis([(name, ("--dataset", str(data), *extra)) for name, extra in DISK_CLIS], root,
                           DISK_CLI_TIMEOUT_S)
    results, failed = {}, []
    for name, (rc, stdout, stderr) in done.items():
        m = ATE_LINE.search(stdout)
        results[name] = float(m.group(2)) if m else None
        if rc != 0 or m is None or not np.isfinite(results[name]):
            failed.append(f"{name}: exit {rc}, ATE {results[name]}\n{stdout[-2000:]}\n{stderr[-4000:]}")
    if failed:
        raise AssertionError("dataset CLIs failed:\n" + "\n".join(failed))
    if not results["torch_fused_fusion"] <= MAX_ATE_M:
        raise AssertionError(f"torch_fused_fusion --dataset: ATE {results['torch_fused_fusion']} m > {MAX_ATE_M}")
    if not (Path(root) / "fused.npz").exists():
        raise AssertionError("torch_fused_fusion --checkpoint wrote no file")
    out["cli_ate_m"] = results
    print(f"disk (e) {len(done)} dataset CLIs on the folder, started together: all exit 0 in {cli_s:.1f} s; "
          f"ATE (m) {results}", flush=True)
    return out


LOOP_DISK_FRAMES = 100  # phase 12's folder: the 100-frame 640x480 loop_trajectory
MAX_LOOP_DENSE_ATE_M = 1.0e-2  # the fused loop over the 100-frame loop
JAX_RING = (2, 4)  # the JAX package's PrefetchingRGBDLoader defaults (n_threads, ring)
BAD_FRAME = 4  # phase 12 (c): the frame whose depth PNG is truncated
LONG_RUN_FRAMES = 200
BA_TEST_NOISE_PX = 0.5  # torch_ba_test's default --pixel-noise
LIVE_RATE_HZ = 30.0
ICP_MAX_T_ERR = 1e-4  # torch_icp_test --synthetic: |T - T_gt| (the CPU runs reach ~1e-6)


def schur(a, kernel: bool) -> dict:
    """The BA Schur kernel's (or its plain version's) system and
    back-substitution of a fixed camera step on recorded `reduced_system`
    inputs `a`: S, rhs_c, b_p, V^-1 of the observed points, dp."""
    from onepiece_tpu_torch.ops import ba_schur

    lists = ba_schur.build_lists(a[2], a[3], a[5], a[0].shape[0], a[1].shape[0])
    dc = torch.from_numpy(np.random.default_rng(0).normal(size=6 * a[0].shape[0]) * 1e-3).to(a[0])
    if kernel:
        k = ba_schur.reduced_system(*a, lists=lists)
        d = ba_schur.back_substitute(k, dc, a[2], a[3], lists)
    else:
        k = ba_schur.reduced_system_reference(*a)
        d = ba_schur.back_substitute_reference(k, dc, a[2], a[3])
    return dict(S=k.S, rhs_c=k.rhs_c, b_p=k.b_p, Vinv=k.Vinv[lists.point_ptr.diff() > 0], dp=d)


def errs(x: dict, y: dict) -> dict:
    """Relative errors (largest |x - y| / largest |y|) of each entry, in float64."""
    return {n: rel_err(x[n].double(), y[n].double()) for n in x}


def ring_workers_alive() -> list[int]:
    """Pids of this process's children that run the ring's worker script."""
    alive = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:  # the process ended meanwhile
            continue
        if ppid == os.getpid() and b"tum_frames.py" in cmd:
            alive.append(int(pid))
    return alive


def real_input_phase(cam, dev, card, slice_slams: dict, root: str) -> dict:
    """Phase 12: the prefetch ring against eager decode, the fused loop from
    disk three ways, a bad file, the long run, the BA test (the BA Schur
    kernel in the 2-D model) and the other tools of the slice."""
    import inspect
    import shutil

    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.integration import volume_ops
    from onepiece_tpu_torch.io import ply, tum
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.ops import ba_schur
    from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
    from onepiece_tpu_torch.utils import synthetic

    tools = Path(__file__).resolve().parent / "tools"
    sys.path.insert(0, str(tools))
    import torch_acquire_live_data
    import torch_ba_test
    import torch_convert_to_pcd
    import torch_convert_tsdf
    import torch_icp_test
    import torch_long_run
    import torch_transfer_labels
    from _torch_common import chunks, load_frames
    from compare_torch_ring import eager  # phase 11's decode: 8 frames a decode_many call, in the calling thread

    out = {}
    root = Path(root)
    orbit = root / "orbit"  # phase 11's 16-frame folder
    loop_dir = root / "loop"
    params = inspect.signature(tum.TumSequence.stream).parameters
    chosen = (params["n_threads"].default, params["ring"].default)

    # -- (a) the ring against eager decode on the 100-frame loop --
    t = time.perf_counter()
    loop_gt = tum.write_synthetic_tum(str(loop_dir), num_frames=LOOP_DISK_FRAMES, camera=cam, device=dev,
                                      poses=synthetic.loop_trajectory(LOOP_DISK_FRAMES))
    write_s = time.perf_counter() - t
    seq = tum.TumSequence(str(loop_dir), depth_scale=cam.depth_scale)
    pairs = [(str(loop_dir / d), str(loop_dir / r)) for _, r, d in seq.pairs]
    t = time.perf_counter()
    ref = {True: list(eager(pairs, seq.depth_scale, gray=True))}
    eager_ms = (time.perf_counter() - t) * 1e3 / LOOP_DISK_FRAMES
    ref[False] = list(eager(pairs, seq.depth_scale, gray=False))
    ring_ms, first_ms = {}, {}
    for setting in dict.fromkeys([JAX_RING, chosen]):
        for gray in (True, False):
            t = time.perf_counter()
            loader = seq.stream(gray=gray, n_threads=setting[0], ring=setting[1])
            n = 0
            for (d, img), (rd, rimg) in zip(loader, ref[gray]):
                if not (np.array_equal(d, rd) and np.array_equal(img, rimg)):
                    raise AssertionError(f"ring {setting} gray={gray}: frame {n} differs from the eager decode")
                if n == 0 and gray:
                    first_ms[setting] = (time.perf_counter() - t) * 1e3
                n += 1
            if gray:
                ring_ms[setting] = (time.perf_counter() - t) * 1e3 / LOOP_DISK_FRAMES
            if n != LOOP_DISK_FRAMES or ring_workers_alive():
                raise AssertionError(f"ring {setting}: {n} frames, workers left {ring_workers_alive()}")
    del ref
    t = time.perf_counter()  # what a worker's start costs before its first job: an interpreter and numpy
    subprocess.run([sys.executable, "-P", "-c", "import numpy"], check=True)
    start_ms = (time.perf_counter() - t) * 1e3
    out.update(eager_decode_ms_per_frame=eager_ms, ring_decode_ms_per_frame={str(k): v for k, v in ring_ms.items()},
               ring_first_frame_ms={str(k): v for k, v in first_ms.items()}, worker_start_ms=start_ms,
               cpu_count=os.cpu_count(),
               ring_setting=chosen)
    print(f"real input (a) {LOOP_DISK_FRAMES}-frame {cam.width}x{cam.height} loop folder written in {write_s:.1f} s; every frame "
          f"through the ring bit-equal to the eager decode, gray and rgb, at (n_threads, ring) {JAX_RING} (the JAX "
          f"defaults) and {chosen} (the chosen defaults), no worker left; decode ms/frame (gray, the whole pass, "
          f"worker start included): eager {eager_ms:.2f}, ring {JAX_RING} {ring_ms[JAX_RING]:.2f}, ring {chosen} "
          f"{ring_ms[chosen]:.2f}; ms from the loader's start to its first frame: ring {JAX_RING} "
          f"{first_ms[JAX_RING]:.1f}, ring {chosen} {first_ms[chosen]:.1f} (an interpreter that imports numpy, "
          f"alone: {start_ms:.1f}); os.cpu_count() {os.cpu_count()} on "
          f"{card}", flush=True)

    # -- (b) the fused loop from disk: ring, eager, preloaded --
    args = argparse.Namespace(dataset=str(loop_dir), synthetic=0, camera="tum", max_frames=None, scale=1,
                              device=str(dev))
    frames = list(eager(pairs, seq.depth_scale))
    pre = [tuple(torch.from_numpy(np.stack([f[k] for f in frames[i : i + DISK_CHUNK]])).to(dev) for k in (1, 0))
           for i in range(0, LOOP_DISK_FRAMES, DISK_CHUNK)]
    del frames
    feeds = {
        "ring": lambda: chunks(load_frames(args)[0], DISK_CHUNK, dev),
        "eager": lambda: chunks(((0.0, g, d) for d, g in eager(pairs, seq.depth_scale)), DISK_CHUNK, dev),
        "preloaded": lambda: iter(pre),
    }

    def loop(feed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = FusedDenseFusion(cam, device=dev)
        for g, d in feed():
            s.process_chunk(g, d)
        est, _ = s.finalize()
        torch.cuda.synchronize()
        return s, est, (time.perf_counter() - t) * 1e3 / LOOP_DISK_FRAMES

    loop(feeds["ring"])  # warm
    _build.reset_launch_counts()
    with SyncCounter() as sc:
        s = FusedDenseFusion(cam, device=dev)
        for g, d in feeds["ring"]():
            s.process_chunk(g, d)
        loop_syncs = sc.count
    launches = counted({"tsdf_integrate": LOOP_DISK_FRAMES, "dense_normal_eq": sum(s.iters) * (LOOP_DISK_FRAMES - 1),
                        "nn1": 0, "marching_cubes": 0, "hamming": 0, "ba_schur": 0}, "fused loop through the ring")
    est, _ = s.finalize()
    ate = traj.ate_rmse(est, loop_gt)
    if not (np.isfinite(est).all() and ate <= MAX_LOOP_DENSE_ATE_M and s.overflow == 0 and loop_syncs == 0):
        raise AssertionError(f"fused loop through the ring: ATE {ate} m (<= {MAX_LOOP_DENSE_ATE_M}), overflow "
                             f"{s.overflow}, host syncs in the frame loop {loop_syncs} (0)")
    del s
    times = {k: [] for k in feeds}
    for r in range(TIMED_RUNS):
        for name in list(feeds) if r % 2 == 0 else list(feeds)[::-1]:
            times[name].append(loop(feeds[name])[2])
    med = {k: float(np.median(v)) for k, v in times.items()}
    out.update(loop_ms_per_frame=med, loop_ate_m=ate, loop_launches=launches)
    print(f"real input (b) FusedDenseFusion on the {LOOP_DISK_FRAMES}-frame loop from disk in chunks of "
          f"{DISK_CHUNK}: ATE {ate * 1e3:.4f} mm, overflow 0, host syncs in the frame loop {loop_syncs}, launches "
          f"{launches}; ms/frame, medians of {TIMED_RUNS} after a warm run, in turns: ring {chosen} "
          f"{med['ring']:.3f} (runs {[round(x, 2) for x in times['ring']]}), eager decode {med['eager']:.3f} (runs "
          f"{[round(x, 2) for x in times['eager']]}), preloaded on the card {med['preloaded']:.3f} (runs "
          f"{[round(x, 2) for x in times['preloaded']]}); ring / preloaded {med['ring'] / med['preloaded']:.3f}, "
          f"ring / eager {med['ring'] / med['eager']:.3f}; os.cpu_count() {os.cpu_count()} on {card}", flush=True)
    del pre

    # -- (c) a truncated depth PNG: the consumer raises at its frame, no worker is left --
    bad = root / "truncated"
    shutil.copytree(orbit, bad)
    bad_seq = tum.TumSequence(str(bad), depth_scale=cam.depth_scale)
    path = bad / bad_seq.pairs[BAD_FRAME][2]
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    loader = bad_seq.stream(gray=True)
    got = 0
    try:
        for _ in loader:
            got += 1
        raise AssertionError("the ring read a truncated PNG without an error")
    except ValueError as e:
        message = str(e)
    if not (got == BAD_FRAME and f"frame {BAD_FRAME}" in message and str(path) in message):
        raise AssertionError(f"truncated PNG: raised after {got} frames: {message}")
    if any(p.poll() is None for p in loader.workers) or ring_workers_alive():
        raise AssertionError(f"truncated PNG: workers left {ring_workers_alive()}")
    print(f"real input (c) frame {BAD_FRAME}'s depth PNG truncated: the ring yielded {got} frames, then raised "
          f"ValueError ({message[:160]}); no worker left", flush=True)

    # -- (d) the long run: 200 frames of the closed loop, both systems --
    _build.reset_launch_counts()
    summary = torch_long_run.main(["--frames", str(LONG_RUN_FRAMES), "--out", str(root / "LONGRUN_torch.json"),
                                   "--metrics", str(root / "longrun_torch_metrics.jsonl")])
    lr_launches = {k.name: k.launches for k in _build.KERNELS}
    fused, sparse = summary["fused"], summary["sparse_fba"]
    if not (fused["pool_growths"] >= 1 and sparse["loop_edges"] >= 1 and lr_launches["hamming"] > 0
            and lr_launches["tsdf_integrate"] > 0 and lr_launches["dense_normal_eq"] > 0):
        raise AssertionError(f"long run: pool growths {fused['pool_growths']}, loop-closure edges "
                             f"{sparse['loop_edges']}, launches {lr_launches}")
    out["long_run"] = dict(summary, launches=lr_launches)
    print(f"real input (d) torch_long_run {LONG_RUN_FRAMES} frames: fused {fused['fps']:.2f} fps, ATE "
          f"{fused['ate_rmse_m'] * 1e3:.4f} mm, warm-up {fused['warmup_s']:.2f} s, steady {fused['steady_s']:.2f} s, "
          f"{fused['pool_growths']} pool growth(s) to {fused['capacity']}, overflow {fused['block_overflow']}; "
          f"FBA {sparse['fps']:.2f} fps, ATE {sparse['ate_rmse_m'] * 1e3:.4f} mm, warm-up {sparse['warmup_s']:.2f} s, "
          f"steady {sparse['steady_s']:.2f} s, {sparse['keyframes']} keyframes, {sparse['loop_edges']} loop edges, "
          f"edge overflow {sparse['edge_overflow']}; launches (warm and timed runs) {lr_launches}, Hamming "
          f"{lr_launches['hamming']} on {card}", flush=True)

    # -- (e) the BA test: full BA in the 2-D model (the BA Schur kernel), the pose graph --
    calls = []

    def recording(fn):
        def wrapped(*a, **kw):
            calls.append(tuple(x.clone() if torch.is_tensor(x) else x for x in a[:9]))
            return fn(*a, **kw)
        return wrapped

    _build.reset_launch_counts()
    with patched(ba_schur, "reduced_system", recording):
        full = torch_ba_test.main(["--mode", "full"])
    ba_launches = {k.name: k.launches for k in _build.KERNELS}
    if not (full["rms_px"] <= 2 * BA_TEST_NOISE_PX and np.isfinite(full["pose_err"])
            and ba_launches["ba_schur"] == 2 * len(calls) > 0):
        raise AssertionError(f"torch_ba_test full: rms {full['rms_px']} px (<= {2 * BA_TEST_NOISE_PX}), pose error "
                             f"{full['pose_err']}, launches {ba_launches} for {len(calls)} LM steps")
    def damped(a, lam):
        return (*a[:6], torch.tensor(lam, dtype=torch.float32, device=dev), *a[7:])

    # the first step, far from the optimum, at its damping and at those LM
    # reaches after rejections: within phase 10's tolerance
    first = {lam: errs(schur(damped(calls[0], lam), True), schur(damped(calls[0], lam), False))
             for lam in (float(calls[0][6]), *BA_DAMPINGS)}
    worst = {n: max(e[n] for e in first.values()) for n in first[float(calls[0][6])]}
    if not max(worst.values()) <= KERNEL2_TOL:
        raise AssertionError(f"ba_schur on torch_ba_test's first 2-D step: rel errs {first} (<= {KERNEL2_TOL})")
    # near the optimum the gradients (rhs_c, b_p) vanish to rounding noise:
    # the last step's kernel and float32 plain version, each against float64
    last = calls[-1]
    exact = schur(tuple(x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in last), False)
    noise = dict(kernel=errs(schur(last, True), exact), plain=errs(schur(last, False), exact))
    a = calls[0]
    lists = ba_schur.build_lists(a[2], a[3], a[5], a[0].shape[0], a[1].shape[0])
    k = ba_schur.reduced_system(*a, lists=lists)
    dc = torch.zeros(k.rhs_c.shape[0], device=dev)
    t_red = device_times(lambda: ba_schur.reduced_system(*a, lists=lists), BA_REDUCED_KERNELS)
    t_back = device_times(lambda: ba_schur.back_substitute(k, dc, a[2], a[3], lists), BA_BACK_KERNELS)
    ms = (sum(t_red["ms"].values()) if t_red["ms"] else device_ms(
        lambda: ba_schur.reduced_system(*a, lists=lists), BA_REDUCED_KERNELS)) + \
        (sum(t_back["ms"].values()) if t_back["ms"] else device_ms(
            lambda: ba_schur.back_substitute(k, dc, a[2], a[3], lists), BA_BACK_KERNELS))
    plain_ms = cuda_ms(lambda: ba_schur.back_substitute_reference(
        ba_schur.reduced_system_reference(*a), dc, a[2], a[3]), reps=5)
    n_bytes, n_ops, n_pairs = ba_bytes_ops(a, lists)
    b = bound(n_bytes, n_ops)
    out["ba_test_2d"] = dict(ms=ms, plain_ms=plain_ms, max_rel_err=max(worst.values()), steps=len(calls),
                             rms_px=full["rms_px"], pose_err=full["pose_err"], last_step_vs_float64=noise, **b)
    pg = torch_ba_test.main(["--mode", "posegraph"])
    if not (np.isfinite(pg["pose_err"]) and pg["pose_err"] <= 1e-4):
        raise AssertionError(f"torch_ba_test posegraph: pose error {pg['pose_err']}")
    print(f"real input (e) torch_ba_test full (2-D model): rms {full['rms_px']:.4f} px (injected "
          f"{BA_TEST_NOISE_PX} px), max pose error {full['pose_err']:.4g}, {len(calls)} LM steps, launches "
          f"{ba_launches}; the BA Schur kernel against its plain version on the first step's inputs at lam "
          f"{', '.join(f'{lam:.3g}' for lam in first)}: largest rel errs "
          f"{', '.join(f'{n} {e:.3g}' for n, e in worst.items())} (<= {KERNEL2_TOL}); on the last step's, "
          f"near the optimum, against float64: kernel "
          f"{', '.join(f'{n} {e:.3g}' for n, e in noise['kernel'].items())}, float32 plain "
          f"{', '.join(f'{n} {e:.3g}' for n, e in noise['plain'].items())}; F {a[0].shape[0]}, P "
          f"{a[1].shape[0]}, O {a[2].shape[0]} ({n_pairs} pairs): device ms a step {ms:.4f}, plain {plain_ms:.4f} "
          f"ms, bound {b['bound_ms']:.6f} ms ({b['bound_by']}: {n_ops} operations, {n_bytes} B), roofline share "
          f"{b['bound_ms'] / ms:.4f}; posegraph: max pose error {pg['pose_err']:.3g} on {card}", flush=True)

    # -- (f) the other tools --
    tool_out = {}
    for mode in ("point", "plane"):
        _build.reset_launch_counts()
        r = torch_icp_test.main(["--synthetic", "--mode", mode])
        nn1 = _build.NN1.launches
        if not (r["max_err"] <= ICP_MAX_T_ERR and nn1 == torch_icp_test.icp.DEFAULT_ITERS + 1):
            raise AssertionError(f"torch_icp_test {mode}: |T - T_gt| {r['max_err']} (<= {ICP_MAX_T_ERR}), nn1 "
                                 f"launches {nn1}")
        tool_out[f"icp_{mode}"] = dict(max_err=r["max_err"], nn1_launches=nn1)
    vol = slice_slams["gray"].to_volume()
    npz, cube, back, mesh = (str(root / n) for n in ("gray.npz", "gray.cube", "back.npz", "gray.ply"))
    volume_ops.save_volume(vol, npz)
    scale = ["--voxel", str(vol.voxel_size), "--truncation", str(vol.truncation)]
    torch_convert_tsdf.main([npz, cube])
    torch_convert_tsdf.main([cube, back, *scale])
    again = volume_ops.load_volume(back, device=dev)
    n = vol.num_active
    kept = (vol.sdf[:n].abs() < 1) & (vol.weight[:n] != 0)
    if not (again.num_active == n and np.array_equal(again.block_coords[:n], vol.block_coords[:n])
            and all(torch.equal(getattr(again, f)[:n][kept], getattr(vol, f)[:n][kept])
                    for f in ("sdf", "weight", "color"))):
        raise AssertionError("torch_convert_tsdf: npz -> cube -> npz changed an observed voxel")
    _build.reset_launch_counts()
    torch_convert_tsdf.main([cube, mesh, *scale])
    mc = _build.MARCHING_CUBES.launches
    faces = len(ply.read_ply(mesh)["faces"])
    if not (mc == 1 and faces > 0):
        raise AssertionError(f"torch_convert_tsdf -> PLY: marching-cubes launches {mc}, {faces} faces")
    tool_out["convert_tsdf"] = dict(blocks=n, observed_voxels=int(kept.sum()), faces=faces, mc_launches=mc)
    pcd = torch_convert_to_pcd.main(["--dataset", str(orbit), "--out", str(root / "orbit_cloud.ply")])
    cloud = ply.read_ply(str(root / "orbit_cloud.ply"))
    target = cloud["vertices"] + np.random.default_rng(2).normal(scale=0.002, size=cloud["vertices"].shape)
    ply.write_ply_pointcloud(str(root / "target.ply"), target.astype(np.float32))
    labels = torch_transfer_labels.main([str(root / "orbit_cloud.ply"), str(root / "target.ply"),
                                         str(root / "labeled.ply")])
    if not (pcd["points"] > 0 and labels["labeled"] == labels["points"] == pcd["points"]):
        raise AssertionError(f"torch_convert_to_pcd {pcd}, torch_transfer_labels {labels}")
    live = torch_acquire_live_data.main(["--replay", str(orbit), "--rate", str(LIVE_RATE_HZ), "--frames",
                                         str(N_FRAMES), "--out", str(root / "recorded")])
    if not (live["frames"] == N_FRAMES and live["seconds"] >= (N_FRAMES - 1) / LIVE_RATE_HZ
            and np.isfinite(live["poses"]).all()):
        raise AssertionError(f"torch_acquire_live_data: {live['frames']} frames in {live['seconds']} s")
    tool_out.update(convert_to_pcd=pcd, transfer_labels=labels,
                    acquire_live_data=dict(frames=live["frames"], seconds=live["seconds"], max_rmse=live["max_rmse"]))
    out["tools"] = tool_out
    print(f"real input (f) torch_icp_test --synthetic: point |T - T_gt| {tool_out['icp_point']['max_err']:.3g}, "
          f"plane {tool_out['icp_plane']['max_err']:.3g}, nn1 launches {tool_out['icp_point']['nn1_launches']} a "
          f"run; torch_convert_tsdf on phase 5's gray volume: npz -> cube -> npz bit-equal on {int(kept.sum())} "
          f"observed voxels of {n} blocks, cube -> PLY {faces} faces ({mc} marching-cubes launch); "
          f"torch_convert_to_pcd {pcd['points']} points from {pcd['clouds']} clouds; torch_transfer_labels "
          f"{labels['labeled']}/{labels['points']} labelled; torch_acquire_live_data {live['frames']} frames at "
          f"{LIVE_RATE_HZ:g} Hz in {live['seconds']:.3f} s (>= {(N_FRAMES - 1) / LIVE_RATE_HZ:.3f}), rmse max "
          f"{live['max_rmse']:.4f}", flush=True)
    return out


HOST_LOOP_TIMED_RUNS = 3  # each host-loop run: the median of 3 clean runs after a warm (or the counted) run
HOST_CLI_TIMEOUT_S = 300
HOST_CLIS = (  # (tool, arguments; "ORBIT" is phase 11's folder; outputs go to the run's folder)
    ("torch_fba_fusion", ("--dataset", "ORBIT", "--per-frame", "--out-traj", "fba_per_frame.txt",
                          "--out-mesh", "fba_per_frame.ply")),
    ("torch_ba_fusion", ("--dataset", "ORBIT", "--host-loop", "--chunk", "0", "--out-traj", "ba_host_loop.txt")),
    ("torch_ransac_test", ()),
    ("torch_ate_sweep", ()),
)
ATE_SWEEP_RUNS = 9  # runs A-I
# The JAX package's own host-loop systems on phase 13's cells at seeds 0-9
# (`JAX_PLATFORMS=cpu python3 tools/host_loop_ate_gap.py --packages jax
# --seeds 0 1 2 3 4 5 6 7 8 9`, 640x480, on a CPU): ATE (m) and the
# rotation's RPE over RPE_SPAN frames (degrees) per seed. The reference's
# median misses the phase-9/10 bar on three of the four cells (its chunk
# scan keeps a lost frame's pose and has no failure ladder; its BA is the
# 2-D model, whose free scale drifts), so there phase 13 holds the port to
# HOST_LOOP_MARGIN x the reference's largest ATE. An ATE bar that loose
# hardly fails a tracker that stops (a camera that never moves scores ~0.3
# m on the loop), so every cell also holds the rotation's RPE over RPE_SPAN
# frames to HOST_LOOP_MARGIN x the reference's largest (a camera that
# never moves scores 7-15x that; the rotation, since the 2-D BA's scale
# drift moves the translation's), and on the loop asks for a loop-closure
# link.
HOST_LOOP_JAX = {
    "FBASlam orbit": dict(
        ate_m=(0.010937, 0.013616, 0.008935, 0.014533, 0.009978, 0.011776, 0.010080, 0.015476, 0.010465, 0.010214),
        rpe_span_deg=(0.6358, 1.0606, 0.6824, 0.7463, 0.5361, 1.0069, 0.5032, 1.3021, 0.4863, 0.5893)),
    "FBASlam loop": dict(
        ate_m=(0.037671, 0.034062, 0.036635, 0.034236, 0.034509, 0.034786, 0.036019, 0.038548, 0.036996, 0.036664),
        rpe_span_deg=(0.9101, 0.8526, 0.9139, 0.9004, 0.8498, 0.8752, 0.8675, 0.9319, 0.8924, 0.8620)),
    "BASlam orbit": dict(
        ate_m=(0.017776, 0.009005, 0.058038, 0.062567, 0.012732, 0.029110, 0.015864, 0.022647, 0.020563, 0.022667),
        rpe_span_deg=(0.7994, 0.5971, 2.4252, 2.1895, 0.6468, 1.0994, 0.6267, 1.1549, 1.0563, 0.7126)),
    "BASlam loop": dict(
        ate_m=(0.108760, 0.025854, 0.068062, 0.076266, 0.078659, 0.070724, 0.100541, 0.043401, 0.076173, 0.081222),
        rpe_span_deg=(0.8207, 0.8055, 0.8446, 0.7574, 0.8142, 0.7376, 0.6487, 0.8589, 0.6948, 0.6857)),
}
HOST_LOOP_MARGIN = 1.5
RPE_SPAN = 8  # frames (tools/host_loop_ate_gap.py's RPE_SPAN)


def host_loop_check(cell: str, bar: float, est: np.ndarray, gt: np.ndarray, lost: int, lc: int | None) -> dict:
    """Phase 13's accuracy check of one run (`lost`: its frames that lost
    tracking, printed; `lc`: its loop-closure edges or linked pairs, None on
    the orbit): ATE within the phase-9/10 `bar` where the JAX reference's
    median meets it, else within HOST_LOOP_MARGIN x its largest; the
    rotation's RPE over RPE_SPAN frames within HOST_LOOP_MARGIN x its
    largest; on the loop a link. Raises when a bar is missed; returns the
    readings and the bars."""
    from onepiece_tpu_torch.io import trajectory as traj

    ref = HOST_LOOP_JAX[cell]
    t_span, r_span = traj.rpe_rmse(est, gt, delta=RPE_SPAN)
    still = traj.rpe_rmse(np.tile(np.eye(4), (len(gt), 1, 1)), gt, delta=RPE_SPAN)[1]
    r = dict(ate_m=traj.ate_rmse(est, gt), rpe_span_m=t_span, rpe_span_deg=float(np.degrees(r_span)),
             still_span_deg=float(np.degrees(still)), lost=lost, lc=lc,
             ate_bar_m=bar if np.median(ref["ate_m"]) <= bar else HOST_LOOP_MARGIN * max(ref["ate_m"]),
             rpe_span_bar_deg=HOST_LOOP_MARGIN * max(ref["rpe_span_deg"]), jax_ate_m=ref["ate_m"])
    if not (np.isfinite(est).all() and r["ate_m"] <= r["ate_bar_m"] and r["rpe_span_deg"] <= r["rpe_span_bar_deg"]
            and (lc is None or lc >= 1)):
        raise AssertionError(f"{cell}: {r} (ATE and the rotation's RPE over {RPE_SPAN} frames within their bars, "
                             "finite poses, a loop-closure link on the loop)")
    return r


def host_loop_line(r: dict) -> str:
    """A run's readings beside their bars, for the phase's printout."""
    return (f"ATE {r['ate_m'] * 1e3:.4f} mm (<= {r['ate_bar_m'] * 1e3:.4g}; the JAX package's "
            f"{min(r['jax_ate_m']) * 1e3:.3f}-{max(r['jax_ate_m']) * 1e3:.3f}), RPE over {RPE_SPAN} frames "
            f"{r['rpe_span_m'] * 1e3:.4f} mm and {r['rpe_span_deg']:.4f} deg (<= {r['rpe_span_bar_deg']:.4g}; a "
            f"camera that never moves {r['still_span_deg']:.4g}), {r['lost']} frames lost"
            + ("" if r["lc"] is None else f", {r['lc']} loop-closure links (>= 1)"))


def first_calls(rec: dict, name: str):
    """A wrapper that records (clones of) the positional arguments of the
    first call under `name` in `rec`."""
    def wrap(fn):
        def wrapped(*a, **kw):
            if name not in rec:
                rec[name] = tuple(x.clone() if torch.is_tensor(x) else x for x in a)
            return fn(*a, **kw)
        return wrapped
    return wrap


def host_loop_schur_errs(a, dev) -> tuple[dict, dict, dict]:
    """The BA Schur kernel against its plain version on BASlam's recorded
    `reduced_system` inputs `a` (the 2-D model): (rel errs against the plain
    version, each float32 version's rel errs against the plain version in
    float64, rel errs at the dampings LM reaches after rejections). Each
    entry is held within KERNEL2_TOL of the plain version, or, where the
    2-D float32 system is only as accurate as its rounding (damped V blocks
    of condition ~1e4-1e5 at the first step's small damping), as the card
    tests hold the 2-D model: the kernel's error against float64 within 2x
    the larger of the card's and the CPU's float32 plain versions'. At the
    larger dampings every entry within KERNEL2_TOL."""
    def moved(x, **kw):
        return tuple(t.to(**kw) if torch.is_tensor(t) and (t.is_floating_point() or "device" in kw) else t
                     for t in x)

    k, p = schur(a, True), schur(a, False)
    exact = schur(moved(a, dtype=torch.float64), False)
    cpu = {n: v.to(dev) for n, v in schur(moved(a, device="cpu"), False).items()}
    rel = errs(k, p)
    vs64 = dict(kernel=errs(k, exact), plain=errs(p, exact), plain_cpu=errs(cpu, exact))
    v_cond = torch.linalg.cond(exact["Vinv"])  # the damped V blocks', in float64
    vs64["cond"] = dict(V_median=float(v_cond.median()), V_max=float(v_cond.max()),
                        S=float(torch.linalg.cond(exact["S"])))
    held = {n: rel[n] <= KERNEL2_TOL or vs64["kernel"][n] <= 2 * max(vs64["plain"][n], vs64["plain_cpu"][n])
            for n in rel}
    at_lam = {}
    for lam in BA_DAMPINGS:
        d = (*a[:6], torch.tensor(lam, dtype=torch.float32, device=dev), *a[7:])
        at_lam[lam] = errs(schur(d, True), schur(d, False))
    if not (all(held.values()) and all(max(e.values()) <= KERNEL2_TOL for e in at_lam.values())):
        raise AssertionError(f"ba_schur on the first LM step of BASlam's last BA on the loop: rel errs {rel} (<= "
                             f"{KERNEL2_TOL}, or against float64 {vs64}: kernel <= 2x the float32 plain versions); "
                             f"at the dampings {at_lam} (<= {KERNEL2_TOL})")
    return rel, vs64, at_lam


def host_loop_phase(cam, dev, card, poses, grays, depths, sparse: dict, root: str, t_script: float) -> dict:
    """Phase 13: the host-loop systems (FBASlam, BASlam, MILD's host half,
    the chunk scan) on the orbit and the 100-frame loop, the Hamming, MILD
    and BA Schur kernels held on recorded inputs of those runs, and the four
    CLIs of the slice."""
    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.lcdetection import mild
    from onepiece_tpu_torch.ops import ba_schur, hamming
    from onepiece_tpu_torch.systems import baslam as baslam_mod
    from onepiece_tpu_torch.systems.baslam import BASlam
    from onepiece_tpu_torch.systems.fbaslam import FBASlam

    t_phase = time.perf_counter()
    zero = {k.name: 0 for k in _build.KERNELS}
    loop_gt, l_grays, l_depths = sparse["loop"]
    out, launches = {}, []

    def per_frame(cls, g, d):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = cls(cam, device=dev)
        infos = [s.update_frame(gi, di) for gi, di in zip(g, d)]
        torch.cuda.synchronize()
        return s, infos, (time.perf_counter() - t) * 1e3 / len(g)

    def chunked(cls, g, d):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s = cls(cam, device=dev)
        for i in range(0, len(g), LOOP_CHUNK):
            s.process_chunk(g[i : i + LOOP_CHUNK], d[i : i + LOOP_CHUNK])
        torch.cuda.synchronize()
        return s, None, (time.perf_counter() - t) * 1e3 / len(g)

    def counted_run(what, fn, *args, wraps=()):
        """fn(*args) with the launch counts at 0 and host syncs counted;
        `wraps` (obj, name, wrapper) are patched in while it runs."""
        _build.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            for obj, name, wrap in wraps:
                stack.enter_context(patched(obj, name, wrap))
            sc = stack.enter_context(SyncCounter())
            res = fn(*args)
            torch.cuda.synchronize()
            syncs = sc.count
        n = {k.name: k.launches for k in _build.KERNELS}
        launches.append(counted({**zero, "hamming": n["hamming"], "ba_schur": n["ba_schur"]}, what))
        return res, syncs, launches[-1]

    # -- (a) FBASlam.update_frame on the 16-frame orbit, TUM_CAMERA defaults --
    per_frame(FBASlam, grays, depths)  # warm
    rec = {}
    (fba, infos, _), syncs, n = counted_run(
        "FBASlam orbit", per_frame, FBASlam, grays, depths,
        wraps=((hamming, "hamming_match", first_calls(rec, "match")),
               (mild, "mild_feature_scores", first_calls(rec, "mild"))))
    if not (all(i["success"] for i in infos) and n["hamming"] > 0 and n["ba_schur"] == 0
            and "match" in rec and "mild" in rec):
        raise AssertionError(f"FBASlam.update_frame orbit: success {[i['success'] for i in infos]}, launches {n}, "
                             f"recorded {sorted(rec)}")
    r = host_loop_check("FBASlam orbit", MAX_SPARSE_ATE_M, fba.trajectory(), poses,
                        fba.state.tracking_success.count(False), None)
    times = [per_frame(FBASlam, grays, depths)[2] for _ in range(HOST_LOOP_TIMED_RUNS)]
    out["fba_orbit"] = dict(**r, keyframes=len(fba.keyframe_frames), edges=len(fba.edges),
                            syncs_per_frame=syncs / len(grays), ms_per_frame=float(np.median(times)), launches=n)
    size = f"{cam.width}x{cam.height}"
    print(f"host loop (a) FBASlam.update_frame {size} x {len(grays)} frames of the orbit: {host_loop_line(r)}, "
          f"every frame tracked, {len(fba.keyframe_frames)} keyframes, {len(fba.edges)} edges ({fba.lc_edges} LC); "
          f"launches {n}; host syncs {syncs} ({syncs / len(grays):.2f} per frame); ms/frame over "
          f"{HOST_LOOP_TIMED_RUNS} runs after a warm run: median {np.median(times):.3f} (runs "
          f"{[round(t, 3) for t in times]}; FusedFBASlam in phase 9: {sparse['orbit']['ms']:.3f}) on {card}",
          flush=True)
    # the kernels on the recorded inputs: the first track's match, the first MILD query
    a = rec["match"]
    k, p = hamming.hamming_match(*a), hamming.hamming_match_reference(*a)
    if not all(torch.equal(x, y) for x, y in zip(k, p)):
        raise AssertionError("hamming_match on FBASlam's first track: kernel and plain version differ")
    m = rec["mild"]
    fk, fp = mild.mild_feature_scores(*m), mild.mild_feature_scores_reference(*m)
    mild_rel = rel_err(fk, fp)
    if not (float(fp.max()) > 0 and mild_rel <= 1e-5):
        raise AssertionError(f"mild_feature_scores on FBASlam's first query: rel err {mild_rel} (<= 1e-5)")
    print(f"host loop (a) on FBASlam's recorded inputs: hamming_match ({a[0].shape[0]} x {a[1].shape[0]}, "
          f"{int(a[2].sum())} valid targets) indices and distances equal to the plain version; "
          f"mild_feature_scores ({m[0].shape[0]} queries x DB {tuple(m[2].shape)}, g = {int(m[4])}) rel err "
          f"{mild_rel:.3g} (<= 1e-5)", flush=True)
    out["fba_orbit"].update(mild_rel_err=mild_rel)
    del rec

    # -- (b) FBASlam.process_chunk on the 100-frame loop, chunks of 25 --
    (fba_l, _, _), syncs, n = counted_run("FBASlam loop", chunked, FBASlam, l_grays, l_depths)
    if not n["hamming"] > 0:
        raise AssertionError(f"FBASlam.process_chunk loop: launches {n}")
    r = host_loop_check("FBASlam loop", MAX_LOOP_ATE_M, fba_l.trajectory(), loop_gt,
                        fba_l.state.tracking_success.count(False), fba_l.lc_edges)
    times = [chunked(FBASlam, l_grays, l_depths)[2] for _ in range(HOST_LOOP_TIMED_RUNS)]
    out["fba_loop"] = dict(**r, keyframes=len(fba_l.keyframe_frames), edges=len(fba_l.edges),
                           syncs_per_frame=syncs / LOOP_FRAMES, ms_per_frame=float(np.median(times)), launches=n)
    print(f"host loop (b) FBASlam.process_chunk {size} x {LOOP_FRAMES} frames of loop_trajectory in chunks of "
          f"{LOOP_CHUNK}: {host_loop_line(r)}, {len(fba_l.keyframe_frames)} keyframes, {len(fba_l.edges)} edges; "
          f"launches {n}; host syncs {syncs} ({syncs / LOOP_FRAMES:.2f} per frame); "
          f"ms/frame over {HOST_LOOP_TIMED_RUNS} runs after the counted run: median {np.median(times):.3f} (runs "
          f"{[round(t, 3) for t in times]}), beside FusedFBASlam's {sparse['loop_ms']:.3f} in phase 9 on {card}",
          flush=True)
    del fba, fba_l

    # -- (c) BASlam: update_frame on the orbit, process_chunk on the loop --
    for name, run, g, d, gt, bar in (("orbit", per_frame, grays, depths, poses, MAX_SPARSE_ATE_M),
                                     ("loop", chunked, l_grays, l_depths, loop_gt, MAX_LOOP_ATE_M)):
        steps, mses = [], []  # per BA call: its LM steps' reduced_system inputs; its mse

        def recording(fn):
            def wrapped(*a, **kw):
                steps[-1].append(tuple(x.clone() if torch.is_tensor(x) else x for x in a[:9]))
                return fn(*a, **kw)
            return wrapped

        def keeping_mse(fn):
            def wrapped(self, *a, **kw):
                steps.append([])
                mse = fn(self, *a, **kw)
                mses.append(mse)
                return mse
            return wrapped

        (ba, _, _), syncs, n = counted_run(
            f"BASlam {name}", run, BASlam, g, d,
            wraps=((ba_schur, "reduced_system", recording), (baslam_mod.BASlam, "optimize", keeping_mse)))
        # timed as FBASlam is: clean runs (no wrappers, no sync counter) after the counted run
        times = [run(BASlam, g, d)[2] for _ in range(HOST_LOOP_TIMED_RUNS)]
        ms = float(np.median(times))
        final = [m for m in mses if m is not None]
        if not (n["ba_schur"] > 0 and n["hamming"] > 0 and final and np.isfinite(final[-1])):
            raise AssertionError(f"BASlam {name}: launches {n}, BA mse {mses}")
        r = host_loop_check(f"BASlam {name}", bar, ba.trajectory(), gt, ba.state.tracking_success.count(False),
                            ba.lc_edges if name == "loop" else None)
        # the first LM step of the run's last BA call, kernel against plain
        last = [c for c in steps if c][-1][0] if name == "loop" else None
        rec_errs = None
        if last is not None:
            rec_errs, vs64, at_lam = host_loop_schur_errs(last, dev)
        out[f"ba_{name}"] = dict(**r, keyframes=len(ba.keyframe_frames), world_points=len(ba.world_points),
                                 observations=len(ba.observations), final_ba_rmse_px=float(np.sqrt(final[-1])),
                                 syncs_per_frame=syncs / len(g), ms_per_frame=ms, launches=n,
                                 schur_rel_errs=rec_errs, schur_cond=None if last is None else vs64["cond"])
        print(f"host loop (c) BASlam.{'update_frame' if name == 'orbit' else 'process_chunk'} {size} x {len(g)} "
              f"frames of the {name}: {host_loop_line(r)}, {len(ba.keyframe_frames)} keyframes, "
              f"{len(ba.world_points)} world points, {len(ba.observations)} observations, "
              f"{len(final)} BA calls, final BA rmse {np.sqrt(final[-1]):.4f} px; launches {n}; host syncs {syncs} "
              f"({syncs / len(g):.2f} per frame); ms/frame over {HOST_LOOP_TIMED_RUNS} runs after the counted run: "
              f"median {ms:.3f} (runs {[round(t, 3) for t in times]})"
              + ("" if rec_errs is None else "; the BA Schur kernel on the first LM step of the last BA call "
                 f"(2-D model), F {last[0].shape[0]}, P {last[1].shape[0]}, O {last[2].shape[0]}, lam "
                 f"{float(last[6]):.3g}: rel errs against the plain version "
                 + ", ".join(f"{k} {v:.3g}" for k, v in rec_errs.items())
                 + "; against float64: kernel " + ", ".join(f"{k} {v:.3g}" for k, v in vs64["kernel"].items())
                 + ", float32 plain (card, CPU) " + ", ".join(
                     f"{k} {v:.3g} / {vs64['plain_cpu'][k]:.3g}" for k, v in vs64["plain"].items())
                 + "; condition (float64): V blocks median {V_median:.3g}, max {V_max:.3g}, S {S:.3g}".format(
                     **vs64["cond"])
                 + "; at lam " + "; ".join(f"{lam:.3g}: " + ", ".join(f"{k} {v:.3g}" for k, v in e.items())
                                          for lam, e in at_lam.items()))
              + f" on {card}", flush=True)
        del ba, steps

    # -- (d) the four CLIs of the slice, started together, one card --
    orbit = str(Path(root) / "orbit")
    done, cli_s = run_clis([(name, [orbit if a == "ORBIT" else a for a in extra]) for name, extra in HOST_CLIS],
                           root, HOST_CLI_TIMEOUT_S)
    stdout = {name: out for name, (_, out, _) in done.items()}
    failed = [f"{name}: exit {rc}\n{out[-2000:]}\n{err[-4000:]}" for name, (rc, out, err) in done.items() if rc != 0]
    if failed:
        raise AssertionError("host-loop CLIs failed:\n" + "\n".join(failed))
    ates = {name: ATE_LINE.search(stdout[name]) for name in ("torch_fba_fusion", "torch_ba_fusion")}
    sweep = [line for line in stdout["torch_ate_sweep"].splitlines() if " ate=" in line]
    rmse = re.search(r"final BA reprojection rmse: (\S+) px", stdout["torch_ba_fusion"])
    if not (all(m and np.isfinite(float(m.group(2))) for m in ates.values()) and rmse
            and "PASS" in stdout["torch_ransac_test"] and len(sweep) == ATE_SWEEP_RUNS
            and (Path(root) / "fba_per_frame.ply").exists()):
        raise AssertionError(f"host-loop CLIs: ATE lines {ates}, BA rmse {rmse}, ransac "
                             f"{stdout['torch_ransac_test'][-500:]}, sweep lines {sweep}")
    out["clis"] = dict(seconds=cli_s, ate_m={k: float(m.group(2)) for k, m in ates.items()},
                       final_ba_rmse_px=float(rmse.group(1)), ate_sweep=sweep,
                       ransac=stdout["torch_ransac_test"].strip().splitlines())
    print(f"host loop (d) {len(done)} CLIs started together, all exit 0 in {cli_s:.1f} s: torch_fba_fusion "
          f"--per-frame ATE {out['clis']['ate_m']['torch_fba_fusion'] * 1e3:.4f} mm (and its mesh), torch_ba_fusion "
          f"--host-loop ATE {out['clis']['ate_m']['torch_ba_fusion'] * 1e3:.4f} mm, final BA rmse "
          f"{out['clis']['final_ba_rmse_px']:.4f} px; torch_ransac_test: {' | '.join(out['clis']['ransac'])}; "
          f"torch_ate_sweep (runs A-I):\n  " + "\n  ".join(sweep), flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13 took {out['seconds']:.1f} s; the script so far {time.perf_counter() - t_script:.1f} s",
          flush=True)
    out["launches"] = launches
    return out


SCENE_CELL_M = 0.02  # clustering_simplify's cell (tools/mesh_tools.py's default)
QEM_TARGET_FACES = 50_000
PRUNE_MIN_FACES = 100  # tools/mesh_tools.py's default
MESH_VERTEX_TOL_M = 1e-6  # card against CPU: vertices, normals and colours
TURNTABLE_VIEWS = 8
MIN_PIXEL_AGREEMENT = 0.999  # render on the card against the CPU
PLANE_SAMPLES = 30_000  # tests/test_algorithm.py:87's room scale
PLANE_KNN = 12
PLANE_MIN_SUPPORT = 2000  # sampled vertices within PLANE_BAND_M of a scene plane
PLANE_BAND_M = 0.01
PLANE_MAX_ANGLE_DEG = 5.0
PLANE_MAX_OFFSET_M = 0.02
PLANE_MIN_POINTS = 500  # detect_patches' min_points for the planes phase 14 asks for
SCENE_CLI_TIMEOUT_S = 300
SCENE_CLIS = (  # (tool, arguments; "ORBIT" is phase 11's folder, "MESH" phase 11's fused.ply; outputs in its run folder)
    ("torch_render_turntable", ("MESH", "--frames", "4", "--out-dir", "tt_mesh", "--gif", "tt_mesh/turntable.gif")),
    ("torch_mesh_tools", ("simplify-quadric", "MESH", "qem.ply", "--target-faces", str(QEM_TARGET_FACES))),
    ("torch_read_ply", ("rgbd", "ORBIT/depth/0.000000.png", "--rgb", "ORBIT/rgb/0.000000.png", "--rewrite",
                        "rgbd_cloud.ply")),
    ("torch_clustering_demo", ("--method", "kmedoids")),
    ("torch_detect_plane", ("MESH", "planes.ply", "--knn", str(PLANE_KNN), "--max-points", str(PLANE_SAMPLES),
                            "--min-points", str(PLANE_MIN_POINTS))),
    ("torch_room_detection", ()),
    ("torch_fused_fusion", ("--synthetic", "16", "--turntable", "tt_fused", "--out-mesh", "tt_fused.ply",
                            "--out-traj", "tt_fused.txt")),
)


def pixel_agreement(a: np.ndarray, b: np.ndarray) -> tuple[float, int]:
    """(share of pixels whose every channel is equal, count of the others)
    of two (H, W, C) images."""
    same = (a == b).all(-1)
    return float(same.mean()), int((~same).sum())


def planes_found(points: np.ndarray, patches, planes: np.ndarray) -> list[dict]:
    """For each scene plane (n, d) of planes (P, 4), n unit, n . p + d = 0:
    its support among points (N, 3) (within PLANE_BAND_M), and the patch
    (n, d) nearest to it in angle, its angle in degrees and its offset
    difference; `ok` where the plane has too little support to be asked
    for, or has a patch within PLANE_MAX_ANGLE_DEG and PLANE_MAX_OFFSET_M."""
    out = []
    for n, d in zip(planes[:, :3], planes[:, 3]):
        support = int((np.abs(points @ n + d) < PLANE_BAND_M).sum())
        cands = []  # (misses, angle, patch, offset): a matching patch first, else the nearest in angle
        for i, p in enumerate(patches):
            pn, pd = p.model[:3] / np.linalg.norm(p.model[:3]), p.model[3] / np.linalg.norm(p.model[:3])
            if pn @ n < 0:
                pn, pd = -pn, -pd
            angle = float(np.degrees(np.arccos(np.clip(pn @ n, -1.0, 1.0))))
            offset = float(abs(pd - d))
            cands.append((not (angle <= PLANE_MAX_ANGLE_DEG and offset <= PLANE_MAX_OFFSET_M), angle, i, offset))
        misses, angle, patch, offset = min(cands) if cands else (True, float("inf"), None, float("inf"))
        asked = support >= PLANE_MIN_SUPPORT
        out.append(dict(plane=[float(x) for x in (*n, d)], support=support, asked=asked, found=not misses,
                        ok=not misses or not asked, patch=patch, angle_deg=angle, offset_m=offset))
    return out


def divider_split(labels: np.ndarray, centroids: np.ndarray) -> bool:
    """Whether the faces left of x = 0 share one label, those right of it
    another."""
    left, right = set(labels[centroids[:, 0] < 0].tolist()), set(labels[centroids[:, 0] > 0].tolist())
    return len(left) == 1 and len(right) == 1 and left != right


def scene_phase(cam, dev, card, scene, poses, fused, root: str, t_script: float) -> dict:
    """Phase 14: scene analysis and visualisation on the fused gray orbit's
    mesh (the card against the CPU), plane and room detection, clustering,
    and the slice's CLIs."""
    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.algorithm import clustering, dcel, rooms
    from onepiece_tpu_torch.algorithm.patch_detection import detect_patches
    from onepiece_tpu_torch.geometry.mesh import TriangleMesh
    from onepiece_tpu_torch.io.png import read_png, write_png
    from onepiece_tpu_torch.ops.knn import knn
    from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup
    from onepiece_tpu_torch.viz.render import render_mesh, to_uint8

    tools = Path(__file__).resolve().parent / "tools"
    sys.path.insert(0, str(tools))
    import torch_clustering_demo
    import torch_render_turntable
    import torch_room_detection

    t_phase = time.perf_counter()
    zero = {k.name: 0 for k in _build.KERNELS}
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    # -- (a) the mesh: the fused gray orbit's, deduplicated on the card; its ops on the card and the CPU --
    _build.reset_launch_counts()
    verts, faces, cols = dedup_triangle_soup(*fused.to_volume().extract_mesh_tensors())
    launches = counted({**zero, "marching_cubes": 1}, "phase 14 mesh")
    mesh = TriangleMesh(verts, faces, cols)
    host = mesh.to("cpu")
    ops = (
        ("compute_vertex_normals", lambda m: TriangleMesh(m.vertices, m.faces, m.colors).compute_vertex_normals()),
        (f"clustering_simplify {SCENE_CELL_M} m", lambda m: m.clustering_simplify(SCENE_CELL_M)),
        (f"quadric_simplify to {QEM_TARGET_FACES}", lambda m: m.quadric_simplify(QEM_TARGET_FACES)),
        (f"prune min_faces {PRUNE_MIN_FACES}", lambda m: m.prune(PRUNE_MIN_FACES)),
    )
    mesh_ops = {}
    for name, op in ops:
        op(mesh)  # warm
        card_out, card_ms = timed(lambda: op(mesh))
        cpu_out, cpu_ms = timed(lambda: op(host))
        errs = {}
        for f in ("vertices", "normals", "colors"):
            a, b = getattr(card_out, f), getattr(cpu_out, f)
            if (a is None) != (b is None):
                raise AssertionError(f"{name}: {f} on one device only")
            if a is not None:
                errs[f] = float((a.cpu() - b).abs().max()) if len(b) else 0.0
        if not (torch.equal(card_out.faces.cpu(), cpu_out.faces) and max(errs.values()) <= MESH_VERTEX_TOL_M):
            raise AssertionError(f"{name}: card against CPU: faces equal {torch.equal(card_out.faces.cpu(), cpu_out.faces)}, "
                                 f"max errs {errs} (> {MESH_VERTEX_TOL_M}?)")
        mesh_ops[name] = dict(card_ms=card_ms, cpu_ms=cpu_ms, faces=len(card_out.faces),
                              vertices=len(card_out.vertices), max_errs=errs, out=card_out)
        print(f"scene (a) {name} on {len(faces)} faces: {len(card_out.vertices)} vertices, {len(card_out.faces)} faces; "
              f"card {card_ms:.2f} ms, CPU {cpu_ms:.2f} ms; faces equal, max |card - CPU| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" on {card}", flush=True)
    qem = mesh_ops[f"quadric_simplify to {QEM_TARGET_FACES}"].pop("out")
    for m in mesh_ops.values():
        m.pop("out", None)
    med, p90 = scene_distance(scene, qem.vertices.cpu().numpy(), poses[0], dev)
    if not (len(qem.faces) <= QEM_TARGET_FACES and med < fused.voxel_size):
        raise AssertionError(f"QEM: {len(qem.faces)} faces (target {QEM_TARGET_FACES}), |scene sdf| median {med} "
                             f"(< voxel {fused.voxel_size})")
    print(f"scene (a) QEM vertices against the scene SDF: median {med * 1e3:.3f} mm, p90 {p90 * 1e3:.3f} mm "
          f"(voxel {fused.voxel_size * 1e3:.2f} mm)", flush=True)
    out["mesh"] = dict(faces=len(faces), vertices=len(verts), ops=mesh_ops, qem_sdf_median_m=med, qem_sdf_p90_m=p90)

    # -- (b) the render: 8 turntable views and the orbit's first view, card against CPU; PNGs through io/png --
    v_host = verts.cpu().numpy()
    center = v_host.mean(0)
    radius = 2.2 * float(np.abs(v_host - center).max())
    tt_cam = torch_render_turntable.turntable_camera(cam.width, cam.height)
    # the volume's frame is the first camera's: the orbit's first view is the identity pose
    views = [(f"turntable {i}", tt_cam, T) for i, T in
             enumerate(torch_render_turntable.turntable_poses(center, radius, TURNTABLE_VIEWS))]
    views.append(("orbit frame 0", cam, np.eye(4)))
    render_mesh(verts, faces, tt_cam, views[0][2], cols)  # warm
    view_ms, worst, png_ms = [], (1.0, 0), []
    for i, (name, c, T) in enumerate(views):
        img, ms = timed(lambda: render_mesh(verts, faces, c, T, cols))
        view_ms.append(ms)
        ref = render_mesh(host.vertices, host.faces, c, T, host.colors)
        share, n_diff = pixel_agreement(img.cpu().numpy(), ref.numpy())
        covered = float((ref.numpy() > 0).any(-1).mean())
        if not (share >= MIN_PIXEL_AGREEMENT and covered > 0.05):
            raise AssertionError(f"render {name}: {share:.6f} of pixels equal to the CPU's ({n_diff} differ; "
                                 f"at least {MIN_PIXEL_AGREEMENT}), {covered:.3f} covered")
        worst = min(worst, (share, n_diff))
        u8 = to_uint8(img)
        path = os.path.join(root, f"scene_view_{i}.png")
        t = time.perf_counter()
        write_png(path, u8)
        png_ms.append((time.perf_counter() - t) * 1e3)
        if not np.array_equal(read_png(path), u8):
            raise AssertionError(f"render {name}: the PNG does not read back equal")
    print(f"scene (b) render_mesh {cam.width}x{cam.height}, {len(faces)} faces, {len(views)} views "
          f"({TURNTABLE_VIEWS} turntable + the orbit's first): card median {np.median(view_ms):.2f} ms a view "
          f"(views {[round(x, 2) for x in view_ms]}); pixels equal to the CPU render: worst view {worst[0]:.6f} "
          f"({worst[1]} differ); each PNG round-trips through io/png (encode median {np.median(png_ms):.1f} ms) "
          f"on {card}", flush=True)
    out["render"] = dict(views=len(views), ms_per_view=float(np.median(view_ms)), view_ms=view_ms,
                         worst_equal_share=worst[0], worst_differing_pixels=worst[1], png_ms=float(np.median(png_ms)))

    # -- (c) planes: 30,000 sampled vertices in the scene's frame, kNN on the card, region growing --
    rng = np.random.default_rng(0)
    pick = rng.choice(len(v_host), min(PLANE_SAMPLES, len(v_host)), replace=False)
    T0 = poses[0]
    pts_world = (v_host[pick].astype(np.float64) @ T0[:3, :3].T + T0[:3, 3]).astype(np.float32)
    p = torch.from_numpy(pts_world).to(dev)
    (idx, _), knn_ms = timed(lambda: knn(p, p, torch.ones(len(p), dtype=torch.bool, device=dev), k=PLANE_KNN))
    patches, grow_ms = timed(lambda: detect_patches(p, idx, residual_threshold=0.02, min_points=PLANE_MIN_POINTS))
    found = planes_found(pts_world, patches, scene.plane.cpu().numpy().astype(np.float64))
    asked = [f for f in found if f["asked"]]
    if not (asked and all(f["ok"] for f in found)):
        raise AssertionError(f"planes: {found}")
    print(f"scene (c) detect_patches over {len(p)} sampled vertices, kNN k={PLANE_KNN} on the card "
          f"{knn_ms:.1f} ms, local fits on the card and region growing {grow_ms:.1f} ms: {len(patches)} patches "
          f"({[len(x.indices) for x in patches]}); scene planes: "
          + "; ".join(f"{f['plane']} support {f['support']}"
                      + (f", patch {f['patch']} at {f['angle_deg']:.3f} deg, offset {f['offset_m'] * 1e3:.2f} mm"
                         if f["asked"] else " (not asked)") for f in found) + f" on {card}", flush=True)
    out["planes"] = dict(samples=len(p), knn_ms=knn_ms, grow_ms=grow_ms, patches=len(patches), found=found)

    # -- (d) rooms: the divider case and the tool's two-room plan, card against CPU --
    lines = np.array([[0.0, 0.0, 0.0, 1.0]])
    arr = dcel.build_arrangement(lines, box_lo=(-2, -1), box_hi=(2, 1))
    wall = np.c_[np.zeros(100), np.linspace(-1, 1, 100)]
    labels = rooms.detect_rooms(arr, wall, num_rooms=2, device=dev)
    if not divider_split(labels, dcel.face_centroids(arr)):
        raise AssertionError(f"rooms: the divider case's labels {labels}")
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        plan_card = torch_room_detection.main(["--device", str(dev)])
        plan_cpu = torch_room_detection.main(["--device", "cpu"])
    lc, lh = plan_card["labels"], plan_cpu["labels"]
    if not (lc is not None and np.array_equal(lc, lh) and len(np.unique(lc)) == 2):
        raise AssertionError(f"rooms: the two-room plan's labels on the card {lc}, on the CPU {lh}")
    cents = dcel.face_centroids(plan_card["arrangement"])
    split = divider_split(lc, cents)
    print(f"scene (d) rooms: the divider case split at x = 0 on the card; the tool's two-room plan: "
          f"{plan_card['lines']} wall lines, {len(cents)} faces, 2 rooms, labels equal to the CPU's; split at the "
          f"divider: {split} (rooms' face centroids x: "
          + "; ".join(f"room {r}: {np.round(np.sort(cents[lc == r][:, 0]), 2).tolist()}" for r in np.unique(lc))
          + ")", flush=True)
    out["rooms"] = dict(divider_case=True, plan_faces=len(cents), plan_split_at_divider=split)

    # -- (e) clusters: clustering_demo's blobs, card against CPU from the same start --
    blobs = torch.from_numpy(torch_clustering_demo.synthetic_blobs(4, 0))
    init = clustering._initial_indices(torch.Generator().manual_seed(0), torch.ones(len(blobs), dtype=torch.bool),
                                       4, None)
    sizes = {}
    for method in ("kmeans", "kmedoids", "meanshift"):
        lab = [torch_clustering_demo.cluster(method, blobs.to(d), 4, 0.3, None, init) for d in (dev, "cpu")]
        if not np.array_equal(*lab):
            raise AssertionError(f"{method}: the card's labels differ from the CPU's")
        sizes[method] = np.bincount(lab[0][lab[0] >= 0]).tolist()
    print(f"scene (e) kmeans, kmedoids, mean shift on {len(blobs)} blob points: the card's labels equal the CPU's "
          f"(cluster sizes {sizes})", flush=True)
    out["clusters"] = sizes

    # -- (f) the slice's CLIs, started together, one card --
    orbit, fused_ply = str(Path(root) / "orbit"), str(Path(root) / "fused.ply")
    done, cli_s = run_clis([(name, [a.replace("ORBIT", orbit).replace("MESH", fused_ply) for a in extra])
                            for name, extra in SCENE_CLIS], root, SCENE_CLI_TIMEOUT_S)
    failed = [f"{name}: exit {rc}\n{o[-2000:]}\n{e[-4000:]}" for name, (rc, o, e) in done.items() if rc != 0]
    if failed:
        raise AssertionError("scene CLIs failed:\n" + "\n".join(failed))
    r = Path(root)
    outputs = {"tt_mesh": len(list((r / "tt_mesh").glob("turntable_*.png"))),
               "tt_fused": len(list((r / "tt_fused").glob("turntable_*.png")))}
    if not (outputs["tt_mesh"] == 4 and outputs["tt_fused"] == 24 and (r / "tt_mesh" / "turntable.gif").exists()
            and (r / "tt_fused" / "turntable.gif").exists() and (r / "qem.ply").exists()
            and "PASS" in done["torch_room_detection"][1]):
        raise AssertionError(f"scene CLIs: outputs {outputs}")
    print(f"scene (f) {len(done)} CLIs started together, all exit 0 in {cli_s:.1f} s: "
          + "; ".join(f"{name}: {o.strip().splitlines()[-1]}" for name, (_, o, _) in done.items()), flush=True)
    out["clis"] = dict(seconds=cli_s, exit_codes={name: rc for name, (rc, _, _) in done.items()})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14 took {out['seconds']:.1f} s; the script so far {time.perf_counter() - t_script:.1f} s",
          flush=True)
    out["launches"] = launches
    return out


PARALLEL_GLOO_WORLDS = (2, 4)  # one card: NCCL at world 1 only; gloo ranks sharing it at 2, 3 (submaps) and 4
SUBMAP_WORLD = 3  # the 150-frame loop in three submaps of 50 frames, one a rank
PARALLEL_TSDF_BLOCKS = 4096
PARALLEL_POSES = 64  # the pose-graph ring
PARALLEL_BA_TOL = 1e-4  # relative, phase 10's rule
PARALLEL_PG_TOL = 1e-5
SUBMAP_STAGE_TOL = 1e-4
SUBMAP_POSE_TOL_M = 1e-3
SUBMAP_CLOUD_CAPACITY = 16384  # DenseSlam compacts the loop's submap clouds (at most 13,321 points) to 16,384
PARALLEL_TIMEOUT_S = 300


def comm_line(stats: dict) -> str:
    """One rank's collectives: calls, bytes it put in, bytes staged through the host, ms."""
    return ", ".join(f"{name} {c['calls']}x {c['bytes']} B ({c['staged_bytes']} B staged) {c['ms']:.3f} ms"
                     for name, c in stats.items() if c["calls"]) or "none"


def parallel_inputs(cam, grays, depths, est, fused, orbit_ba) -> dict:
    """Phase 15's inputs, as host arrays: the orbit pair, 4,096 blocks in front
    of frame 0, phase 5's 16 filtered frames at its poses and pool settings,
    phase 10's orbit BA call in the per-point layout, the pose-graph ring."""
    from onepiece_tpu_torch.ops.image import bilateral_filter
    from onepiece_tpu_torch.optimization import bundle
    from onepiece_tpu_torch.parallel import ba as pba
    from onepiece_tpu_torch.parallel import drive
    from onepiece_tpu_torch.systems import fused_slam

    def host(t):
        return t.cpu().numpy()

    poses, points, frame, point, uv, valid, lam, intr = orbit_ba[:8]
    v = host(valid)
    obs = bundle.build_observations(host(frame)[v], host(point)[v], host(uv)[v], points.shape[0])
    frame_pp, uv_pp, mask_pp = pba.per_point_layout(obs, points.shape[0])
    return dict(
        camera=cam,
        dense=dict(src_gray=host(grays[0]), src_depth=host(depths[0]), tgt_gray=host(grays[1]),
                   tgt_depth=host(depths[1])),
        tsdf=drive.tsdf_inputs(cam, host(depths[0]), PARALLEL_TSDF_BLOCKS),
        fused=dict(depths=host(torch.stack([bilateral_filter(d) for d in depths])), grays=host(grays),
                   poses=est.astype(np.float32), capacity=fused.capacity, table_size=fused.table_size,
                   voxel_size=fused.voxel_size, truncation=fused.truncation, kmax=fused.kmax, stride=fused.stride,
                   claim_rounds=(fused_slam.INIT_CLAIM_ROUNDS, fused_slam.FRAME_CLAIM_ROUNDS)),
        ba=dict(poses=host(poses), points=host(points), frame_pp=frame_pp, uv_pp=uv_pp, mask_pp=mask_pp,
                lam=float(lam), intr=tuple(float(x) for x in intr)),
        posegraph=drive.ring_posegraph(PARALLEL_POSES),
    )


def check_world(world: int, ranks: list, ref: dict, n_frames: int, n_iters: int) -> list:
    """Phase 15's bars for one world's ranks against world 1's rank 0 (`ref`);
    returns the lines to print."""
    r0 = ranks[0]
    for r, got in enumerate(ranks):
        if float(got["psum"]["value"][0]) != world * (world + 1) / 2:
            raise AssertionError(f"world {world} rank {r}: psum {got['psum']['value']}")
        for name, key in (("dense", "T"), ("ba", "poses"), ("posegraph", "poses")):
            if not np.array_equal(got[name][key], r0[name][key]):
                raise AssertionError(f"world {world}: rank {r}'s {name} {key} differs from rank 0's")
        want = {"dense": {"dense_normal_eq": n_iters}, "fused": {"tsdf_integrate": n_frames},
                "ba": {"ba_schur": 2},
                "mc": {"marching_cubes": (got["mc"]["blocks_here"] > 0) + (got["mc"]["blocks_here_after"] > 0)}}
        for name, counts in want.items():
            for k, n in counts.items():
                if got[name]["launches"][k] != n:
                    raise AssertionError(f"world {world} rank {r} {name}: {k} launches "
                                         f"{got[name]['launches'][k]}, expected {n}")
        if got["fused"]["table_digest"] != r0["fused"]["table_digest"]:
            raise AssertionError(f"world {world}: rank {r}'s hash table differs from rank 0's")
    dT = float(np.abs(r0["dense"]["T"] - ref["dense"]["T"]).max())
    if not (dT <= GN_STEP_TOL and r0["dense"]["inliers"] == ref["dense"]["inliers"]):
        raise AssertionError(f"world {world} dense: max |dT| {dT} (<= {GN_STEP_TOL}), inliers "
                             f"{r0['dense']['inliers']} vs {ref['dense']['inliers']}")
    if r0["tsdf"]["digest"] != ref["tsdf"]["digest"]:
        raise AssertionError(f"world {world} tsdf: blocks differ from world 1's")
    f, f1 = r0["fused"], ref["fused"]
    if (f["pool_digest"], f["table_digest"]) != (f1["pool_digest"], f1["table_digest"]):
        raise AssertionError(f"world {world} fused: the gathered pool or the table differs from world 1's")
    m, m1 = r0["mc"], ref["mc"]
    if not (m["digest"] == m1["digest"] and m["sorted_digest_after"] == m1["sorted_digest"]
            and m["num_active_after"] == f1["num_active"] and m["overflow_after"] == 0):
        raise AssertionError(f"world {world} mc: triangles {m['triangles']} / after migration "
                             f"{m['triangles_after']} against {m1['triangles']}, equal in order "
                             f"{m['digest'] == m1['digest']}, as a set after migration "
                             f"{m['sorted_digest_after'] == m1['sorted_digest']}, num_active "
                             f"{m['num_active_after']}, overflow {m['overflow_after']}")
    ba_err = max(float(np.abs(r0["ba"][k] - ref["ba"][k]).max() / np.abs(ref["ba"][k]).max())
                 for k in ("poses", "points"))
    if not ba_err <= PARALLEL_BA_TOL:
        raise AssertionError(f"world {world} ba: rel err {ba_err} > {PARALLEL_BA_TOL}")
    pg_err = float(np.abs(r0["posegraph"]["poses"] - ref["posegraph"]["poses"]).max())
    if not pg_err <= PARALLEL_PG_TOL:
        raise AssertionError(f"world {world} posegraph: max err {pg_err} > {PARALLEL_PG_TOL}")
    return [
        f"dense: max |T - T(world 1)| {dT:.3g}, inliers {int(r0['dense']['inliers'])} equal",
        f"tsdf: {r0['tsdf']['updated']} voxels updated, bit-equal to world 1",
        f"fused: pool and table bit-equal to world 1, num_active {f['num_active']}, overflow {f['overflow']}, "
        f"key_saturated_frames {f['key_saturated_frames']}, kmax {f['kmax']}, {n_frames} TSDF launches a rank",
        f"mc: {m['triangles']} triangles bit-equal in order to world 1; after migration {m['triangles_after']}, "
        f"equal as a sorted set, num_active {m['num_active_after']}, overflow 0, blocks a rank "
        f"{[g['mc']['blocks_here'] for g in ranks]} -> {[g['mc']['blocks_here_after'] for g in ranks]}",
        f"ba: rel err {ba_err:.3g} against world 1, 2 ba_schur launches a rank",
        f"posegraph: max err {pg_err:.3g} against world 1, ranks bit-identical",
    ]


def world1_against_unsharded(cam, dev, grays, depths, fused, orbit_ba, ref: dict) -> list:
    """Phase 15's world 1 against paths that share no code with `parallel/`:
    the unsharded tracker on the card (the GN kernel with the update on),
    the marching-cubes kernel on phase 5's whole pool (`to_volume`, as phase
    8 meshes it), and the plain BA step on the CPU with U damped inside the
    unsharded reduction (`reduced_system_reference`, the damping the
    kernel's `undamped_u` and `parallel/ba`'s damping after the psum stand
    in for), by the 2-D model's rule: within PARALLEL_BA_TOL of the float32
    plain step, or against the float64 step within 2x the float32 plain
    step's error. Returns the lines to print."""
    from onepiece_tpu_torch.geometry import se3
    from onepiece_tpu_torch.integration.blocks import neighbor_slots_device
    from onepiece_tpu_torch.odometry import dense
    from onepiece_tpu_torch.ops import ba_schur
    from onepiece_tpu_torch.ops import marching_cubes as mc
    from onepiece_tpu_torch.parallel import drive

    solo = dense.dense_tracking(dense.preprocess_frame(grays[0], depths[0], cam),
                                dense.preprocess_frame(grays[1], depths[1], cam), cam)
    dT = float(np.abs(ref["dense"]["T"] - solo.T_ts.cpu().numpy()).max())
    if not dT <= GN_STEP_TOL:
        raise AssertionError(f"phase 15 world 1 dense: max |T - T(dense_tracking)| {dT} > {GN_STEP_TOL}")

    vol = fused.to_volume()
    coords = torch.from_numpy(vol.active_coords()).to(dev, torch.int32)
    verts, colors = mc.extract_triangles(vol.vox, torch.arange(vol.num_active, dtype=torch.int32, device=dev),
                                         neighbor_slots_device(coords), coords, vol.voxel_size)
    if drive.digest(torch.stack([verts, colors], 1)) != ref["mc"]["digest"]:
        raise AssertionError(f"phase 15 world 1 mc: {ref['mc']['triangles']} triangles, the unsharded extraction "
                             f"of phase 5's pool {verts.shape[0]}, not bit-equal in order")

    poses, points, frame, point, uv, valid, lam, intr = orbit_ba[:8]
    step = {}
    for dt in (torch.float32, torch.float64):
        P, X = poses.to(dt), points.to(dt)
        system = ba_schur.reduced_system_reference(P, X, frame, point, uv.to(dt), valid,
                                                   torch.as_tensor(float(lam), dtype=dt),
                                                   tuple(float(x) for x in intr))
        n6 = 6 * P.shape[0]
        L, _ = torch.linalg.cholesky_ex(system.S[6:, 6:] + 1e-9 * torch.eye(n6 - 6, dtype=dt))
        dc = torch.cat([torch.zeros(6, dtype=dt), torch.cholesky_solve(-system.rhs_c[6:, None], L)[:, 0]])
        step[dt] = dict(poses=se3.se3_exp(dc.reshape(-1, 6)) @ P,
                        points=X + ba_schur.back_substitute_reference(system, dc, frame, point))

    def rel(x: dict, y: dict) -> float:
        return max(float((x[k].double() - y[k].double()).abs().max() / y[k].double().abs().max())
                   for k in ("poses", "points"))

    world = {k: torch.from_numpy(ref["ba"][k]) for k in ("poses", "points")}
    ba_err = rel(world, step[torch.float32])
    vs64 = dict(world1=rel(world, step[torch.float64]), plain=rel(step[torch.float32], step[torch.float64]))
    # the 2-D model's rule (phase 13, the card tests): within the tolerance of
    # the float32 plain step, or, where float32 is only as accurate as its
    # rounding, within 2x the float32 plain step's error against float64
    if not (ba_err <= PARALLEL_BA_TOL or vs64["world1"] <= 2 * vs64["plain"]):
        raise AssertionError(f"phase 15 world 1 ba: rel err {ba_err} against the plain unsharded step (<= "
                             f"{PARALLEL_BA_TOL}), against float64 {vs64} (world 1 <= 2x the float32 plain step)")
    return [f"dense: max |T - T(dense_tracking)| {dT:.3g}, inliers {int(ref['dense']['inliers'])} "
            f"(dense_tracking {int(solo.num_inliers)})",
            f"mc: {ref['mc']['triangles']} triangles bit-equal in order to the unsharded extraction of phase 5's pool",
            f"ba: rel err against the plain unsharded step {ba_err:.3g}; against the float64 step: world 1 "
            f"{vs64['world1']:.3g}, the float32 plain step {vs64['plain']:.3g}"]


def parallel_phase(cam, dev, card, grays, depths, est, fused, s_grays, s_depths, slam_gt, orbit_ba,
                   root: str, t_script: float) -> dict:
    """Phase 15: `parallel/` across ranks on the card. Every module at worlds
    1 (NCCL), 2 and 4 (gloo ranks sharing the card, collectives staged
    through host memory), each held to world 1; the submap pipeline at world
    3 held to its serial run on the card. Returns the kernels' launches over
    every rank of every world and the serial run."""
    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.io import trajectory as traj
    from onepiece_tpu_torch.odometry import dense
    from onepiece_tpu_torch.parallel import drive, launch
    from onepiece_tpu_torch.parallel import submap as psubmap
    from onepiece_tpu_torch.registration import icp

    t_phase = time.perf_counter()
    inp = parallel_inputs(cam, grays, depths, est, fused, orbit_ba)
    n_iters = sum(dense.DEFAULT_ITERS)
    total = {k.name: 0 for k in _build.KERNELS}
    st = fused._state

    # -- the submap pipeline's frames (read by the ranks from .npy files) and its serial run on the card --
    h, w = cam.height, cam.width
    sg = s_grays.cpu().numpy().reshape(SUBMAP_WORLD, -1, h, w)
    sd = s_depths.cpu().numpy().reshape(SUBMAP_WORLD, -1, h, w)
    paths = {}
    for name, a in (("grays", sg), ("depths", sd)):
        paths[name] = str(Path(root) / f"submap_{name}.npy")
        np.save(paths[name], a)
    kw = dict(cloud_capacity=SUBMAP_CLOUD_CAPACITY)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    ser = psubmap.submap_pipeline_serial(sg, sd, cam, dev, **kw)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t
    ser_launches = {k.name: k.launches for k in _build.KERNELS}

    # -- world 1 over NCCL; worlds 2 and 4, and the submap pipeline at 3, in one set of 4 gloo ranks --
    t = time.perf_counter()
    runs = {1: launch.spawn(1, drive.run_modules, inp, drive.MODULES, False, backend="nccl", device="cuda",
                            timeout=PARALLEL_TIMEOUT_S)}
    spawn_s = {"nccl": time.perf_counter() - t}
    t = time.perf_counter()
    gloo = launch.spawn(max(PARALLEL_GLOO_WORLDS), drive.run_worlds, inp, PARALLEL_GLOO_WORLDS,
                        dict(camera=cam, kwargs=kw, **paths), SUBMAP_WORLD, backend="gloo", device="cuda",
                        timeout=PARALLEL_TIMEOUT_S)
    spawn_s["gloo"] = time.perf_counter() - t
    for world in PARALLEL_GLOO_WORLDS:
        runs[world] = [r["modules"][world] for r in gloo if world in r["modules"]]
    runs[SUBMAP_WORLD] = [r["submap"] for r in gloo if "submap" in r]
    for world, ranks in runs.items():
        for rank in ranks:
            for res in (rank.values() if world != SUBMAP_WORLD else [rank]):
                for k, n in res["launches"].items():
                    total[k] += n
    ref = runs[1][0]
    # world 1 is the unsharded fused loop of phase 5: the same pool and table, bit for bit
    if (ref["fused"]["pool_digest"], ref["fused"]["table_digest"]) != (
            drive.digest(st.vox[:-1]), drive.digest(torch.cat([t.reshape(-1) for t in st.table]))):
        raise AssertionError("phase 15 fused, world 1: the pool or table differs from phase 5's FusedDenseFusion")
    world1 = world1_against_unsharded(cam, dev, grays, depths, fused, orbit_ba, ref)
    seconds = {}
    for world in (1, *PARALLEL_GLOO_WORLDS):
        backend = "nccl" if world == 1 else "gloo"
        seconds[world] = sum(res["seconds"] for res in runs[world][0].values())
        lines = check_world(world, runs[world], ref, len(grays), n_iters) if world > 1 else [
            *world1, "fused: pool and table bit-equal to phase 5's FusedDenseFusion, num_active "
            f"{ref['fused']['num_active']}"]
        print(f"phase 15 world {world} ({backend}{', collectives staged through the host' if backend == 'gloo' else ''}"
              f"): the modules {seconds[world]:.2f} s on rank 0; " + "; ".join(lines), flush=True)
        for name, res in runs[world][0].items():
            print(f"phase 15 world {world} {name}: {res['seconds'] * 1e3:.1f} ms on rank 0; collectives of rank 0: "
                  f"{comm_line(res['comm'])}", flush=True)

    # -- the submap pipeline: sharded (one submap a rank) against serial --
    sh = runs[SUBMAP_WORLD]
    seconds[SUBMAP_WORLD] = sh[0]["seconds"]
    f = sg.shape[1]
    icp_calls = [int(r > 0) + max(r - 1, 0) for r in range(SUBMAP_WORLD)]
    for r, rank in enumerate(sh):
        want = (n_iters * (f - 1 + int(r > 0)), (icp.DEFAULT_ITERS + 1) * icp_calls[r])
        got = (rank["launches"]["dense_normal_eq"], rank["launches"]["nn1"])
        if got != want:
            raise AssertionError(f"phase 15 submap rank {r}: (dense_normal_eq, nn1) launches {got}, expected {want}")
        if not np.array_equal(rank["out"]["frame_poses"], sh[0]["out"]["frame_poses"]):
            raise AssertionError("phase 15 submap: the ranks' trajectories differ")
    for k, n in ser_launches.items():
        total[k] += n
    if ser_launches["nn1"] != sum(r["launches"]["nn1"] for r in sh):
        raise AssertionError(f"phase 15 submap: serial nn1 launches {ser_launches['nn1']} != the ranks' sum")
    o = sh[0]["out"]
    both = o["geos"].valid & ser.geos.valid.cpu().numpy()
    if not np.array_equal(o["geos"].valid, ser.geos.valid.cpu().numpy()):
        raise AssertionError("phase 15 submap: the clouds' valid masks differ from the serial run's")
    cloud_err = float(np.abs(o["geos"].points - ser.geos.points.cpu().numpy())[both].max())
    ev = o["edges"].valid
    if not np.array_equal(ev, ser.edges.valid.cpu().numpy()):
        raise AssertionError(f"phase 15 submap: edges {ev} against the serial run's {ser.edges.valid}")
    edge_err = float(np.abs(o["edges"].T - ser.edges.T.cpu().numpy())[ev].max()) if ev.any() else 0.0
    base_err = float(np.abs(o["base_raw"] - ser.base_raw).max())
    pose_err = float(np.abs(o["frame_poses"][:, :3, 3] - ser.frame_poses[:, :3, 3]).max())
    bit_equal = all(np.array_equal(a, b) for a, b in ((o["frame_poses"], ser.frame_poses),
                                                     (o["geos"].points, ser.geos.points.cpu().numpy()),
                                                     (o["edges"].T, ser.edges.T.cpu().numpy())))
    if not (max(cloud_err, edge_err, base_err) <= SUBMAP_STAGE_TOL and pose_err <= SUBMAP_POSE_TOL_M):
        raise AssertionError(f"phase 15 submap: clouds {cloud_err}, edges {edge_err}, base poses {base_err} "
                             f"(<= {SUBMAP_STAGE_TOL}); frame positions {pose_err} m (<= {SUBMAP_POSE_TOL_M})")
    ate_ser, ate_sh = traj.ate_rmse(ser.frame_poses, slam_gt), traj.ate_rmse(o["frame_poses"], slam_gt)
    print(f"phase 15 submap pipeline, {SUBMAP_WORLD} submaps x {f} frames of the 640x480 loop: serial on the card "
          f"{serial_s:.2f} s, sharded over {SUBMAP_WORLD} gloo ranks {sh[0]['seconds']:.2f} s on rank 0; sharded "
          f"against serial: bit-equal {bit_equal}, largest differences clouds {cloud_err:.3g}, edges {edge_err:.3g}, "
          f"odometry base poses {base_err:.3g}, frame positions {pose_err:.3g} m; edges valid {ev.tolist()}; ATE "
          f"serial {ate_ser * 1e3:.4f} mm, sharded {ate_sh * 1e3:.4f} mm; launches a rank (dense_normal_eq, nn1) "
          f"{[(r['launches']['dense_normal_eq'], r['launches']['nn1']) for r in sh]}, serial "
          f"{(ser_launches['dense_normal_eq'], ser_launches['nn1'])}; collectives of rank 0: "
          f"{comm_line(sh[0]['comm'])} on {card}", flush=True)
    print(f"phase 15 spawns, the ranks' start included: NCCL world 1 {spawn_s['nccl']:.1f} s, the 4 gloo ranks "
          f"(worlds {', '.join(map(str, PARALLEL_GLOO_WORLDS))} and the submap world {SUBMAP_WORLD}) "
          f"{spawn_s['gloo']:.1f} s", flush=True)
    out = dict(launches=total, seconds=time.perf_counter() - t_phase, world_seconds=seconds, spawn_seconds=spawn_s,
               submap=dict(bit_equal=bit_equal, pose_err_m=pose_err, ate_m=ate_sh))
    print(f"phase 15 took {out['seconds']:.1f} s (the modules of rank 0 a world: "
          f"{', '.join(f'{w}: {s:.2f} s' for w, s in seconds.items())}); "
          f"the script so far {time.perf_counter() - t_script:.1f} s", flush=True)
    return out


SCANNET_UNTRACKED = 7  # the fixture frame whose pose is written as -inf, as ScanNet marks a lost frame
SCANNET_VOXEL = 0.02  # tools/scannet_model.py's default voxel (truncation 5 voxels)
SCANNET_RENDER_STEPS = 96  # the fixture's colour frames were rendered with 96 steps (its manifest)
SCANNET_BLOCKS_TOL = 0.01  # card against CPU, the card tests' TSDFVolume rule: blocks within 1 %,
SCANNET_TRIANGLES_TOL = 0.02  # triangles within 2 %, the card's pool meshed by the plain version bit-equal
SCANNET_VOXEL_BAND = (5e-4, 5e-3, 1e-4)  # card pool against the CPU pool voxel by voxel, test_torch_scannet's rule:
# weights equal, sdf within 5e-4, colour within 5e-3, at most 1e-4 of the seen voxels outside
SCANNET_GT_TOL = 1e-6  # groundtruth.txt's translation and quaternion against the poses
SCANNET_CLI_ARGS = ("--stride", "1")
SCANNET_CLI_TIMEOUT_S = 300


def pool_band(a, b, sdf_tol: float, color_tol: float) -> tuple[int, int, float, float]:
    """Two TSDFVolumes' pools voxel by voxel, blocks matched by key through
    `slot_of`; a block in one pool only is held against empty voxels. Of the
    voxels seen (weight > 0) in either: (how many lie outside the band --
    weights differ, sdf beyond `sdf_tol` or a colour channel beyond
    `color_tol` --, how many are seen, the largest sdf and colour
    differences where both saw the voxel)."""
    keys = sorted(set(a.slot_of) | set(b.slot_of))

    def fields(vol):
        slots = torch.tensor([vol.slot_of.get(k, -1) for k in keys])
        have = (slots >= 0).numpy()[:, None]
        rows = slots.clamp(min=0)
        sdf, w, color = (f.cpu()[rows].reshape(len(keys), 512, -1).numpy() for f in (vol.sdf, vol.weight, vol.color))
        return sdf[..., 0], np.where(have, w[..., 0], 0.0), color

    (sa, wa, ca), (sb, wb, cb) = fields(a), fields(b)
    seen, both = (wa > 0) | (wb > 0), (wa > 0) & (wb > 0)
    ds, dc = np.abs(sa - sb), np.abs(ca - cb).max(-1)
    outside = seen & ((wa != wb) | (ds > sdf_tol) | (dc > color_tol))
    return (int(outside.sum()), int(seen.sum()), float(ds[both].max(initial=0.0)),
            float(dc[both].max(initial=0.0)))


def scannet_phase(dev, card, scene, root: str, t_script: float) -> dict:
    """Phase 16: the ScanNet input path on the committed synthetic export
    (`tests/data/scannet_synth/`: 8 colour JPEGs at 1296x968 and their
    manifest of cv2's results), its 640x480 depth rendered here at the
    fixture's poses and written as 16-bit PGM, frame 7's pose -inf. (a) the
    JPEG decoder and (b) the remap onto the depth grid against cv2's hashes;
    (c) `tools/torch_scannet_model.reconstruct` with the launch counts at 0
    (TSDF kernel once a frame, marching cubes once), against its CPU run,
    the mesh against the scene, the CLI as a subprocess; (d) the TUM
    converter read back by `TumSequence`. Prints ms a frame of each host
    stage and of bilateral + integrate, and the time to a mesh."""
    from scipy.spatial.transform import Rotation

    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.integration.blocks import TSDFVolume, neighbor_slots_device
    from onepiece_tpu_torch.io import jpeg, pgm
    from onepiece_tpu_torch.io import scannet as scannet_io
    from onepiece_tpu_torch.io.ply import read_ply
    from onepiece_tpu_torch.io.tum import TumSequence
    from onepiece_tpu_torch.ops import marching_cubes as mc
    from onepiece_tpu_torch.ops import tsdf as tsdf_ops
    from onepiece_tpu_torch.ops.image import bilateral_filter
    from onepiece_tpu_torch.utils import synthetic

    tools = Path(__file__).resolve().parent / "tools"
    sys.path.insert(0, str(tools))
    import torch_make_scannet_fixture as fixture
    import torch_scannet_model
    import torch_scannet_to_tum
    from _torch_common import write_mesh

    t_phase = time.perf_counter()
    zero = {k.name: 0 for k in _build.KERNELS}
    manifest = json.loads((Path(fixture.FIXTURE_DIR) / "manifest.json").read_text())
    ccam, dcam = fixture.COLOR_CAMERA, fixture.DEPTH_CAMERA
    for name, c in (("color", ccam), ("depth", dcam)):
        if manifest["cameras"][name] != {k: getattr(c, k) for k in manifest["cameras"][name]}:
            raise AssertionError(f"scannet: the manifest's {name} camera is not the fixture tool's")
    poses = np.asarray(manifest["poses"], np.float32)
    n = len(poses)
    depths = np.stack([
        synthetic.render(scene, torch.from_numpy(p).to(dev), dcam.fx, dcam.fy, dcam.cx, dcam.cy, dcam.height,
                         dcam.width, num_steps=SCANNET_RENDER_STEPS)[0].cpu().numpy()
        for p in poses
    ])
    jpegs = [(Path(fixture.FIXTURE_DIR) / f["file"]).read_bytes() for f in manifest["frames"]]
    export = os.path.join(root, "scannet_synth")
    fixture.write_export(export, depths, poses, ccam, dcam, jpegs, untracked=(SCANNET_UNTRACKED,))

    # -- (a) the decoder and (b) the remap against cv2's hashes; host ms a frame --
    host_ms = {"jpeg decode": [], "pgm read": [], "align": []}
    aligned, pgms = [], []
    for i, (f, data) in enumerate(zip(manifest["frames"], jpegs)):
        t = time.perf_counter()
        img = jpeg.decode(data)
        host_ms["jpeg decode"].append((time.perf_counter() - t) * 1e3)
        if fixture.sha256(img) != f["decode_sha256"]:
            raise AssertionError(f"scannet (a) frame {i}: the decode is not cv2's ({f['file']})")
        t = time.perf_counter()
        pgms.append(pgm.read_pgm(os.path.join(export, f"frame-{i:06d}.depth.pgm")))
        host_ms["pgm read"].append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        aligned.append(scannet_io.align_color_to_depth(img, ccam, dcam))
        host_ms["align"].append((time.perf_counter() - t) * 1e3)
        if fixture.sha256(aligned[-1]) != f["remap_sha256"]:
            raise AssertionError(f"scannet (b) frame {i}: the remap is not cv2's")
    print(f"scannet (a) {n} JPEGs {ccam.width}x{ccam.height} 4:2:0 decoded bit-equal to cv2's decode "
          f"(SHA-256 of the manifest); (b) aligned to {dcam.width}x{dcam.height} bit-equal to cv2.remap's", flush=True)

    # -- (c) the reconstruction on the card, launches counted, against its CPU run --
    used_frames = n - 1
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    vol, used = torch_scannet_model.reconstruct(export, SCANNET_VOXEL, 1, device=dev, log=lambda s: None)
    torch.cuda.synchronize()
    reconstruct_s = time.perf_counter() - t
    counted({**zero, "tsdf_integrate": used_frames}, "phase 16 integrate")
    ply = os.path.join(root, "scannet_model.ply")
    nv, nf, mesh_s = write_mesh(vol, ply)
    launches = counted({**zero, "tsdf_integrate": used_frames, "marching_cubes": 1}, "phase 16 ScanNet path")
    if used != used_frames:
        raise AssertionError(f"scannet (c): {used} frames integrated, expected {used_frames} (frame "
                             f"{SCANNET_UNTRACKED}'s -inf pose skipped)")
    vol_c, used_c = torch_scannet_model.reconstruct(export, SCANNET_VOXEL, 1, device="cpu", log=lambda s: None)
    tv_k, tc_k = vol.extract_mesh()
    tv_c, _ = vol_c.extract_mesh()
    na = vol.num_active
    coords = torch.from_numpy(vol.active_coords()).int()
    vp, cp = mc.extract_triangles_reference(vol.vox.cpu(), torch.arange(na, dtype=torch.int32),
                                            neighbor_slots_device(coords), coords, vol.voxel_size)
    sdf_tol, color_tol, share = SCANNET_VOXEL_BAND
    outside, seen, sdf_err, color_err = pool_band(vol, vol_c, sdf_tol, color_tol)
    if not (used_c == used and abs(na - vol_c.num_active) <= SCANNET_BLOCKS_TOL * vol_c.num_active
            and abs(len(tv_k) - len(tv_c)) <= SCANNET_TRIANGLES_TOL * len(tv_c)
            and seen > 10000 and outside <= share * seen
            and np.array_equal(tv_k, vp.numpy()) and np.array_equal(tc_k, cp.numpy())):
        raise AssertionError(f"scannet (c) card against CPU: blocks {na} / {vol_c.num_active}, triangles "
                             f"{len(tv_k)} / {len(tv_c)}, voxels outside the band {outside} of {seen} seen (sdf "
                             f"{sdf_err:.3g}, colour {color_err:.3g}), the card's pool meshed by the plain version "
                             f"equal: {np.array_equal(tv_k, vp.numpy()) and np.array_equal(tc_k, cp.numpy())}")
    mesh = read_ply(ply)
    med, p90 = scene_distance(scene, mesh["vertices"], np.eye(4, dtype=np.float32), dev)
    if not (nf > 0 and len(mesh["faces"]) == nf and np.isfinite(mesh["vertices"]).all() and med <= SCANNET_VOXEL):
        raise AssertionError(f"scannet (c): mesh of {nf} faces ({len(mesh['faces'])} in the PLY), scene distance "
                             f"median {med} m > one voxel {SCANNET_VOXEL} m?")
    print(f"scannet (c) reconstruct on the card, stride 1: {used} of {n} frames integrated (frame "
          f"{SCANNET_UNTRACKED}'s -inf pose skipped), {na} blocks, key_saturated_frames "
          f"{vol.key_saturated_frames} (max_blocks {vol.max_blocks}), launches {launches}; {reconstruct_s:.3f} s "
          f"with the reads; mesh {nv} vertices {nf} faces in {mesh_s * 1e3:.1f} ms (marching cubes, dedup on the "
          f"card, PLY); against device=\"cpu\": blocks {vol_c.num_active}, triangles {len(tv_k)} / {len(tv_c)} "
          f"(within {SCANNET_BLOCKS_TOL:.0%} / {SCANNET_TRIANGLES_TOL:.0%}), voxels outside the band {outside} of "
          f"{seen} seen (weights equal, sdf within {sdf_tol:g}: largest {sdf_err:.3g}, colour within {color_tol:g}: "
          f"largest {color_err:.3g}; at most {share:g} of them), the card's pool meshed by the plain "
          f"version bit-equal to the kernel's mesh; scene_distance median {med * 1e3:.3f} mm, p90 "
          f"{p90 * 1e3:.3f} mm (voxel {SCANNET_VOXEL * 1e3:.0f} mm)", flush=True)

    # bilateral + integrate a frame, frames preloaded; the key pass's read-back and the neighbour slots
    seq = scannet_io.ScanNetSequence(export)
    frames = [seq[i] for i in range(n) if i != SCANNET_UNTRACKED]
    scale = torch.tensor(255.0, device=dev)
    up = [(torch.from_numpy(d).to(dev), torch.from_numpy(c).to(dev).float() / scale, p.astype(np.float32))
          for _, c, d, p in frames]
    timed_vol = TSDFVolume(voxel_size=SCANNET_VOXEL, truncation=SCANNET_VOXEL * 5, device=dev)
    integrate_ms, bilateral_ms, keys_ms = [], [], []
    for d, c, p in up:
        torch.cuda.synchronize()
        t = time.perf_counter()
        d_f = bilateral_filter(d)
        torch.cuda.synchronize()
        bilateral_ms.append((time.perf_counter() - t) * 1e3)
        timed_vol.integrate(d_f, c, p, seq.camera)
        torch.cuda.synchronize()
        integrate_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        tsdf_ops.touched_block_keys(d, torch.from_numpy(p).to(dev), dcam.fx, dcam.fy, dcam.cx, dcam.cy,
                                    SCANNET_VOXEL, SCANNET_VOXEL * 5, max_blocks=timed_vol.max_blocks).cpu()
        keys_ms.append((time.perf_counter() - t) * 1e3)
    coords_dev = torch.from_numpy(vol.active_coords()).to(dev, torch.int32)
    nbr_ms = cuda_ms(lambda: neighbor_slots_device(coords_dev), reps=10)
    t = time.perf_counter()
    vol._neighbor_slots()
    nbr_host_ms = (time.perf_counter() - t) * 1e3
    stage = {k: float(np.median(v)) for k, v in host_ms.items()}
    print(f"scannet ms a frame (median of {n}): " + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
          + f"; bilateral + integrate {np.median(integrate_ms):.3f} (median of {len(integrate_ms)}, frames on the "
          f"card; of it the bilateral filter {np.median(bilateral_ms):.3f}, the key pass and its read-back "
          f"{np.median(keys_ms):.3f}, the rest the host's allocation and slot lists and the kernel); neighbour "
          f"slots of {na} blocks "
          f"on the card {nbr_ms:.3f} ms (the host dict loop, off the path: {nbr_host_ms:.1f} ms); time to a mesh "
          f"{mesh_s * 1e3:.1f} ms on {card}", flush=True)

    # -- the CLI as a subprocess --
    done, cli_s = run_clis([("torch_scannet_model", [export, os.path.join(root, "scannet_cli.ply"),
                                                     *SCANNET_CLI_ARGS])], root, SCANNET_CLI_TIMEOUT_S)
    rc, stdout, stderr = done["torch_scannet_model"]
    cli_mesh = read_ply(os.path.join(root, "scannet_cli.ply")) if rc == 0 else None
    if rc != 0 or not len(cli_mesh["faces"]):
        raise AssertionError(f"scannet (c) torch_scannet_model exit {rc}:\n{stdout[-2000:]}\n{stderr[-2000:]}")
    print(f"scannet (c) tools/torch_scannet_model.py {' '.join(SCANNET_CLI_ARGS)} as a subprocess: exit 0 in "
          f"{cli_s:.1f} s, PLY of {len(cli_mesh['faces'])} faces read back", flush=True)

    # -- (d) the TUM converter, read back --
    tum = os.path.join(root, "scannet_tum")
    if torch_scannet_to_tum.main([export, tum, "--max-frames", str(used_frames)]) != 0:
        raise AssertionError("scannet (d): torch_scannet_to_tum failed")
    back = TumSequence(tum)
    if len(back) != used_frames:
        raise AssertionError(f"scannet (d): {len(back)} frames read back, expected {used_frames}")
    for i in range(used_frames):
        _, rgb, depth = back[i]
        d16 = np.clip(pgms[i].astype(np.float32) / dcam.depth_scale * 5000.0, 0, 65535).astype(np.uint16)
        if not (np.array_equal(depth, d16.astype(np.float32) / 5000.0) and np.array_equal(rgb, aligned[i])):
            raise AssertionError(f"scannet (d) frame {i}: depth or colour differs from the formula / the aligned decode")
    gt = [line.split() for line in Path(tum, "groundtruth.txt").read_text().splitlines()[1:]]
    gt_err = max(max(np.abs(np.array(g[1:4], float) - poses[i][:3, 3]).max(),
                     np.abs(np.array(g[4:], float)
                            - Rotation.from_matrix(poses[i][:3, :3].astype(np.float64)).as_quat()).max())
                 for i, g in enumerate(gt))
    if not (len(gt) == used_frames and gt_err <= SCANNET_GT_TOL):
        raise AssertionError(f"scannet (d): groundtruth.txt {len(gt)} lines, max error {gt_err} > {SCANNET_GT_TOL}")
    print(f"scannet (d) torch_scannet_to_tum --max-frames {used_frames}: TumSequence reads {used_frames} frames, "
          f"depth equal to the float32 formula on the PGMs, colour equal to the aligned decode, groundtruth.txt "
          f"within {gt_err:.2g} of the poses", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 16 (ScanNet) took {phase_s:.1f} s ({time.perf_counter() - t_script:.1f} s into the run)",
          flush=True)
    return dict(launches=launches, voxels=dict(outside=outside, seen=seen, sdf_err=sdf_err, color_err=color_err),
                host_ms=stage, integrate_ms=float(np.median(integrate_ms)),
                bilateral_ms=float(np.median(bilateral_ms)), keys_ms=float(np.median(keys_ms)),
                mesh_ms=mesh_s * 1e3, seconds=phase_s)


def main() -> int:
    # ---- 1. the card ------------------------------------------------------
    t_script = time.perf_counter()
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
        if form == "gray":
            fused_est = est  # phase 15 fuses these poses again, sharded
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

    # ---- 11. real input and state: the orbit from disk, checkpoint and resume, the dataset CLIs ----
    # ---- 12. the prefetch ring, the fused loop from disk, the long run, the tools ----
    # ---- 13. the host-loop systems, MILD's host half, the tool CLIs (phase 11's folder) ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tum_") as root:
        disk_phase(cam, dev, card, poses, grays, depths, root)
        phase12 = real_input_phase(cam, dev, card, slice_slams, root)
        phase13 = host_loop_phase(cam, dev, card, poses, grays, depths, phase9, root, t_script)
        # ---- 14. scene analysis and visualisation on the fused orbit's mesh, the slice's CLIs ----
        phase14 = scene_phase(cam, dev, card, scene, poses, slice_slams["gray"], root, t_script)
        # ---- 15. parallel/ across ranks: NCCL at world 1, gloo ranks sharing the card at 2, 3 and 4 ----
        phase15 = parallel_phase(cam, dev, card, grays, depths, fused_est, slice_slams["gray"], s_grays, s_depths,
                                 slam_gt, phase10["orbit_ba"], root, t_script)
        # ---- 16. ScanNet input: the JPEG decoder, the remap, the reconstruction and the converter ----
        phase16 = scannet_phase(dev, card, scene, root, t_script)
    results["ba_schur"].update({f"ba_test_2d_{k}": v for k, v in phase12["ba_test_2d"].items()})
    results["hamming"]["host_loop_mild_rel_err"] = phase13["fba_orbit"]["mild_rel_err"]
    results["ba_schur"]["host_loop_rel_errs"] = phase13["ba_loop"]["schur_rel_errs"]
    path_launches.append(phase14["launches"])
    path_launches.append(phase16["launches"])

    # the hamming launches are phases 9's and 13's counted runs, the ba_schur
    # launches phases 10's and 13's; the other four keep the counts of phases
    # 5, 7, 8, 14 and 16 (phase 11 prints its own). No single PyTorch call computes
    # any of the six functions.
    counted_in = {_build.HAMMING.name: phase9["launches"] + phase13["launches"],
                  _build.BA_SCHUR.name: phase10["launches"] + phase13["launches"]}
    kernels = [
        dict(name=k.name, route="cuda", source=k.source, replaces=k.replaces,
             launches=sum(n[k.name] for n in counted_in.get(k.name, path_launches)),
             phase15_launches=phase15["launches"][k.name], **results[k.name],
             roofline_share=results[k.name]["bound_ms"] / results[k.name]["ms"], library_ms=None)
        for k in _build.KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke took {time.perf_counter() - t_script:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
