"""Shared helpers of the port's CLI tools: dataset arguments and frame
loading, the synthetic render, the chunked frame loop of the sparse
systems, the post-hoc TSDF fusion and the mesh writer.

The counterpart of `tools/_common.py` for `onepiece_tpu_torch`. Imports
nothing of the JAX package. A tool reads a TUM folder with `--dataset DIR`
or renders the synthetic orbit with `--synthetic N` (on the run's device);
`tools/torch_make_synthetic_dataset.py` writes such a folder.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from onepiece_tpu_torch.geometry.camera import PRESETS, PinholeCamera  # noqa: E402
from onepiece_tpu_torch.integration.blocks import TSDFVolume  # noqa: E402
from onepiece_tpu_torch.io import trajectory as traj  # noqa: E402
from onepiece_tpu_torch.io.ply import write_ply_mesh  # noqa: E402
from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup  # noqa: E402
from onepiece_tpu_torch.systems.dense_slam import reconstruct  # noqa: E402
from onepiece_tpu_torch.systems.fused_sparse import KEYFRAME_DISPARITY  # noqa: E402
from onepiece_tpu_torch.utils import synthetic  # noqa: E402

TRAJECTORIES = {"orbit": synthetic.orbit_trajectory, "loop": synthetic.loop_trajectory}


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", type=str, default="cuda", help="cuda (the kernels) or cpu (their plain versions)")


def add_dataset_args(ap: argparse.ArgumentParser, trajectory: bool = False) -> None:
    """--dataset / --synthetic, --camera, --max-frames, --scale, --device;
    with `trajectory`, --trajectory orbit|loop for the synthetic render."""
    ap.add_argument("--dataset", type=str, default=None, help="TUM-format dataset dir")
    ap.add_argument("--synthetic", type=int, default=0, help="render N synthetic frames instead")
    ap.add_argument("--camera", type=str, default="tum", choices=list(PRESETS))
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--scale", type=int, default=1, help="downscale factor of camera and render (power of 2)")
    add_device_arg(ap)
    if trajectory:
        ap.add_argument("--trajectory", choices=tuple(TRAJECTORIES), default="orbit",
                        help="synthetic orbit_trajectory or the closed loop_trajectory")


def scaled_camera(cam: PinholeCamera, scale: int) -> PinholeCamera:
    c = cam
    while scale > 1:
        c = c.next_pyramid_level()
        scale //= 2
    return c


def load_frames(args):
    """Yields (timestamp, gray (H, W) float32 in [0, 1], depth (H, W) float32
    m) plus returns (camera, ground-truth poses (N, 4, 4) or None). Synthetic
    frames are all rendered here, on `args.device` (64 sphere-tracing steps),
    so a CLI's timed loop leaves the render out; dataset frames are numpy
    arrays from the prefetch ring (`TumSequence.stream`: decoder processes
    a few chunks ahead of the loop)."""
    cam = scaled_camera(PRESETS[args.camera], args.scale)
    if args.synthetic:
        n = min(args.max_frames or args.synthetic, args.synthetic)
        poses = TRAJECTORIES[getattr(args, "trajectory", "orbit")](args.synthetic)[:n]
        scene = synthetic.default_scene(args.device)
        frames = []
        for i in range(n):
            d, g = synthetic.render(scene, torch.from_numpy(poses[i]).to(args.device), cam.fx, cam.fy,
                                    cam.cx, cam.cy, cam.height, cam.width, num_steps=64)
            frames.append((i / 30.0, g, d))
        return iter(frames), cam, poses
    if not args.dataset:
        raise SystemExit("pass --dataset DIR or --synthetic N")
    from onepiece_tpu_torch.io.tum import TumSequence

    seq = TumSequence(args.dataset, depth_scale=cam.depth_scale, max_frames=args.max_frames)
    gt = seq.groundtruth()

    def gen():
        for (ts, _, _), (depth, gray) in zip(seq.pairs, seq.stream(gray=True)):
            yield ts, gray, depth

    return gen(), cam, (gt[1] if gt else None)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """t on `device`. A host tensor bound for the card goes through pinned
    memory and is not waited for, so a frame loop fed from disk makes no
    host sync."""
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def chunks(frames, k: int, device):
    """Group (ts, gray, depth) frames into (grays (k, H, W), depths (k, H, W))
    float32 tensors of k frames on `device` (the last may be shorter)."""
    buf = []

    def batch():
        return tuple(to_device(torch.stack([torch.as_tensor(f[i], dtype=torch.float32) for f in buf]), device)
                     for i in (0, 1))

    for _, gray, depth in frames:
        buf.append((gray, depth))
        if len(buf) == k:
            yield batch()
            buf = []
    if buf:
        yield batch()


def print_ate(poses: np.ndarray, gt) -> None:
    """The ATE of the first min(N, len(gt)) poses, where there is ground truth."""
    if gt is None:
        print("no ground truth: ATE not computed")
        return
    m = min(len(poses), len(gt))
    print(f"ATE RMSE (first {m} frames): {traj.ate_rmse(poses[:m], np.asarray(gt)[:m]):.5f} m")


def add_turntable_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--turntable", type=str, default="",
                    help="directory for a rotating-view PNG sequence + GIF of the final mesh")


def write_mesh(vol, path: str, turntable: str = "", mesh=None) -> tuple[int, int, float]:
    """Mesh the volume (the marching-cubes kernel), merge its vertices on
    the volume's device (or take that `mesh`, already made), copy the mesh
    to the host once and write the PLY: (vertices, faces, seconds). With
    `turntable`, then render the mesh's turntable views on the volume's
    device into that directory, with a GIF (`tools/torch_render_turntable.
    py`; not counted in the seconds)."""
    t = time.perf_counter()
    if mesh is None:
        mesh = dedup_triangle_soup(*vol.extract_mesh_tensors())
    verts, faces, cols = (x.cpu().numpy() for x in mesh)
    write_ply_mesh(path, verts, faces, colors=cols)
    secs = time.perf_counter() - t
    if turntable:
        from torch_render_turntable import render_turntable

        render_turntable(*mesh[:2], turntable, colors=mesh[2], gif=os.path.join(turntable, "turntable.gif"))
    return len(verts), len(faces), secs


def keeping(frames, first: int, stride: int, kept: list):
    """The frames, appending (index, gray, depth) of every stride-th one
    (indices counted from `first`) to `kept` as they pass."""
    for i, (ts, gray, depth) in enumerate(frames, start=first):
        if i % stride == 0:
            kept.append((i, gray, depth))
        yield ts, gray, depth


def fuse(poses, kept, cam, voxel: float, device) -> tuple[TSDFVolume, tuple]:
    """DenseFusion's post-hoc reconstruction (`dense_slam.reconstruct`) of
    the kept (index, gray, depth) frames at their poses, colour = gray:
    (volume, deduplicated mesh)."""
    frames = ((f, depth, torch.as_tensor(gray, dtype=torch.float32)[..., None].expand(-1, -1, 3))
              for f, gray, depth in kept)
    return reconstruct(poses, frames, cam, voxel, device)


def add_sparse_args(ap: argparse.ArgumentParser, traj_name: str) -> None:
    """The arguments of the sparse systems' CLIs (FBAFusion, BAFusion)."""
    add_dataset_args(ap, trajectory=True)
    ap.add_argument("--out-mesh", type=str, default="")
    ap.add_argument("--out-traj", type=str, default=traj_name)
    ap.add_argument("--voxel", type=float, default=0.02)
    ap.add_argument("--integrate-stride", type=int, default=8)
    ap.add_argument("--keyframe-disparity", type=float, default=KEYFRAME_DISPARITY)
    ap.add_argument("--chunk", type=int, default=16, help="frames per process_chunk call")


def run(slam, frames, args, gt, cam, describe, per_frame: bool = False, finish=None) -> None:
    """Feed a sparse system the frames chunk by chunk (or, with `per_frame`,
    frame by frame through its `update_frame`), then report
    (`describe(slam)`), call `finish(slam)` if given, write the trajectory
    and, with --out-mesh, the mesh."""
    kept: list = []
    t0 = time.perf_counter()
    n0 = slam.frame_count
    frames = keeping(frames, n0, args.integrate_stride, kept)
    if per_frame:
        for _, gray, depth in frames:
            info = slam.update_frame(torch.as_tensor(gray, dtype=torch.float32).to(args.device),
                                     torch.as_tensor(depth, dtype=torch.float32).to(args.device))
            if info["frame"] % 10 == 0 or info.get("keyframe"):
                print(f"frame {info['frame']} {'KF' if info.get('keyframe') else '  '} success={info['success']} "
                      f"disp={info.get('disparity', 0):.1f}")
    else:
        for grays, depths in chunks(frames, args.chunk, args.device):
            print(f"chunk -> {slam.process_chunk(grays, depths)}")
    dt = time.perf_counter() - t0
    n = slam.frame_count - n0
    print(describe(slam) + f" in {dt:.2f}s ({n / dt:.2f} fps)")
    if finish is not None:
        finish(slam)
    poses = slam.trajectory()
    traj.write_matrix_trajectory(args.out_traj, poses)
    print_ate(poses, gt)
    if args.out_mesh:
        vol, mesh = fuse(poses, kept, cam, args.voxel, args.device)
        nv, nf, secs = write_mesh(vol, args.out_mesh, mesh=mesh)
        print(f"mesh: {vol.num_active} blocks, {nv} verts {nf} faces in {secs:.2f}s -> {args.out_mesh} "
              f"(key-saturated frames {vol.key_saturated_frames})")
