#!/usr/bin/env python3
"""This tree's marching-cubes kernel and mesh path against another tree's, on one card.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_mesh.py --parent build/parent [--rounds 2]

Renders the 16-frame 640x480 orbit and fuses it with this tree's
`FusedDenseFusion` (gray, as `chip_smoke.py` phase 5), then, in turns
(other, this, this, other, per round) on that one volume:

  1. the kernel: each tree's `extract_triangles` on the same pool, each
     held equal (same triangles, in order) to this tree's plain version;
     device time per call from the profiler (CUPTI, the trees' own kernel
     names; the count pass alone beside it) and CUDA-event time of
     back-to-back calls;
  2. time to a mesh, host clock, each step ended by a sync: the other
     tree's `extract_mesh` -> numpy `dedup_triangle_soup` -> `write_ply_mesh`,
     and this tree's `extract_mesh_tensors` -> `ops/mesh_dedup` on the card
     -> one copy to the host -> `write_ply_mesh`; the two meshes must be
     equal (vertices, faces and colours).

The other tree's package is imported under another name and builds its
kernels into its own `build/kernels/`. Needs a CUDA device; prints the
card's name and power limit, and one JSON line of the times last.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np
import torch

import chip_smoke
from onepiece_tpu_torch import _build
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA as CAM
from onepiece_tpu_torch.integration.blocks import neighbor_slots_device
from onepiece_tpu_torch.io.ply import write_ply_mesh
from onepiece_tpu_torch.ops import marching_cubes as mc
from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup
from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion
from onepiece_tpu_torch.utils import synthetic

OTHER = "other_onepiece_tpu_torch"


def import_other(root: Path) -> None:
    """Import the other tree's package as `OTHER`."""
    pkg = root / "onepiece_tpu_torch"
    spec = importlib.util.spec_from_file_location(OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)


def fused_volume(dev):
    poses = synthetic.orbit_trajectory(chip_smoke.N_FRAMES)
    scene = synthetic.default_scene(dev)
    frames = [synthetic.render(scene, torch.from_numpy(p).to(dev), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
                               CAM.height, CAM.width, num_steps=chip_smoke.RENDER_STEPS) for p in poses]
    slam = FusedDenseFusion(CAM, device=dev)
    slam.process_chunk(torch.stack([g for _, g in frames]), torch.stack([d for d, _ in frames]))
    return slam.to_volume()


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree (holding onepiece_tpu_torch/)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_mesh: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    import_other(Path(args.parent).resolve())
    o_mc = importlib.import_module(f"{OTHER}.ops.marching_cubes")
    o_blocks = importlib.import_module(f"{OTHER}.integration.blocks")
    o_ply = importlib.import_module(f"{OTHER}.io.ply")
    o_build = importlib.import_module(f"{OTHER}._build")
    _build.library()
    o_build.library()

    vol = fused_volume(dev)
    na = vol.num_active
    coords = torch.from_numpy(vol.active_coords()).to(dev, torch.int32)
    kargs = (vol.vox, torch.arange(na, dtype=torch.int32, device=dev), neighbor_slots_device(coords), coords,
             vol.voxel_size, 0.0)
    vp, cp = mc.extract_triangles_reference(*kargs)
    variants = {  # name: (wrapper, the kernels it launches)
        "other": (o_mc.extract_triangles, ("mc_count_kernel", "mc_emit_kernel")),
        "this": (mc.extract_triangles, ("mc_count_kernel", "mc_emit_kernel")),
    }
    for name, (fn, _) in variants.items():
        vk, ck = fn(*kargs)
        torch.cuda.synchronize()
        if not (vk.shape == vp.shape and torch.equal(vk, vp) and torch.equal(ck, cp)):
            raise AssertionError(f"{name}: {vk.shape[0]} triangles, not the plain version's {vp.shape[0]} in order")
    print(f"fused volume: {na} blocks, {vp.shape[0]} triangles; every variant equals the plain version in order",
          flush=True)
    del vk, ck, vp, cp

    # other's mesh path on the same pool
    o_vol = o_blocks.TSDFVolume(vol.voxel_size, vol.truncation, vox=vol.vox)
    o_vol.allocate(vol.active_coords())

    def mesh_other(path):
        (tv, tc), t_ex = timed(o_vol.extract_mesh)
        (v, f, c), t_dd = timed(lambda: o_ply.dedup_triangle_soup(tv, tc))
        _, t_ply = timed(lambda: write_ply_mesh(path, v, f, colors=c))
        return (v, f, c), (t_ex, t_dd, t_ply)

    def mesh_this(path):
        (tv, tc), t_ex = timed(vol.extract_mesh_tensors)
        (v, f, c), t_dd = timed(lambda: [x.cpu().numpy() for x in dedup_triangle_soup(tv, tc)])
        _, t_ply = timed(lambda: write_ply_mesh(path, v, f, colors=c))
        return (v, f, c), (t_ex, t_dd, t_ply)

    paths = {"other": mesh_other, "this": mesh_this}
    kernel = {k: [] for k in variants}
    mesh = {k: [] for k in paths}
    with tempfile.TemporaryDirectory() as tmp:
        meshes = {k: fn(os.path.join(tmp, f"{k}.ply"))[0] for k, fn in paths.items()}  # warm, and compared
        if not all(np.array_equal(a, b) for a, b in zip(meshes["other"], meshes["this"])):
            raise AssertionError("the two trees' meshes differ")
        print(f"meshes equal: {len(meshes['this'][0])} vertices, {len(meshes['this'][1])} faces", flush=True)
        order = ["other", "this", "this", "other"]
        for r in range(args.rounds):
            for name in order:
                fn, names = variants[name]
                ms = chip_smoke.device_ms(lambda: fn(*kargs), names)
                count_ms = chip_smoke.device_ms(lambda: fn(*kargs), names[:1])
                ev = chip_smoke.cuda_ms(lambda: fn(*kargs))
                kernel[name].append((ms, count_ms, ev))
                print(f"round {r} {name}: kernel {ms:.4f} ms on the device (count pass {count_ms:.4f}), "
                      f"{ev:.4f} ms by events", flush=True)
                if name in paths:
                    t = paths[name](os.path.join(tmp, f"{name}.ply"))[1]
                    mesh[name].append(t)
                    print(f"round {r} {name}: time to a mesh {sum(t):.1f} ms (extract {t[0]:.2f}, dedup "
                          f"{t[1]:.2f}, PLY {t[2]:.2f})", flush=True)
    print(card)
    print(json.dumps({"card": card, "blocks": na, "kernel_ms_count_ms_events_ms": kernel,
                      "mesh_extract_dedup_ply_ms": mesh}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
