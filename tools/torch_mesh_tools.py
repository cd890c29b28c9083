#!/usr/bin/env python3
"""Mesh utilities on the PyTorch + CUDA port: simplify (QEM / clustering), prune, normals.

    python3 tools/torch_mesh_tools.py simplify-quadric mesh.ply out.ply --target-faces 50000
    python3 tools/torch_mesh_tools.py simplify-cluster mesh.ply out.ply --cell-size 0.02
    python3 tools/torch_mesh_tools.py prune mesh.ply out.ply --min-faces 100
    python3 tools/torch_mesh_tools.py normals mesh.ply out.ply --device cpu
    python3 tools/torch_mesh_tools.py info mesh.ply

The counterpart of `tools/mesh_tools.py` for `onepiece_tpu_torch` (ref:
CMakeLists.txt:159-190 SimplifyMesh / SimplifyMeshQuadric / PruneMesh /
EstimateNormals): `geometry/mesh.TriangleMesh` on the run's device;
normals and clustering simplification run there, QEM and pruning in the
port's native library on the host. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.geometry.mesh import TriangleMesh  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cmd", choices=["simplify-quadric", "simplify-cluster", "prune", "normals", "info"])
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default="out.ply")
    ap.add_argument("--target-faces", type=int, default=10000)
    ap.add_argument("--cell-size", type=float, default=0.02)
    ap.add_argument("--min-faces", type=int, default=100)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    mesh = TriangleMesh.read_ply(args.input, device=args.device)
    print(f"in: {len(mesh.vertices)} verts {len(mesh.faces)} faces")
    if args.cmd == "info":
        return
    t = time.perf_counter()
    if args.cmd == "simplify-quadric":
        out = mesh.quadric_simplify(args.target_faces)
    elif args.cmd == "simplify-cluster":
        out = mesh.clustering_simplify(args.cell_size)
    elif args.cmd == "prune":
        out = mesh.prune(args.min_faces)
    else:
        out = mesh.compute_vertex_normals()
    secs = time.perf_counter() - t
    out.write_ply(args.output)
    print(f"out: {len(out.vertices)} verts {len(out.faces)} faces in {secs:.3f}s -> {args.output}")


if __name__ == "__main__":
    main()
