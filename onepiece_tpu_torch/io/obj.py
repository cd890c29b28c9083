"""Wavefront OBJ mesh IO.

Port of `onepiece_tpu/io/obj.py` (the reference's OBJManager): vertices,
optional vertex normals and triangles with 1-based indices; a polygon read
back is split into a fan of triangles around its first vertex.
"""

from __future__ import annotations

import numpy as np


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray, normals: np.ndarray | None = None) -> None:
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if normals is not None:
            for n in normals:
                f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for tri in faces:
            a, b, c = tri + 1
            f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n" if normals is not None else f"f {a} {b} {c}\n")


def read_obj(path: str) -> dict:
    """{"vertices": (V, 3) float32, "faces": (F, 3) int64[, "normals": (V, 3) float32]}."""
    verts, normals, faces = [], [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "vn":
                normals.append([float(x) for x in p[1:4]])
            elif p[0] == "f":
                idx = [int(tok.split("/")[0]) - 1 for tok in p[1:]]
                faces.extend([idx[0], idx[k], idx[k + 1]] for k in range(1, len(idx) - 1))
    out = {
        "vertices": np.asarray(verts, np.float32),
        "faces": np.asarray(faces, np.int64) if faces else np.zeros((0, 3), np.int64),
    }
    if normals:
        out["normals"] = np.asarray(normals, np.float32)
    return out
