"""Triangle mesh container and processing.

Port of `onepiece_tpu/geometry/mesh.py` (ref: src/Geometry/TriangleMesh.
{h,cpp}, src/Geometry/MeshSimplification.cpp), over tensors on one device:

  - vertex normals and clustering simplification run on the mesh's device.
    Their sums are segment sums after a stable sort, added in the order the
    JAX package's `np.add.at` adds them, so they give the same numbers on
    every run and on every device; `index_add_`'s float atomics on the card
    add in another order each run.
  - quadric (QEM) simplification and connected-component pruning copy the
    mesh to the host once and run the port's native library (`_native.py`):
    a global priority queue and a union-find are sequential algorithms.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _native


def _segment_sum(values: torch.Tensor, segment: torch.Tensor, n: int) -> torch.Tensor:
    """Sums (n, C) of the rows of `values` (M, C) by their `segment` id (M,),
    each segment's rows added one after another in their order in `values`
    (a stable sort, then `segment_reduce`): the order of `np.add.at`."""
    order = torch.sort(segment, stable=True).indices
    # rows per segment: integer sums, exact in any order
    lengths = torch.zeros(n, dtype=torch.int64, device=segment.device).index_add_(
        0, segment, torch.ones_like(segment))
    # lengths sum to M and none is negative, so the checks (host syncs) are skipped
    return torch.segment_reduce(values[order], "sum", lengths=lengths, axis=0, unsafe=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b row by row, each component one product minus another, rounded
    as numpy's `np.cross` rounds them."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """|x| of each float32 row (N, 3), squares summed in order as numpy's
    norm sums them. The root is taken in float64 and rounded once: that is
    the correctly rounded float32 root, which torch's vectorised float32
    `sqrt` on the CPU is not always."""
    return torch.sqrt((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]).to(torch.float64)).to(x.dtype)


@dataclasses.dataclass
class TriangleMesh:
    vertices: torch.Tensor  # (V, 3) float32
    faces: torch.Tensor  # (F, 3) int64
    colors: torch.Tensor | None = None  # (V, 3) float32 in [0, 1]
    normals: torch.Tensor | None = None  # (V, 3) float32

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @staticmethod
    def from_numpy(vertices, faces, colors=None, normals=None, device="cuda") -> "TriangleMesh":
        def t(x, dtype):
            return None if x is None else torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

        return TriangleMesh(t(vertices, torch.float32), t(faces, torch.int64), t(colors, torch.float32),
                            t(normals, torch.float32))

    def numpy(self) -> tuple:
        """(vertices, faces, colors or None, normals or None) on the host."""
        return tuple(None if x is None else x.cpu().numpy()
                     for x in (self.vertices, self.faces, self.colors, self.normals))

    def to(self, device) -> "TriangleMesh":
        return TriangleMesh(*(None if x is None else x.to(device)
                              for x in (self.vertices, self.faces, self.colors, self.normals)))

    def compute_vertex_normals(self) -> "TriangleMesh":
        """Area-weighted vertex normals (ref TriangleMesh::ComputeNormals):
        each vertex sums the cross products of its faces, then is normalised."""
        v, f = self.vertices, self.faces
        fn = _cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        # the faces' first corners, then their second, then their third, as np.add.at adds them
        n = _segment_sum(fn.repeat(3, 1), f.T.reshape(-1), len(v))
        self.normals = n / torch.clamp(_norm3(n), min=1e-12)[:, None]
        return self

    # -- simplification ---------------------------------------------------

    def clustering_simplify(self, cell_size: float) -> "TriangleMesh":
        """Vertex-clustering simplification (ref ClusteringSimplification
        :579): one vertex per occupied grid cell, the float64 mean of its
        vertices (and colours); faces whose corners fall in fewer than three
        cells are dropped. Cells in lexicographic order of their keys, as
        `np.unique(axis=0)` orders them."""
        # a tensor divisor: the card divides by a host scalar as a product with its reciprocal
        keys = torch.floor(self.vertices / torch.tensor(cell_size, device=self.device)).to(torch.int64)
        uniq, inv, counts = torch.unique(keys, dim=0, return_inverse=True, return_counts=True)
        n = len(uniq)

        def mean(x):
            return (_segment_sum(x.to(torch.float64), inv, n) / counts[:, None]).to(torch.float32)

        nf = inv[self.faces]
        ok = (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])
        return TriangleMesh(mean(self.vertices), nf[ok], None if self.colors is None else mean(self.colors))

    def quadric_simplify(self, target_faces: int) -> "TriangleMesh":
        """QEM edge-collapse simplification to about `target_faces` faces
        (ref QuadricSimplification, MeshSimplification.cpp:157), on the host
        in the native library; the result comes back to the mesh's device."""
        lib = _native.mesh_library()
        v = np.ascontiguousarray(self.vertices.cpu().numpy(), np.float32)
        f = np.ascontiguousarray(self.faces.cpu().numpy(), np.int32)
        ov = np.empty_like(v)
        of = np.empty_like(f)
        onv = ctypes.c_int(0)
        onf = ctypes.c_int(0)
        ret = lib.qem_simplify(
            v.ctypes.data_as(_native._FP), len(v), f.ctypes.data_as(_native._IP), len(f), int(target_faces),
            ov.ctypes.data_as(_native._FP), ctypes.byref(onv), of.ctypes.data_as(_native._IP), ctypes.byref(onf),
        )
        if ret != 0:
            raise RuntimeError(f"qem_simplify failed ({ret})")
        return TriangleMesh.from_numpy(ov[: onv.value], of[: onf.value], device=self.device)

    def prune(self, min_faces: int) -> "TriangleMesh":
        """Drop connected components of fewer than `min_faces` faces (ref
        PruningHelper, MeshSimplification.cpp:658-733): the components on the
        host in the native library, the rest on the mesh's device."""
        lib = _native.mesh_library()
        f = np.ascontiguousarray(self.faces.cpu().numpy(), np.int32)
        keep = np.zeros(len(f), np.uint8)
        lib.prune_components(f.ctypes.data_as(_native._IP), len(f), len(self.vertices), int(min_faces),
                             keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        kept = self.faces[torch.from_numpy(keep.astype(bool)).to(self.device)]
        return TriangleMesh(self.vertices, kept, self.colors, self.normals).compact()

    def compact(self) -> "TriangleMesh":
        """Drop unreferenced vertices and remap the faces."""
        used = torch.zeros(len(self.vertices), dtype=torch.bool, device=self.device)
        used[self.faces.reshape(-1)] = True
        remap = torch.cumsum(used.to(torch.int64), 0) - 1

        def kept(x):
            return None if x is None else x[used]

        return TriangleMesh(self.vertices[used], remap[self.faces], kept(self.colors), kept(self.normals))

    # -- IO ----------------------------------------------------------------

    def write_ply(self, path: str) -> None:
        from ..io.ply import write_ply_mesh

        write_ply_mesh(path, *self.numpy())

    @staticmethod
    def read_ply(path: str, device="cuda") -> "TriangleMesh":
        from ..io.ply import read_ply

        d = read_ply(path)
        return TriangleMesh.from_numpy(d["vertices"], d.get("faces", np.zeros((0, 3), np.int64)), d.get("colors"),
                                       d.get("normals"), device=device)
