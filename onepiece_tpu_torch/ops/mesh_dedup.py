"""Vertex dedup of a triangle soup, on the soup's device.

The tensor counterpart of `io/ply.py:dedup_triangle_soup` (the port's copy
of the JAX package's numpy function, `onepiece_tpu/io/ply.py:178`), with
the same result bit for bit: the same vertices, faces and colours in the
same order. That function quantises each vertex to `round(v / quantum)`
(float32, half to even), keeps one vertex per distinct key in
`np.unique(axis=0)` order (rows compared as signed int64, x first) at the
position and colour of its first occurrence, and drops the faces whose
corners merged.

Here the rows are ordered by three stable sorts, by z, then y, then x, so
equal rows keep their input order and the first of each run is its first
occurrence; a cumsum over the run starts numbers the vertices and one
scatter gives every soup corner its vertex. Plain PyTorch: on the card the
sorts are the library's, as for the other plain tensor code of the port.
"""

from __future__ import annotations

import torch

from ..utils import tracing


def dedup_triangle_soup(
    tri_verts: torch.Tensor,  # (T, 3, 3)
    tri_colors: torch.Tensor | None = None,  # (T, 3, 3)
    quantum: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Merge identical (quantised) vertices -> (vertices (V, 3), faces (F, 3)
    int64, colors (V, 3) or None), on the soup's device."""
    with tracing.span("meshing.dedup"):
        return _dedup(tri_verts, tri_colors, quantum)


def _dedup(tri_verts, tri_colors, quantum):
    flat = tri_verts.reshape(-1, 3)
    n = flat.shape[0]
    dev = flat.device
    # a true division, as numpy's: PyTorch's CUDA kernel multiplies by the
    # reciprocal of a Python or CPU scalar divisor, which can move a key
    # across a .5 tie, so the divisor is a tensor on the soup's device
    keys = torch.round(flat / torch.full((), quantum, dtype=flat.dtype, device=dev)).to(torch.int64)
    order = torch.arange(n, device=dev)
    for d in (2, 1, 0):  # least significant axis first
        order = order[torch.sort(keys[order, d], stable=True)[1]]
    sorted_keys = keys[order]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = (sorted_keys[1:] != sorted_keys[:-1]).any(1)
    inv = torch.empty(n, dtype=torch.int64, device=dev)
    inv[order] = torch.cumsum(start, 0) - 1
    with tracing.sync("dedup_vertices"):
        first = order[start]
    faces = inv.reshape(-1, 3)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    cols = None if tri_colors is None else tri_colors.reshape(-1, 3)[first]
    with tracing.sync("dedup_faces"):
        faces = faces[ok]
    return flat[first], faces, cols
