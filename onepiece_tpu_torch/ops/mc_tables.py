"""Marching-cubes triangulation table, generated — not transcribed.

The port's own copy of `onepiece_tpu/ops/mc_tables.py` (numpy only; the
port imports nothing of the JAX package). The CUDA marching-cubes kernel
takes these tables into its constant memory at first use.

The reference ships the classic 256-case lookup table as a constant
(ref: src/Integration/MarchingCubePredefined.h:1-292). Here the equivalent
table is *derived* at import time from first principles, which both avoids
copying tabulated data and guarantees the properties the tests assert:

  1. For each of the 256 in/out corner configurations, cut edges are paired
     on every face by the rule "connect segments around INSIDE corners"
     (resolves the 4-cut ambiguous face deterministically; neighbours see the
     same face signs, so shared faces always agree -> watertight meshes).
  2. Paired segments are chained into closed loops over the cube surface.
  3. Loops are fan-triangulated and oriented so triangle normals point from
     inside (sdf < iso) to outside (sdf > iso).

Cube corner c in [0, 8): position bits (x, y, z) = (c & 1, c>>1 & 1, c>>2 & 1).
Edge list is fixed below; interpolation happens along EDGE_CORNERS pairs.
"""

from __future__ import annotations

import numpy as np

CORNER_POS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int32)

# 12 edges as (corner_a, corner_b)
EDGE_CORNERS = np.array(
    [
        (0, 1), (2, 3), (4, 5), (6, 7),  # x-aligned
        (0, 2), (1, 3), (4, 6), (5, 7),  # y-aligned
        (0, 4), (1, 5), (2, 6), (3, 7),  # z-aligned
    ],
    np.int32,
)

# 6 faces: corner indices in cyclic order
_FACES = [
    [0, 1, 3, 2],  # z = 0
    [4, 6, 7, 5],  # z = 1
    [0, 4, 5, 1],  # y = 0
    [2, 3, 7, 6],  # y = 1
    [0, 2, 6, 4],  # x = 0
    [1, 5, 7, 3],  # x = 1
]

_EDGE_INDEX = {}
for _ei, (_a, _b) in enumerate(EDGE_CORNERS):
    _EDGE_INDEX[(int(_a), int(_b))] = _ei
    _EDGE_INDEX[(int(_b), int(_a))] = _ei


def _face_segments(config: int, face: list[int]) -> list[tuple[int, int]]:
    """Isocontour segments on one face as pairs of global edge ids."""
    inside = [(config >> c) & 1 for c in face]
    cut = []
    for i in range(4):
        if inside[i] != inside[(i + 1) % 4]:
            cut.append(i)  # face-edge i between corners i, i+1
    if not cut:
        return []
    segs = []
    if len(cut) == 2:
        pairs = [(cut[0], cut[1])]
    else:  # 4 cuts: ambiguous face -> connect around inside corners
        # face-edge i and face-edge (i-1) share corner i; pair edges around
        # each inside corner
        pairs = []
        for i in range(4):
            if inside[i]:
                pairs.append(((i - 1) % 4, i))
        assert len(pairs) == 2
    for fa, fb in pairs:
        ea = _EDGE_INDEX[(face[fa], face[(fa + 1) % 4])]
        eb = _EDGE_INDEX[(face[fb], face[(fb + 1) % 4])]
        segs.append((ea, eb))
    return segs


def _loops_for_config(config: int) -> list[list[int]]:
    """Closed loops of edge ids for one corner configuration."""
    adj: dict[int, list[int]] = {}
    for face in _FACES:
        for a, b in _face_segments(config, face):
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
    for e, nbrs in adj.items():
        assert len(nbrs) == 2, (config, e, nbrs)
    loops = []
    visited = set()
    for start in sorted(adj):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            nxt = [n for n in adj[cur] if n != prev]
            # handle 2-cycles / pick unvisited deterministic
            nxt = nxt[0] if nxt else adj[cur][0]
            if nxt == start:
                break
            loop.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


def _edge_midpoint(e: int) -> np.ndarray:
    a, b = EDGE_CORNERS[e]
    return (CORNER_POS[a] + CORNER_POS[b]) / 2.0


def _orient_loop(config: int, loop: list[int]) -> list[int]:
    """Orient so the fan normals point from inside (bit=1) toward outside."""
    pts = np.array([_edge_midpoint(e) for e in loop])
    centroid = pts.mean(0)
    # Newell normal
    n = np.zeros(3)
    for i in range(len(pts)):
        p, q = pts[i], pts[(i + 1) % len(pts)]
        n += np.cross(p - centroid, q - centroid)
    inside_pts = CORNER_POS[[c for c in range(8) if (config >> c) & 1]]
    outside_pts = CORNER_POS[[c for c in range(8) if not (config >> c) & 1]]
    grad = outside_pts.mean(0) - inside_pts.mean(0)
    if np.dot(n, grad) < 0:
        loop = loop[::-1]
    return loop


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """Returns (tri_table (256, MAX_TRIS, 3) edge ids with -1 padding,
    tri_counts (256,))."""
    all_tris = []
    for config in range(256):
        tris = []
        if config not in (0, 255):
            for loop in _loops_for_config(config):
                loop = _orient_loop(config, loop)
                for i in range(1, len(loop) - 1):
                    tris.append((loop[0], loop[i], loop[i + 1]))
        all_tris.append(tris)
    max_tris = max(len(t) for t in all_tris)
    table = np.full((256, max_tris, 3), -1, np.int32)
    counts = np.zeros((256,), np.int32)
    for config, tris in enumerate(all_tris):
        counts[config] = len(tris)
        for i, t in enumerate(tris):
            table[config, i] = t
    return table, counts


TRI_TABLE, TRI_COUNTS = _build_tables()
MAX_TRIS_PER_VOXEL = int(TRI_TABLE.shape[1])
