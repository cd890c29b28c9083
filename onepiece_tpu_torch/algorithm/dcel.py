"""2D line arrangements as a doubly-connected edge list (DCEL).

The port's own copy of `onepiece_tpu/algorithm/dcel.py` (numpy only, on
the host), unchanged, so that its output equals the JAX package's.

Rebuild of `algorithm::DCEL` + `Arrangements` (ref: src/Algorithm/DCEL.
{h,cpp} — vertex/half-edge/face tables, line insertion, face walking;
src/Algorithm/Arrangements.{h,cpp} — bounding-box init + intersection
computation). Host-side code (pointer-chasing is not TPU work — the device
contributes upstream line fitting and downstream room embedding).

Construction differs from the reference's incremental insertion: all lines
are clipped to the box, globally split at pairwise intersections, and faces
are extracted by the standard angular-sweep half-edge walk — same output,
simpler invariants.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

EPS = 1e-9


@dataclasses.dataclass
class Arrangement:
    vertices: np.ndarray  # (V, 2)
    edges: np.ndarray  # (E, 2) vertex index pairs (undirected)
    faces: list[list[int]]  # CCW vertex loops, outer face excluded
    face_edges: list[list[int]]  # per face: edge ids along the loop
    edge_line: np.ndarray  # (E,) source line id (-1 for box edges)


def _clip_line_to_box(p: np.ndarray, d: np.ndarray, lo, hi):
    """Clip infinite line p + t d to box; returns (a, b) or None."""
    ts = []
    for axis in range(2):
        if abs(d[axis]) > EPS:
            for bound in (lo[axis], hi[axis]):
                t = (bound - p[axis]) / d[axis]
                q = p + t * d
                o = 1 - axis
                if lo[o] - 1e-7 <= q[o] <= hi[o] + 1e-7:
                    ts.append(t)
    if len(ts) < 2:
        return None
    t0, t1 = min(ts), max(ts)
    if t1 - t0 < EPS:
        return None
    return p + t0 * d, p + t1 * d


def _seg_intersect(a0, a1, b0, b1):
    """Proper or endpoint intersection point of two segments, or None."""
    r = a1 - a0
    s = b1 - b0
    denom = r[0] * s[1] - r[1] * s[0]
    if abs(denom) < EPS:
        return None
    t = ((b0 - a0)[0] * s[1] - (b0 - a0)[1] * s[0]) / denom
    u = ((b0 - a0)[0] * r[1] - (b0 - a0)[1] * r[0]) / denom
    if -1e-9 <= t <= 1 + 1e-9 and -1e-9 <= u <= 1 + 1e-9:
        return a0 + t * r
    return None


def build_arrangement(
    lines: np.ndarray,  # (L, 4): point (2) + direction (2) per line
    box_lo=(-10.0, -10.0),
    box_hi=(10.0, 10.0),
    snap: float = 1e-6,
) -> Arrangement:
    lo = np.asarray(box_lo, float)
    hi = np.asarray(box_hi, float)
    # box edges as 4 segments (line id -1)
    corners = np.array([[lo[0], lo[1]], [hi[0], lo[1]], [hi[0], hi[1]], [lo[0], hi[1]]])
    segs = [(corners[i], corners[(i + 1) % 4], -1) for i in range(4)]
    for li, ln in enumerate(np.asarray(lines, float)):
        clipped = _clip_line_to_box(ln[:2], ln[2:], lo, hi)
        if clipped is not None:
            segs.append((clipped[0], clipped[1], li))

    # split all segments at pairwise intersections
    cut_ts: list[list[float]] = [[0.0, 1.0] for _ in segs]
    for i in range(len(segs)):
        for j in range(i + 1, len(segs)):
            p = _seg_intersect(segs[i][0], segs[i][1], segs[j][0], segs[j][1])
            if p is None:
                continue
            for k, seg in ((i, segs[i]), (j, segs[j])):
                d = seg[1] - seg[0]
                t = float(np.dot(p - seg[0], d) / max(np.dot(d, d), EPS))
                cut_ts[k].append(min(max(t, 0.0), 1.0))

    # vertex pool with snapping
    vmap: dict[tuple[int, int], int] = {}
    verts: list[np.ndarray] = []

    def vid(p):
        key = (int(round(p[0] / snap)), int(round(p[1] / snap)))
        if key not in vmap:
            vmap[key] = len(verts)
            verts.append(np.array([key[0] * snap, key[1] * snap]))
        return vmap[key]

    edges: list[tuple[int, int]] = []
    edge_line: list[int] = []
    eset = set()
    for (a, b, li), ts in zip(segs, cut_ts):
        ts = sorted(set(round(t, 12) for t in ts))
        pts = [a + t * (b - a) for t in ts]
        for k in range(len(pts) - 1):
            u, v = vid(pts[k]), vid(pts[k + 1])
            if u == v:
                continue
            key = (min(u, v), max(u, v))
            if key in eset:
                continue
            eset.add(key)
            edges.append((u, v))
            edge_line.append(li)

    V = np.array(verts)
    E = np.array(edges, np.int64) if edges else np.zeros((0, 2), np.int64)

    # half-edge face walk: at each vertex sort outgoing directions CCW;
    # next(h) = the clockwise-most turn from the reversed half-edge
    out: dict[int, list[tuple[float, int]]] = {}
    half = []  # (u, v, edge_id)
    for ei, (u, v) in enumerate(E):
        for (a, b) in ((u, v), (v, u)):
            hid = len(half)
            half.append((a, b, ei))
            ang = math.atan2(V[b][1] - V[a][1], V[b][0] - V[a][0])
            out.setdefault(a, []).append((ang, hid))
    for a in out:
        out[a].sort()

    def next_half(h):
        u, v, _ = half[h]
        # incoming direction at v is (u->v); reversed is angle of v->u
        ang = math.atan2(V[u][1] - V[v][1], V[u][0] - V[v][0])
        lst = out[v]
        # find the outgoing edge with the largest angle < ang (CW-most turn)
        idx = None
        for i, (a2, h2) in enumerate(lst):
            if a2 < ang - 1e-12:
                idx = i
        if idx is None:
            idx = len(lst) - 1
        return lst[idx][1]

    visited = [False] * len(half)
    faces: list[list[int]] = []
    face_edges: list[list[int]] = []
    for h0 in range(len(half)):
        if visited[h0]:
            continue
        loop_v, loop_e = [], []
        h = h0
        for _ in range(len(half) + 1):
            visited[h] = True
            u, v, ei = half[h]
            loop_v.append(u)
            loop_e.append(ei)
            h = next_half(h)
            if h == h0:
                break
        # shoelace area: keep CCW (interior) faces only
        pts = V[loop_v]
        area = 0.5 * float(
            np.sum(pts[:, 0] * np.roll(pts[:, 1], -1) - np.roll(pts[:, 0], -1) * pts[:, 1])
        )
        if area > 1e-9:
            faces.append(loop_v)
            face_edges.append(loop_e)
    return Arrangement(V, E, faces, face_edges, np.array(edge_line, np.int64))


def face_centroids(arr: Arrangement) -> np.ndarray:
    return np.array([arr.vertices[f].mean(0) for f in arr.faces])


def face_adjacency(arr: Arrangement) -> list[tuple[int, int, int]]:
    """(face_a, face_b, edge_id) for faces sharing an edge."""
    owner: dict[int, list[int]] = {}
    for fi, es in enumerate(arr.face_edges):
        for e in es:
            owner.setdefault(e, []).append(fi)
    out = []
    for e, fs in owner.items():
        fs = sorted(set(fs))
        if len(fs) == 2:
            out.append((fs[0], fs[1], e))
    return out
