"""2D geometric predicates and projections.

Port of `onepiece_tpu/geometry/geometry2d.py`, numpy as there (ref:
src/Geometry/Geometry2d.{h,cpp}:14-66: segment and line predicates,
intersections, projections, point-in-polygon). A host utility of the rooms
pipeline: the device has no use for single predicates.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-12


def cross2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def orientation(a, b, c) -> np.ndarray:
    """>0 CCW, <0 CW, 0 collinear (for points or batches)."""
    a, b, c = (np.asarray(x, float) for x in (a, b, c))
    return cross2(b - a, c - a)


def segments_intersect(a0, a1, b0, b1) -> bool:
    a0, a1, b0, b1 = (np.asarray(x, float) for x in (a0, a1, b0, b1))
    d1 = orientation(b0, b1, a0)
    d2 = orientation(b0, b1, a1)
    d3 = orientation(a0, a1, b0)
    d4 = orientation(a0, a1, b1)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)):
        return True

    def on_seg(p, q, r):
        return (
            abs(orientation(p, q, r)) < EPS
            and min(p[0], q[0]) - EPS <= r[0] <= max(p[0], q[0]) + EPS
            and min(p[1], q[1]) - EPS <= r[1] <= max(p[1], q[1]) + EPS
        )

    return bool(
        on_seg(b0, b1, a0) or on_seg(b0, b1, a1) or on_seg(a0, a1, b0) or on_seg(a0, a1, b1)
    )


def line_intersection(p0, d0, p1, d1):
    """Intersection of two infinite lines (point+direction); None if parallel."""
    p0, d0, p1, d1 = (np.asarray(x, float) for x in (p0, d0, p1, d1))
    denom = cross2(d0, d1)
    if abs(denom) < EPS:
        return None
    t = cross2(p1 - p0, d1) / denom
    return p0 + t * d0


def project_point_to_segment(p, a, b):
    """Closest point on segment ab to p, and the parameter t in [0, 1]."""
    p, a, b = (np.asarray(x, float) for x in (p, a, b))
    d = b - a
    t = float(np.clip(np.dot(p - a, d) / max(np.dot(d, d), EPS), 0.0, 1.0))
    return a + t * d, t


def point_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Ray-crossing test, vectorised over points. polygon: (M, 2) CCW or CW."""
    pts = np.atleast_2d(np.asarray(points, float))
    poly = np.asarray(polygon, float)
    x, y = pts[:, 0, None], pts[:, 1, None]
    x0, y0 = poly[:, 0][None], poly[:, 1][None]
    x1 = np.roll(poly[:, 0], -1)[None]
    y1 = np.roll(poly[:, 1], -1)[None]
    crosses = ((y0 > y) != (y1 > y)) & (
        x < (x1 - x0) * (y - y0) / np.where(np.abs(y1 - y0) < EPS, EPS, y1 - y0) + x0
    )
    inside = np.sum(crosses, axis=1) % 2 == 1
    return inside if points_nd(points) else bool(inside[0])


def points_nd(points) -> bool:
    return np.asarray(points).ndim == 2


def polygon_area(polygon: np.ndarray) -> float:
    """Signed (shoelace) area; positive for CCW."""
    p = np.asarray(polygon, float)
    return 0.5 * float(np.sum(cross2(p, np.roll(p, -1, axis=0))))
