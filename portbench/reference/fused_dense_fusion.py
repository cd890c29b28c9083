"""The comparison that decides `correct` for the dense fusion configuration
(`configs/tum_dense_fusion.json`; the system `systems/fused_dense_fusion.py`).

Three stages, each held against the plain reference:

- tracking: the reference works out the scan's poses from its frames
  alone; the numbers are the largest gaps between the program's and the
  reference's frame-to-frame motions (translation in metres, rotation in
  radians), so a fault shows where it happens and does not hide in drift.
- integration: the reference fuses the frames at the program's poses (it
  follows the program there, whose poses the tracking stage judges) and
  holds the program's pool to its own voxel by voxel, blocks matched by
  key: the share of voxels seen on either side whose weights differ, and
  the largest sdf and colour gaps where the weights agree.
- meshing: the reference meshes the program's pool (it follows the
  program there, whose pool the integration stage judges) and dedups; the
  largest vertex and colour gaps, read only where the faces agree.

A number that cannot be read (a scan of the wrong length, meshes whose
faces differ) reads None and fails its limit.
"""

from __future__ import annotations

import torch

from . import dense_fusion as ref
from . import plain_ops as P
from .dense_fusion import control_scan  # noqa: F401  (the control, in the program's place)


def _rel(poses: torch.Tensor) -> torch.Tensor:
    return P.inverse_T(poses[:-1]) @ poses[1:]


def _rot_gap(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """|Ra - Rb|_F / sqrt(2): the angle between the rotations where it is
    small, without arccos's loss of precision near zero."""
    return torch.linalg.matrix_norm(Ra - Rb) / 2**0.5


def tracking_gaps(prog_poses: torch.Tensor, ref_poses: torch.Tensor) -> dict:
    if prog_poses.shape != ref_poses.shape or not torch.isfinite(prog_poses).all():
        return dict(pose_gap_m=None, rot_gap_rad=None)
    a, b = _rel(prog_poses.double()), _rel(ref_poses.double())
    dt = torch.linalg.vector_norm(a[:, :3, 3] - b[:, :3, 3], dim=-1)
    dr = _rot_gap(a[:, :3, :3], b[:, :3, :3])
    return dict(pose_gap_m=float(dt.max()), rot_gap_rad=float(dr.max()))


def _fields(vox: torch.Tensor, coords: torch.Tensor, keys: torch.Tensor):
    """sdf, weight (K, 512) and colour (K, 3, 512) of the blocks `keys`
    (K,) in a pool whose rows 0..B-1 hold the blocks `coords`; absent
    blocks read weight 0."""
    own = P.pack_keys(coords)
    n = own.shape[0]
    if n == 0:
        z = torch.zeros((keys.shape[0], 512), device=keys.device)
        return z, z, torch.zeros((keys.shape[0], 3, 512), device=keys.device)
    srt, order = torch.sort(own)
    pos = torch.clamp(torch.searchsorted(srt, keys), max=n - 1)
    have = srt[pos] == keys
    rows = vox[order[pos]]
    w = torch.where(have[:, None], rows[:, 1], 0.0)
    return rows[:, 0], w, rows[:, 2:5]


def pool_gaps(prog_vox, prog_coords, ref_pool: ref.Pool) -> dict:
    keys = torch.unique(torch.cat([P.pack_keys(prog_coords), P.pack_keys(ref_pool.coords)]))
    sa, wa, ca = _fields(prog_vox, prog_coords, keys)
    sb, wb, cb = _fields(ref_pool.vox, ref_pool.coords, keys)
    seen = (wa > 0) | (wb > 0)
    agree = seen & (wa == wb)
    n_seen = int(seen.sum())
    if n_seen == 0:
        return dict(weight_mismatch=None, sdf_gap=None, color_gap=None)
    ds = torch.where(agree, (sa - sb).abs(), 0.0)
    dc = torch.where(agree[:, None], (ca - cb).abs(), 0.0)
    return dict(weight_mismatch=float((seen & ~agree).sum()) / n_seen,
                sdf_gap=float(ds.max()), color_gap=float(dc.max()))


def mesh_gaps(prog_mesh, ref_mesh) -> dict:
    """The largest vertex and colour gaps, read only where both meshes have
    the same vertices by count and the same faces, index for index."""
    (va, fa, ca), (vb, fb, cb) = prog_mesh, ref_mesh
    if va.shape != vb.shape or fa.shape != fb.shape or fb.shape[0] == 0 or not torch.equal(fa, fb):
        return dict(vertex_gap_m=None, vertex_color_gap=None)
    return dict(vertex_gap_m=float((va - vb).abs().max()), vertex_color_gap=float((ca - cb).abs().max()))


def judge(out: ref.ScanOut, grays, depths, rgbs, cfg: dict) -> dict:
    """Every number of the comparison for one scan's outputs."""
    readings = tracking_gaps(out.poses, ref.track(grays, depths, cfg))
    if out.poses.shape[0] != depths.shape[0]:
        readings.update(weight_mismatch=None, sdf_gap=None, color_gap=None)
    else:
        pool = ref.integrate(depths, rgbs, out.poses, cfg)
        readings.update(pool_gaps(out.vox, out.coords, pool))
        del pool
    v, f, c, _ = ref.mesh(out.vox, out.coords, cfg["voxel_size"])
    readings.update(mesh_gaps((out.verts, out.faces, out.colors), (v, f, c)))
    return readings


def recount(out: ref.ScanOut, grays, depths, rgbs, cfg: dict) -> list:
    """(touched blocks, voxels updated, of them from weight 0) of each frame
    of a scan at the program's poses, for the TSDF kernel's work count."""
    counts = []
    ref.integrate(depths, rgbs, out.poses, cfg, counts=counts)
    return counts
