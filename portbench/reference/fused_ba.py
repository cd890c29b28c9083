"""The comparison that decides `correct` for the BAFusion configuration
(`configs/tum_bafusion.json`; the system `systems/fused_ba.py`).

The reference is the frozen plain copy of the BAFusion path (`fba/`), run
over the same frames in the same chunks; its RANSAC draws come from the
same per-chunk seeds as the program's. Numbers:

- `traj_gap_m`: the largest translation gap between the two trajectories
  (anchored on the keyframes' poses after BA);
- `graph_mismatch`: keyframes and pose-graph edges (loop-closure edges
  among them) in one run and not in the other, counted;
- `point_gap_m`: the Hausdorff distance between the two runs' world points
  after BA (where both runs hold the same points, it is at most the largest
  gap between them);
- `ba_mse_gap`: the gap between the two runs' BA mean squared errors after
  the last chunk, relative to the reference's.

The reference runs with PyTorch's deterministic algorithms: its float
`index_add_` sums are otherwise summed by CUDA atomics, in an order that
changes from run to run, and BA's later solves carry that rounding to
millimetres, so one seed would read differently in two runs.

A number that cannot be read reads None and fails its limit.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def _repeatable():
    was, warn_only = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)

from ..systems.fused_ba import BAOut, outputs, settings
from .fba.geometry.camera import PinholeCamera
from .fba.systems.fused_ba import FusedBASlam


def run(grays, depths, cfg: dict, rnd=lambda x: x) -> BAOut:
    """The reference's scan (the control's with `rnd` a bfloat16 round trip
    of the frames as they are stored)."""
    c = cfg["camera"]
    cam = PinholeCamera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"], c["depth_scale"])
    slam = FusedBASlam(cam, device=grays.device, **settings(cfg))
    with _repeatable():
        for i in range(0, grays.shape[0], cfg["chunk"]):
            slam.process_chunk(rnd(grays[i : i + cfg["chunk"]]), rnd(depths[i : i + cfg["chunk"]]))
    return outputs(slam)


def control_scan(grays, depths, rgbs, cfg: dict) -> BAOut:
    return run(grays, depths, cfg, lambda x: x.to(torch.bfloat16).to(torch.float32))


def _world_points(o: BAOut) -> torch.Tensor:
    n = o.n_pts
    T = o.kf_pose[o.pt_anchor[:n]]
    return (T[:, :3, :3] @ o.pt_local[:n, :, None])[..., 0] + T[:, :3, 3]


def hausdorff(a: torch.Tensor, b: torch.Tensor):
    """The Hausdorff distance between two point sets (M, 3) and (N, 3):
    0 where both are empty, None where one is."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return 0.0 if a.shape[0] == b.shape[0] else None
    a, b = a.double(), b.double().to(a.device)
    d = torch.cdist(a, b)
    return float(torch.maximum(d.min(1).values.max(), d.min(0).values.max()))


def judge(out: BAOut, grays, depths, rgbs, cfg: dict) -> dict:
    ref = run(grays, depths, cfg)
    r = {}
    a, b = out.trajectory.double(), ref.trajectory.double()
    ok = a.shape == b.shape and bool(torch.isfinite(a).all())
    r["traj_gap_m"] = float(torch.linalg.vector_norm(a[:, :3, 3] - b[:, :3, 3], dim=-1).max()) if ok else None
    ea = set(zip(out.edge_src[: out.num_edges].tolist(), out.edge_dst[: out.num_edges].tolist()))
    eb = set(zip(ref.edge_src[: ref.num_edges].tolist(), ref.edge_dst[: ref.num_edges].tolist()))
    r["graph_mismatch"] = float(abs(out.num_kf - ref.num_kf) + len(ea ^ eb) + abs(out.lc_edges - ref.lc_edges))
    r["point_gap_m"] = hausdorff(_world_points(out), _world_points(ref))
    if ref.ba_mse > 0:
        r["ba_mse_gap"] = abs(out.ba_mse - ref.ba_mse) / ref.ba_mse
    else:  # BA ran on no chunk of the reference's scan
        r["ba_mse_gap"] = 0.0 if out.ba_mse == 0 else None
    return r


def recount(out: BAOut, grays, depths, rgbs, cfg: dict) -> dict:
    """{kernel: {"bytes", "ops"}} of a scan's Hamming matches, MILD scores
    and BA Schur steps, counted on the reference's own calls over the
    scan's frames (the same calls as the program's where the two agree)
    from the inputs of each call, as `chip_smoke.py` counts them."""
    from . import work
    from .fba.lcdetection import mild
    from .fba.ops import ba_schur, hamming

    tally = {k: dict(bytes=0, ops=0) for k in ("hamming", "mild", "ba_schur")}

    def add(kernel, n_bytes, ops):
        tally[kernel]["bytes"] += n_bytes
        tally[kernel]["ops"] += ops

    orig = hamming.hamming_match, mild.mild_feature_scores, ba_schur.reduced_system
    def match(a, b, vb, uv_pred=None, uv_b=None, window=20.0):
        add("hamming", *work.hamming_match(a, b, vb, uv_pred, uv_b, window))
        return orig[0](a, b, vb, uv_pred, uv_b, window)

    def scores(q_desc, q_valid, db_desc, db_valid, g):
        add("mild", *work.mild_feature_scores(q_desc, q_valid, db_desc, db_valid, g))
        return orig[1](q_desc, q_valid, db_desc, db_valid, g)

    def reduced(poses, points, frame, point, uv, valid, lam, intr, pc_obs=None, lists=None, undamped_u=False):
        lists = ba_schur.build_lists(frame, point, valid, poses.shape[0], points.shape[0])
        add("ba_schur", *work.ba_step(poses.shape[0], points.shape[0], lists, pc_obs is not None))
        return orig[2](poses, points, frame, point, uv, valid, lam, intr, pc_obs, None, undamped_u)

    hamming.hamming_match, mild.mild_feature_scores, ba_schur.reduced_system = match, scores, reduced
    try:
        run(grays, depths, cfg)
    finally:
        hamming.hamming_match, mild.mild_feature_scores, ba_schur.reduced_system = orig
    return tally
