"""BAFusion on the device: world-point tracks and full bundle adjustment on
top of the sparse keyframe front end.

Port of `onepiece_tpu/systems/fused_ba.py` (`TrackState`,
`make_track_state`, `BAChunkOut`, `_link_edge`, `_link_and_ba_body`, and
`fused_ba_chunk` folded into `FusedBASlam`). Each chunk runs the
`FusedFBASlam` front end (tracking, promotion, loop closure, the pose-graph
warm start), then:

  1. the linker: every edge the chunk appended links its matches into
     world-point tracks (`_link_edge`: adopt a track id from either end,
     allocate new ids with a cumsum, append the observations in two
     compacted blocks). JAX loops from `linked_edges` to the device count
     `edges.num`; here the host loops over a bound it knows without a read
     (the chunk's promotions plus its tracked loop-closure pairs) and masks
     each edge by `e < edges.num` on the device;
  2. full BA over the keyframe poses (T_cw) and the world points composed
     from their birth keyframes (`bundle.optimize_device`: the Schur
     reduction as the hand-written kernel of `csrc/ba_schur.cu` on the
     card), chosen over the warm start with `torch.where` where JAX's
     `lax.cond(run, ...)` skips it;
  3. the points decomposed back into their birth keyframes' frames, and the
     carried pose re-anchored to the refined keyframe poses.

The BA outputs join the front end's one fetch per chunk: `FusedBASlam`
makes as many host reads as `FusedFBASlam` on the same frames. The linker
writes the track state's buffers in place, with masks where JAX drops a
write.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..optimization import bundle
from ..utils import tracing
from . import fused_sparse as fs


class TrackState(NamedTuple):
    """World-point tracks and the observation store, on the device. Points
    are kept in their birth keyframe's camera frame (`pt_local`, anchored by
    `pt_anchor`), so that a pose-graph correction of the keyframe carries
    them along; world positions are composed for each BA solve and
    decomposed back after it."""

    track_of_kp: torch.Tensor  # (N_CAP, F) int64 global track id, -1 = none
    pt_local: torch.Tensor  # (P_CAP, 3) float32 birth-keyframe camera coords
    pt_anchor: torch.Tensor  # (P_CAP,) int64 birth keyframe index
    n_pts: torch.Tensor  # () int64
    obs_frame: torch.Tensor  # (O_CAP,) int64 keyframe index
    obs_point: torch.Tensor  # (O_CAP,) int64 world-point index
    obs_uv: torch.Tensor  # (O_CAP, 2) float32 observed pixels
    obs_pc: torch.Tensor  # (O_CAP, 3) float32 depth-backprojected camera point
    n_obs: torch.Tensor  # () int64
    linked_edges: torch.Tensor  # () int64 edges already consumed
    pt_overflow: torch.Tensor  # () int64 dropped world points
    obs_overflow: torch.Tensor  # () int64 dropped observations


def make_track_state(n_cap: int, f: int, p_cap: int, o_cap: int, device="cpu") -> TrackState:
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackState(
        track_of_kp=torch.full((n_cap, f), -1, **i64),
        pt_local=torch.zeros((p_cap, 3), **f32),
        pt_anchor=torch.zeros((p_cap,), **i64),
        n_pts=torch.zeros((), **i64),
        obs_frame=torch.zeros((o_cap,), **i64),
        obs_point=torch.zeros((o_cap,), **i64),
        obs_uv=torch.zeros((o_cap, 2), **f32),
        obs_pc=torch.zeros((o_cap, 3), **f32),
        n_obs=torch.zeros((), **i64),
        linked_edges=torch.zeros((), **i64),
        pt_overflow=torch.zeros((), **i64),
        obs_overflow=torch.zeros((), **i64),
    )


class BAChunkOut(NamedTuple):
    kf_pose: torch.Tensor  # (N_CAP, 4, 4) BA-refined world-from-keyframe
    n_pts: torch.Tensor  # ()
    n_obs: torch.Tensor  # ()
    pt_overflow: torch.Tensor  # ()
    obs_overflow: torch.Tensor  # ()
    mse: torch.Tensor  # () mean squared error after BA


def _route(idx: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """How `_put_rows` writes buf[idx[c]] = val[c] where keep[c] in place,
    dropping the rest (the JAX package's `mode="drop"`). The kept rows must
    be distinct. Every other entry rewrites the first kept entry's row with
    that entry's value, or, where nothing is kept, row 0 with its own old
    value, so that each row gets one value whatever order the writes take.
    Returns (rows, sources into `val` with the old row 0 appended)."""
    c = idx.shape[0]
    pos = torch.arange(c, device=idx.device)
    src = torch.where(keep, pos, torch.where(keep, pos, c).amin())
    return torch.nn.functional.pad(idx, (0, 1)).index_select(0, src), src


def _put_rows(buf: torch.Tensor, route: tuple[torch.Tensor, torch.Tensor], val: torch.Tensor) -> None:
    rows, src = route
    buf.index_copy_(0, rows, torch.cat([val, buf[:1]]).index_select(0, src))


def _last_wins(row: torch.Tensor, idx: torch.Tensor, cond: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """row with row[idx[c]] = val[c] where cond[c], the last c winning where
    idx repeats, as the JAX package's sequential scatter on the CPU keeps it
    (a CUDA scatter leaves the winner undefined): the winner of each entry
    is the largest position c, found with an `amax` scatter."""
    c = idx.shape[0]
    pos = torch.where(cond, torch.arange(c, device=idx.device), -1)
    win = torch.full_like(row, -1).scatter_reduce_(0, idx.clamp(0, row.shape[0] - 1), pos, "amax")
    return torch.where(win >= 0, val.index_select(0, win.clamp(min=0)), row)


def _link_edge(e: torch.Tensor, ts: TrackState, edges: fs.EdgeStore, kf_uv: torch.Tensor,
               active: torch.Tensor) -> TrackState:
    """Link the matches of edge e (a 0-d device index) into the tracks,
    writing the state's buffers in place; an edge with `active` false
    leaves them as they were. Observation semantics follow the reference's
    `_link_tracks`: a source observation is recorded only where the track
    is born (ref BASlam.cpp:89-150)."""
    p_cap = ts.pt_local.shape[0]
    o_cap = ts.obs_frame.shape[0]
    n_kp = ts.track_of_kp.shape[1]
    row = fs._row
    sd = torch.stack([row(edges.src, e), row(edges.dst, e)])  # source and destination keyframes
    i, j = row(edges.src_i, e), row(edges.dst_j, e)  # (C,)
    v = row(edges.valid, e) & active
    c = v.shape[0]

    tracks = ts.track_of_kp.index_select(0, sd)  # (2, F) both keyframes' track ids
    t_src, t_dst = tracks[0].index_select(0, i), tracks[1].index_select(0, j)
    tid0 = torch.where(t_src >= 0, t_src, t_dst)
    new = v & (tid0 < 0)
    nid = ts.n_pts + torch.cumsum(new.to(torch.int64), 0) - 1  # consecutive ids for the new tracks
    fits_p = new & (nid < p_cap)
    tid = torch.where(fits_p, nid, tid0)  # new-but-dropped stays -1

    # new points are born anchored in the source keyframe's camera frame
    # (edges.p_src rows are exactly that)
    p_src = row(edges.p_src, e)
    route = _route(nid, fits_p)
    _put_rows(ts.pt_local, route, p_src)
    _put_rows(ts.pt_anchor, route, sd[0].expand(c))
    n_new = torch.sum(fits_p.to(torch.int64))
    pt_drop = torch.sum((new & ~fits_p).to(torch.int64))

    # observations: the source block (tracks born here), then the
    # destination block (first sighting in dst), written together
    with tracing.span("ba.observations"):
        add_src = fits_p
        add_dst = v & (t_dst < 0) & (tid >= 0)
        ps = ts.n_obs + torch.cumsum(add_src.to(torch.int64), 0) - 1
        fits_s = add_src & (ps < o_cap)
        n_src = torch.sum(fits_s.to(torch.int64))
        pd = ts.n_obs + n_src + torch.cumsum(add_dst.to(torch.int64), 0) - 1
        fits_d = add_dst & (pd < o_cap)
        n_dst = torch.sum(fits_d.to(torch.int64))
        route = _route(torch.cat([ps, pd]), torch.cat([fits_s, fits_d]))
        uv = kf_uv.index_select(0, sd)
        _put_rows(ts.obs_frame, route, sd[:, None].expand(2, c).reshape(2 * c))
        _put_rows(ts.obs_point, route, tid.repeat(2))
        _put_rows(ts.obs_uv, route, torch.cat([uv[0].index_select(0, i), uv[1].index_select(0, j)]))
        _put_rows(ts.obs_pc, route, torch.cat([p_src, row(edges.p_dst, e)]))
        obs_drop = torch.sum(((add_src & ~fits_s) | (add_dst & ~fits_d)).to(torch.int64))

        # the ids go back into both keyframes' rows of the map (source row, then
        # destination row)
        tracks = _last_wins(tracks.reshape(-1), torch.cat([i, j + n_kp]),
                            torch.cat([t_src < 0, t_dst < 0]) & (v & (tid >= 0)).repeat(2), tid.repeat(2))
        ts.track_of_kp.index_copy_(0, sd[:1], tracks[None, :n_kp])
        ts.track_of_kp.index_copy_(0, sd[1:], tracks[None, n_kp:])

        return ts._replace(
            n_pts=ts.n_pts + n_new, n_obs=ts.n_obs + n_src + n_dst,
            pt_overflow=ts.pt_overflow + pt_drop, obs_overflow=ts.obs_overflow + obs_drop,
        )


def link_edges(ts: TrackState, edges: fs.EdgeStore, kf_uv: torch.Tensor, bound: int) -> TrackState:
    """Link the edges `linked_edges` .. `edges.num` - 1 (at most `bound` of
    them: the host's bound on the edges appended since the last call)."""
    e_cap = edges.src.shape[0]
    with tracing.span("ba.link", bound=bound):
        for k in range(bound):
            with tracing.span("ba.edge"):
                e = ts.linked_edges + k
                ts = _link_edge(torch.clamp(e, max=e_cap - 1), ts, edges, kf_uv, active=e < edges.num)
        return ts._replace(linked_edges=edges.num.clone())


def _link_and_ba_body(
    ts: TrackState,
    edges: fs.EdgeStore,
    kf_pose: torch.Tensor,  # (N_CAP, 4, 4) world-from-keyframe
    kf_uv: torch.Tensor,  # (N_CAP, F, 2) keypoint pixels per keyframe
    num_kf: torch.Tensor,  # () int64
    fx: float, fy: float, cx: float, cy: float,
    edge_bound: int,
    ba_iters: int = 8,
    ba_lam0: float = 3e-5,
    residual: str = "3d",
) -> tuple[TrackState, BAChunkOut]:
    """Link the chunk's new edges into tracks, then full BA. `residual="3d"`
    (the default) is the RGB-D observation model; `"2d"` the reference's
    pure reprojection model, with the scale re-anchor."""
    ts = link_edges(ts, edges, kf_uv, edge_bound)
    n_cap = kf_pose.shape[0]
    o_cap = ts.obs_frame.shape[0]
    dev = kf_pose.device

    with tracing.span("ba.compose"):
        T_cw = se3.inverse_T(kf_pose)
        obs_valid = torch.arange(o_cap, device=dev) < ts.n_obs
        obs = bundle.BAObservations(ts.obs_frame, ts.obs_point, ts.obs_uv, obs_valid,
                                    torch.zeros((1, 1), dtype=torch.int64, device=dev))
        fidx = torch.arange(n_cap, device=dev)
        has_obs = torch.zeros((n_cap,), dtype=torch.int64, device=dev).index_add_(0, ts.obs_frame,
                                                                                   obs_valid.to(torch.int64))
        solve_frame = (fidx > 0) & (fidx < num_kf) & (has_obs > 0)
        run = (num_kf >= 2) & (ts.n_pts >= 8) & (ts.n_obs >= 24)

        # world positions composed from the anchored storage at the current
        # (post-warm-start) keyframe poses
        Ta = kf_pose[ts.pt_anchor]
        world = torch.einsum("pij,pj->pi", Ta[:, :3, :3], ts.pt_local) + Ta[:, :3, 3]
    T_ba, world_ba, mse = bundle.optimize_device(
        T_cw, world, obs, solve_frame, fx, fy, cx, cy, max_iters=ba_iters, lam0=ba_lam0,
        anchor_scale=residual == "2d", pc_obs=ts.obs_pc if residual == "3d" else None)
    with tracing.span("ba.decompose"):
        T_cw = torch.where(run, T_ba, T_cw)
        world = torch.where(run, world_ba, world)
        mse = torch.where(run, mse, 0.0)
        kf_pose_new = se3.inverse_T(T_cw)
        # decompose back to the anchored storage against the refined poses
        Tna = T_cw[ts.pt_anchor]
        ts = ts._replace(pt_local=torch.einsum("pij,pj->pi", Tna[:, :3, :3], world) + Tna[:, :3, 3])
        return ts, BAChunkOut(kf_pose_new, ts.n_pts, ts.n_obs, ts.pt_overflow, ts.obs_overflow, mse)


@dataclasses.dataclass
class FusedBASlam(fs.FusedFBASlam):
    """BAFusion: the fused sparse front end, track linking and full-BA
    refinement per chunk, all on the device. The API mirrors
    `FusedFBASlam` (`process_chunk`, `trajectory`); the pose graph inside
    the front end is the warm start. `ba_every_chunks` runs the BA solve
    every N-th chunk (linking happens every chunk)."""

    # BA's dense cross terms scale with the capacities, so they start small
    # and double at half-full between chunks
    pt_capacity: int = 1024
    obs_capacity: int = 4096
    ba_iters: int = 8
    ba_lam0: float = 3e-5
    ba_every_chunks: int = 1
    residual: str = "3d"  # "3d" RGB-D model (the default) | "2d" the reference's reprojection model

    def __post_init__(self):
        super().__post_init__()
        # not `_track`: that is the front end's tracking method
        self._track_state = make_track_state(self.kf_capacity, self.max_keypoints, self.pt_capacity,
                                             self.obs_capacity, self.device)
        self.n_pts = 0
        self.n_obs = 0
        self.pt_overflow = 0
        self.obs_overflow = 0
        self.ba_mse = 0.0
        self._chunks = 0

    def _maybe_grow(self, next_k: int) -> None:
        kf_cap0 = self.kf_capacity
        super()._maybe_grow(next_k)
        t = self._track_state
        if self.kf_capacity != kf_cap0:
            pad = self.kf_capacity - t.track_of_kp.shape[0]
            t = t._replace(track_of_kp=torch.cat([t.track_of_kp, torch.full_like(t.track_of_kp[:1], -1)
                                                  .expand(pad, -1)]))
        # a chunk adds far fewer points and observations than its worst
        # case: grow at half-full, as the block pool does
        while self.n_pts * 2 > self.pt_capacity:
            t = t._replace(pt_local=torch.cat([t.pt_local, torch.zeros_like(t.pt_local)]),
                           pt_anchor=torch.cat([t.pt_anchor, torch.zeros_like(t.pt_anchor)]))
            self.pt_capacity *= 2
        while self.n_obs * 2 > self.obs_capacity:
            t = t._replace(**{k: torch.cat([a, torch.zeros_like(a)]) for k, a in (
                ("obs_frame", t.obs_frame), ("obs_point", t.obs_point), ("obs_uv", t.obs_uv),
                ("obs_pc", t.obs_pc))})
            self.obs_capacity *= 2
        self._track_state = t

    def _after_chunk(self, out: fs.SparseChunkOut) -> tuple[fs.SparseChunkOut, tuple]:
        """Link and BA on the device; the refined poses replace the front
        end's, and the BA counters join the chunk's one fetch."""
        self._chunks += 1
        st = self._state
        cam = self.camera
        self._track_state, ba = _link_and_ba_body(
            self._track_state, st.edges, st.kf_pose, st.kf.kp.uv, st.num_kf,
            float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), self._edge_bound,
            ba_iters=self.ba_iters if self._chunks % self.ba_every_chunks == 0 else 0,
            ba_lam0=self.ba_lam0, residual=self.residual,
        )
        # adopt the refined poses (re-anchor the carried pose)
        self._state = st._replace(kf_pose=ba.kf_pose, last_T=fs._row(ba.kf_pose, st.last_anchor) @ st.last_Trel)
        return out._replace(kf_pose=ba.kf_pose), tuple(ba[1:])

    def _absorb(self, extra: list[np.ndarray], info: dict) -> None:
        n_pts, n_obs, pt_over, obs_over, mse = extra
        self.n_pts, self.n_obs = int(n_pts), int(n_obs)
        self.pt_overflow, self.obs_overflow = int(pt_over), int(obs_over)
        self.ba_mse = float(mse)
        info.update(world_points=self.n_pts, observations=self.n_obs, ba_mse=self.ba_mse,
                    pt_overflow=self.pt_overflow, obs_overflow=self.obs_overflow)
