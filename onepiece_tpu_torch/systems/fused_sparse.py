"""Sparse keyframe SLAM (FBAFusion) with the keyframe database, the edge store
and the pose graph on the device.

Port of `onepiece_tpu/systems/fused_sparse.py` (`EdgeStore`,
`SparseDevState`, `SparseChunkOut`, `make_state`, `_compact_corr`,
`_append_edge`, `_write_kf`, `_sparse_chunk_body`, `FusedFBASlam`). Per
chunk of K frames:

  1. features of the whole chunk in one batched pass (FAST, BRIEF);
  2. the tracking loop, frame by frame, against the current keyframe, with
     the failure ladder: rung A re-tracks against the previous frame and
     promotes it; rung B relocalises against the best MILD candidate; rung C
     re-bootstraps a keyframe after REBASE_AFTER failures; keyframes are
     promoted on the disparity trigger;
  3. MILD loop-closure candidates for every new keyframe;
  4. tracking of the candidate pairs and the edge append;
  5. pose-graph Gauss-Newton over all keyframes;
  6. re-anchoring of the carried pose.

The JAX package runs the chunk as one program of `lax.scan`, `lax.cond`
and `while_loop`s. Here the loop is Python over device tensors, and each
device branch is either computed and chosen with `torch.where` (the
re-match gate, the promotions and the edge appends, which write through a
clamped row index with the old row kept where the condition is false, as
the JAX package's `mode="drop"` writes keep it) or decided by a host read.
The host reads are: one per frame (whether rung A or rung B may be needed:
both run only when tracking failed), one per chunk for the promoted
keyframes, one per chunk for the loop-closure pairs that passed the salient
test, and the one fetch of the chunk's results. The very first frame is the
bootstrap keyframe, which the host knows without a read. (The refits'
3x3 SVDs wait for the device too; they are counted on the card.) State
tensors are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..lcdetection import mild
from ..odometry import features as feat
from ..odometry import sparse
from ..optimization import posegraph

KEYFRAME_DISPARITY = 30.0  # px: the reference's keyframe trigger (FBASlam.cpp:36-37)
MAX_EDGE_CORRS = 256
MAX_REPROJECTION_ERROR_3D = 0.05  # ref: KeyframeBasedSlam.h:58
DEFAULT_HYPOTHESES = 256  # batched RANSAC hypotheses
REBASE_AFTER = 3  # consecutive failures before re-bootstrapping a keyframe
REMATCH_BELOW = 80  # odometry tracks keep round 1 when it has this many inliers


class EdgeStore(NamedTuple):
    """Pose-graph edges on the device (capacity E_CAP, C correspondences each)."""

    src: torch.Tensor  # (E,) int64
    dst: torch.Tensor  # (E,) int64
    p_src: torch.Tensor  # (E, C, 3)
    p_dst: torch.Tensor  # (E, C, 3)
    valid: torch.Tensor  # (E, C) bool
    src_i: torch.Tensor  # (E, C) int64 source keypoint index per corr
    dst_j: torch.Tensor  # (E, C) int64 matched target keypoint index
    num: torch.Tensor  # () int64
    overflow: torch.Tensor  # () int64


class SparseDevState(NamedTuple):
    """The whole sparse-SLAM state on the device."""

    kf: sparse.SparseFrame  # leaves (N_CAP, ...): the keyframe DB and MILD's database
    kf_pose: torch.Tensor  # (N_CAP, 4, 4) world-from-keyframe
    num_kf: torch.Tensor  # () int64
    cur_kf: torch.Tensor  # () int64 keyframe tracked against
    edges: EdgeStore
    last_T: torch.Tensor  # (4, 4) last frame's world pose
    last_anchor: torch.Tensor  # () int64
    last_Trel: torch.Tensor  # (4, 4)
    prev: sparse.SparseFrame  # previous frame
    prev_ok: torch.Tensor  # () bool: prev tracked fine AND is not a keyframe
    prev_anchor: torch.Tensor  # () int64 keyframe prev tracked against
    prev_Trel: torch.Tensor  # (4, 4) anchor-relative pose of prev
    prev_psrc: torch.Tensor  # (C, 3) compacted correspondences of prev
    prev_pdst: torch.Tensor  # (C, 3)
    prev_pval: torch.Tensor  # (C,)
    prev_si: torch.Tensor  # (C,) int64
    prev_dj: torch.Tensor  # (C,) int64
    fail_streak: torch.Tensor  # () int64 consecutive tracking failures


class SparseChunkOut(NamedTuple):
    """What a chunk hands back: the host trajectory's records and counters."""

    T_rel: torch.Tensor  # (K, 4, 4) anchor-relative pose per frame
    anchor: torch.Tensor  # (K,) keyframe index per frame
    ok: torch.Tensor  # (K,) bool
    is_kf: torch.Tensor  # (K,) bool
    retro: torch.Tensor  # (K,) bool: prev frame retro-promoted here
    reloc: torch.Tensor  # (K,) bool: frame recovered via LC relocalisation
    rmse: torch.Tensor  # (K,)
    disparity: torch.Tensor  # (K,)
    kf_pose: torch.Tensor  # (N_CAP, 4, 4) after the pose graph
    num_kf: torch.Tensor  # ()
    num_edges: torch.Tensor  # ()
    edge_overflow: torch.Tensor  # ()
    lc_edges: torch.Tensor  # () loop edges appended this chunk


def fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy several device tensors to the host in ONE transfer (float64
    holds every float32, int and bool value exactly)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at : at + n].reshape(tuple(t.shape)))
        at += n
    return out


def _zero_frame(f: int, device) -> sparse.SparseFrame:
    z = dict(dtype=torch.float32, device=device)
    kp = feat.Keypoints(
        uv=torch.zeros((f, 2), **z), score=torch.zeros((f,), **z), angle=torch.zeros((f,), **z),
        desc=torch.zeros((f, 8), dtype=torch.int32, device=device),
        valid=torch.zeros((f,), dtype=torch.bool, device=device),
    )
    return sparse.SparseFrame(kp, torch.zeros((f, 3), **z), torch.zeros((f,), dtype=torch.bool, device=device))


def make_state(n_cap: int, e_cap: int, corr_cap: int, f: int, device) -> SparseDevState:
    zf = _zero_frame(f, device)
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return SparseDevState(
        kf=sparse.map_frame(lambda a: a[None].repeat((n_cap,) + (1,) * a.ndim), zf),
        kf_pose=torch.eye(4, **f32).repeat(n_cap, 1, 1),
        num_kf=torch.zeros((), **i64),
        cur_kf=torch.zeros((), **i64),
        edges=EdgeStore(
            src=torch.zeros((e_cap,), **i64), dst=torch.zeros((e_cap,), **i64),
            p_src=torch.zeros((e_cap, corr_cap, 3), **f32), p_dst=torch.zeros((e_cap, corr_cap, 3), **f32),
            valid=torch.zeros((e_cap, corr_cap), dtype=torch.bool, device=device),
            src_i=torch.zeros((e_cap, corr_cap), **i64), dst_j=torch.zeros((e_cap, corr_cap), **i64),
            num=torch.zeros((), **i64), overflow=torch.zeros((), **i64),
        ),
        last_T=torch.eye(4, **f32),
        last_anchor=torch.zeros((), **i64),
        last_Trel=torch.eye(4, **f32),
        prev=zf,
        prev_ok=torch.zeros((), dtype=torch.bool, device=device),
        prev_anchor=torch.zeros((), **i64),
        prev_Trel=torch.eye(4, **f32),
        prev_psrc=torch.zeros((corr_cap, 3), **f32),
        prev_pdst=torch.zeros((corr_cap, 3), **f32),
        prev_pval=torch.zeros((corr_cap,), dtype=torch.bool, device=device),
        prev_si=torch.zeros((corr_cap,), **i64),
        prev_dj=torch.zeros((corr_cap,), **i64),
        fail_streak=torch.zeros((), **i64),
    )


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d device index, without a host read."""
    return t.index_select(0, i.reshape(1))[0]


def _put_row(buf: torch.Tensor, i: torch.Tensor, cond: torch.Tensor, val: torch.Tensor) -> None:
    """buf[i] = val where cond (in place); where cond is false or i is past
    the end, buf keeps its rows (the JAX package's `mode="drop"`)."""
    n = buf.shape[0]
    cond = cond & (i < n)
    w = torch.clamp(i, 0, n - 1).reshape(1)
    buf.index_copy_(0, w, torch.where(cond, val, buf.index_select(0, w)[0])[None])


def _compact_corr(corr_src, corr_dst, corr_valid, corr_idx, c: int):
    """The first `c` valid correspondences, in order, at a fixed shape:
    (src_pts, dst_pts, valid, src_kp_idx, dst_kp_idx); slots past the count
    take row 0, as `jnp.nonzero(size=c, fill_value=0)` fills them."""
    n = corr_valid.shape[0]
    rank = torch.cumsum(corr_valid.to(torch.int64), 0) - 1
    pos = torch.where(corr_valid & (rank < c), rank, c)  # the rest spill into slot c, cut below
    ci = torch.zeros(c + 1, dtype=torch.int64, device=corr_valid.device)
    ci.scatter_(0, pos, torch.arange(n, device=corr_valid.device))
    ci = ci[:c]
    cv = torch.arange(c, device=corr_valid.device) < torch.sum(corr_valid.to(torch.int64))
    return corr_src[ci], corr_dst[ci], cv, ci, corr_idx[ci]


def _append_edge(edges: EdgeStore, cond, src, dst, ps, pd, pv, si, dj) -> EdgeStore:
    """Append one edge where cond (in place); past the capacity it counts an
    overflow instead."""
    e_cap = edges.src.shape[0]
    fits = cond & (edges.num < e_cap)
    for buf, val in zip(edges[:7], (src, dst, ps, pd, pv, si, dj)):
        _put_row(buf, edges.num, fits, val)
    return edges._replace(num=edges.num + fits.to(torch.int64),
                          overflow=edges.overflow + (cond & ~fits).to(torch.int64))


def _write_kf(kf_db: sparse.SparseFrame, kf_pose, cond, idx, frame: sparse.SparseFrame, pose) -> None:
    """Store a keyframe and its pose at row idx where cond (in place)."""
    sparse.zip_frames(lambda db, row: _put_row(db, idx, cond, row), kf_db, frame)
    _put_row(kf_pose, idx, cond, pose)


def _zero_track(f: int, device):
    """The (SparseTrackingResult, TrackingSummary) of a track that did not run."""
    eye = torch.eye(4, dtype=torch.float32, device=device)
    zero_i = torch.zeros((), dtype=torch.int64, device=device)
    inf = torch.full((), torch.inf, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)
    res = sparse.SparseTrackingResult(
        T_ts=eye, num_inliers=zero_i, rmse=inf, success=false,
        corr_src=torch.zeros((f, 3), device=device), corr_dst=torch.zeros((f, 3), device=device),
        corr_valid=torch.zeros((f,), dtype=torch.bool, device=device),
        corr_idx=torch.zeros((f,), dtype=torch.int64, device=device),
    )
    return res, sparse.TrackingSummary(eye, false, inf, zero_i, torch.zeros((), device=device))


@dataclasses.dataclass
class FusedFBASlam:
    """Sparse keyframe SLAM, chunk by chunk, with its state on the device.
    `device` "cuda" (the default) runs the kernels, "cpu" their plain
    versions. The host keeps per-frame (anchor, relative pose) records and
    the latest keyframe poses to assemble the trajectory (the reference's
    `UpdateAllPoses` re-anchoring, ref: KeyframeBasedSlam.h:36-45)."""

    camera: PinholeCamera
    max_keypoints: int = 1000
    fast_threshold: float = 0.01
    keyframe_disparity: float = KEYFRAME_DISPARITY
    num_hypotheses: int = DEFAULT_HYPOTHESES
    kf_capacity: int = 64
    edge_capacity: int = 512
    corr_capacity: int = MAX_EDGE_CORRS
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._state = make_state(self.kf_capacity, self.edge_capacity, self.corr_capacity,
                                 self.max_keypoints, self.device)
        self.frame_count = 0
        self.num_kf = 0
        self.num_edges = 0
        self.edge_overflow = 0
        self.lc_edges_total = 0
        self.capacity_doublings = 0
        self.lc_pairs = 0  # candidate pairs tracked in the last chunk
        self.host_reads = 0  # the reads this class makes (the SVDs' waits not included)
        self._anchors: list[int] = []
        self._Trels: list[np.ndarray] = []
        self._ok: list[bool] = []
        self._iskf: list[bool] = []
        self._kf_pose = np.tile(np.eye(4, dtype=np.float32), (self.kf_capacity, 1, 1))
        self._rng = np.random.default_rng(0)

    # -- capacity ----------------------------------------------------------

    def _maybe_grow(self, next_k: int) -> None:
        """Double the keyframe and edge capacities while the next chunk could
        overflow them (`while`: a large chunk may need several doublings)."""
        st = self._state
        while self.num_kf + 2 * next_k + 2 > self.kf_capacity:
            n = self.kf_capacity
            st = st._replace(
                kf=sparse.map_frame(lambda a: torch.cat([a, torch.zeros_like(a)]), st.kf),
                kf_pose=torch.cat([st.kf_pose, torch.eye(4, device=self.device).repeat(n, 1, 1)]),
            )
            self.kf_capacity *= 2
            self.capacity_doublings += 1
        # worst case per chunk: 2K promotions x (1 odometry + 7 LC) edges
        while self.num_edges + 2 * next_k * (mild.MAX_CANDIDATES + 1) > self.edge_capacity:
            e = st.edges
            st = st._replace(edges=EdgeStore(
                *(torch.cat([a, torch.zeros_like(a)]) for a in e[:7]), num=e.num, overflow=e.overflow))
            self.edge_capacity *= 2
            self.capacity_doublings += 1
        self._state = st

    # -- one chunk on the device -----------------------------------------------

    def _track(self, gen, source, target, rematch_below=None):
        return sparse._track_summary_inner(gen, source, target, self.camera, self.num_hypotheses,
                                           rematch_below=rematch_below)

    def _frame(self, st: SparseDevState, frame_i: sparse.SparseFrame, boot: bool, gen, consts) -> tuple:
        """One step of the tracking loop: (new state, per-frame outputs)."""
        eye, thr = consts["eye"], self.keyframe_disparity
        c_corr = self.corr_capacity
        n_cap = self.kf_capacity
        zero = consts["zero_track"]
        boot_t = torch.full((), boot, dtype=torch.bool, device=self.device)

        if boot:
            res0, summ0 = zero
        else:
            kf_frame = sparse.map_frame(lambda a: _row(a, st.cur_kf), st.kf)
            res0, summ0 = self._track(gen, kf_frame, frame_i, REMATCH_BELOW)
        ok0 = ~boot_t & summ0.success

        # the failure ladder: ONE host read says which rungs may be needed
        need_a = ~boot_t & ~ok0 & st.prev_ok
        may_b = ~boot_t & ~ok0 & (st.num_kf >= 3)
        run_a, run_b = (bool(x) for x in fetch(need_a, may_b))
        self.host_reads += 1

        # rung A: re-track against the previous (non-keyframe) frame
        res_a, summ_a = self._track(gen, st.prev, frame_i, REMATCH_BELOW) if run_a else zero
        use_a = need_a & summ_a.success & (st.num_kf < n_cap)

        # rung B: relocalise against the best-scoring keyframe (no salient
        # gate: tracking success is the check)
        if run_b:
            cand, _ = mild.lc_candidates_device(
                frame_i.kp.desc, frame_i.valid, st.kf.kp.desc, st.kf.valid,
                g=st.num_kf, limit=st.num_kf, exclude=consts["minus_one"],
            )
            c0 = cand[0]
            res_b, summ_b = self._track(gen, sparse.map_frame(lambda a: _row(a, c0), st.kf), frame_i)
        else:
            c0 = consts["zero"]
            res_b, summ_b = zero
        use_b = may_b & ~use_a & summ_b.success

        # retro-promotion of prev (rung A): prev becomes a keyframe
        new_idx_a = st.num_kf
        prev_T = _row(st.kf_pose, st.prev_anchor) @ st.prev_Trel
        _write_kf(st.kf, st.kf_pose, use_a, new_idx_a, st.prev, prev_T)
        edges = _append_edge(st.edges, use_a, st.prev_anchor, new_idx_a, st.prev_psrc, st.prev_pdst,
                             st.prev_pval, st.prev_si, st.prev_dj)
        num_kf = st.num_kf + use_a.to(torch.int64)
        promo_a = torch.where(use_a, new_idx_a, -1)
        promo_a_src = st.prev_anchor

        # the effective track (main | rung A | rung B)
        ok = ok0 | use_a | use_b
        anchor = torch.where(use_a, new_idx_a, torch.where(use_b, c0, st.cur_kf))

        def pick(a, b, base):
            return torch.where(use_a, a, torch.where(use_b, b, base))

        T_ts, rmse, disp = (pick(x, y, z) for x, y, z in zip(
            (summ_a.T_ts, summ_a.rmse, summ_a.disparity), (summ_b.T_ts, summ_b.rmse, summ_b.disparity),
            (summ0.T_ts, summ0.rmse, summ0.disparity)))
        csrc, cdst, cval, cidx = (pick(x, y, z) for x, y, z in zip(res_a[4:], res_b[4:], res0[4:]))
        psrc_c, pdst_c, pval_c, si_c, dj_c = _compact_corr(csrc, cdst, cval, cidx, c_corr)

        anchor_pose = _row(st.kf_pose, anchor)
        T_world = torch.where(ok, anchor_pose @ sparse.se3_inverse(T_ts), st.last_T)
        T_world = torch.where(boot_t, eye, T_world)

        # rung C: re-bootstrap a keyframe at the carried pose after persistent failure
        rebase = (~boot_t & ~ok & (st.fail_streak >= REBASE_AFTER)
                  & (torch.sum(frame_i.valid.to(torch.int64)) >= sparse.MIN_INLIERS) & (num_kf < n_cap))

        # keyframe promotion (disparity trigger, ref FBASlam.cpp:32-41)
        is_kf = boot_t | rebase | (ok & (disp >= thr) & (num_kf < n_cap))
        new_idx = num_kf
        _write_kf(st.kf, st.kf_pose, is_kf, new_idx, frame_i, T_world)
        edges = _append_edge(edges, is_kf & ~boot_t & ~rebase, anchor, new_idx,
                             psrc_c, pdst_c, pval_c, si_c, dj_c)
        num_kf = num_kf + is_kf.to(torch.int64)
        promo_b = torch.where(is_kf & ~boot_t, new_idx, -1)
        anchor_out = torch.where(is_kf, new_idx, anchor)
        T_rel = torch.where(is_kf, eye, sparse.se3_inverse(anchor_pose) @ T_world)
        ok_out = ok | boot_t

        st = st._replace(
            num_kf=num_kf, cur_kf=anchor_out, edges=edges, last_T=T_world, last_anchor=anchor_out,
            last_Trel=T_rel, prev=frame_i, prev_ok=ok_out & ~is_kf, prev_anchor=anchor, prev_Trel=T_rel,
            prev_psrc=psrc_c, prev_pdst=pdst_c, prev_pval=pval_c, prev_si=si_c, prev_dj=dj_c,
            fail_streak=torch.where(ok_out | rebase, 0, st.fail_streak + 1),
        )
        out = (T_rel, anchor_out, ok_out, is_kf, use_a, use_b, rmse, disp,
               promo_a, promo_a_src, promo_b, anchor)
        return st, out

    def _chunk(self, grays: torch.Tensor, depths: torch.Tensor, gen: torch.Generator) -> SparseChunkOut:
        k = grays.shape[0]
        dev = self.device
        consts = dict(eye=torch.eye(4, dtype=torch.float32, device=dev),
                      zero=torch.zeros((), dtype=torch.int64, device=dev),
                      minus_one=torch.full((), -1, dtype=torch.int64, device=dev),
                      zero_track=_zero_track(self.max_keypoints, dev))

        # 1. features of the whole chunk
        frames = sparse.extract_sparse_frames_batch(grays, depths, self.camera,
                                                    max_keypoints=self.max_keypoints,
                                                    threshold=self.fast_threshold)
        # 2. the tracking loop
        st = self._state
        outs = []
        for i in range(k):
            frame_i = sparse.map_frame(lambda a: a[i].clone(), frames)
            boot = self.frame_count == 0 and i == 0  # the first frame is keyframe 0
            st, out = self._frame(st, frame_i, boot, gen, consts)
            outs.append(out)
        (T_rel, anchor, ok, is_kf, retro, reloc, rmse, disp,
         pa, pa_src, pb, pb_src) = (torch.stack(x) for x in zip(*outs))

        # 3. loop-closure candidates for every new keyframe (one host read)
        promo = torch.cat([pa, pb])
        promo_src = torch.cat([pa_src, pb_src])
        (promo_h,) = fetch(promo)
        self.host_reads += 1
        promoted = np.nonzero(promo_h >= 0)[0].tolist()
        m = mild.MAX_CANDIDATES
        pairs = []  # (candidate, query) device scalars, pair_ok
        oks = []
        for q in promoted:
            g = promo[q]
            cand, cok = mild.lc_candidates_device(
                _row(st.kf.kp.desc, g), _row(st.kf.valid, g), st.kf.kp.desc, st.kf.valid,
                g=g, limit=g - 1, exclude=promo_src[q],
            )
            pairs.extend((cand[j], g) for j in range(m))
            oks.append(cok)

        # 4. loop-closure pair tracking and edge append (one host read)
        edges = st.edges
        lc_added = torch.zeros((), dtype=torch.int64, device=dev)
        n_pairs = 0
        if oks:
            (pair_ok,) = fetch(torch.cat(oks))
            self.host_reads += 1
            for p in np.nonzero(pair_ok)[0].tolist():
                c, g = pairs[p]
                res_p, summ_p = self._track(gen, sparse.map_frame(lambda a: _row(a, c), st.kf),
                                            sparse.map_frame(lambda a: _row(a, g), st.kf))
                succ = summ_p.success & (summ_p.rmse < MAX_REPROJECTION_ERROR_3D)
                ps, pd, pv, si, dj = _compact_corr(res_p.corr_src, res_p.corr_dst, res_p.corr_valid,
                                                   res_p.corr_idx, self.corr_capacity)
                edges = _append_edge(edges, succ, c, g, ps, pd, pv, si, dj)
                lc_added = lc_added + succ.to(torch.int64)
                n_pairs += 1
        st = st._replace(edges=edges)

        # 5. pose-graph Gauss-Newton over all keyframes (ref FBASlam.cpp:140-147)
        kf_pose = st.kf_pose
        if promoted:
            e = st.edges
            ev = torch.arange(e.src.shape[0], device=dev) < e.num
            opt, _ = posegraph.optimize_pose_graph(
                kf_pose, posegraph.PoseGraphEdges(e.src, e.dst, e.p_src, e.p_dst, e.valid, ev),
                iters=posegraph.DEFAULT_ITERS)
            kf_pose = torch.where((st.num_kf >= 2) & (e.num > 0), opt, kf_pose)

        # 6. re-anchor the carried pose to the optimised keyframe poses
        self._state = st._replace(kf_pose=kf_pose, last_T=_row(kf_pose, st.last_anchor) @ st.last_Trel)
        self.lc_pairs = n_pairs
        # each promotion appends at most one edge, each tracked pair one: a
        # bound on the edges this chunk appended, known on the host
        self._edge_bound = len(promoted) + n_pairs
        return SparseChunkOut(T_rel, anchor, ok, is_kf, retro, reloc, rmse, disp, kf_pose, st.num_kf,
                              st.edges.num, st.edges.overflow, lc_added)

    def _after_chunk(self, out: SparseChunkOut) -> tuple[SparseChunkOut, tuple]:
        """Device work after the front end, before the chunk's one fetch: the
        outputs, and extra device tensors to fetch with them (none here)."""
        return out, ()

    def _absorb(self, extra: list[np.ndarray], info: dict) -> None:
        """Take the fetched extra tensors into the host state and `info`."""

    # -- main entry ------------------------------------------------------------

    def process_chunk(self, grays, depths) -> dict:
        """Process K frames (grays and depths (K, H, W)); one fetch at the end."""
        grays = torch.as_tensor(grays, dtype=torch.float32).to(self.device)
        depths = torch.as_tensor(depths, dtype=torch.float32).to(self.device)
        k = int(grays.shape[0])
        if k == 0:
            return {"frames": self.frame_count, "keyframes": self.num_kf}
        # capacities grow as the JAX package's do, for its padded scan length
        self._maybe_grow(max(8, 1 << (k - 1).bit_length()))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._rng.integers(0, 2**31)))
        out, extra = self._after_chunk(self._chunk(grays, depths, gen))
        flat = fetch(*out, *extra)  # the one fetch of the chunk
        self.host_reads += 1
        h = SparseChunkOut(*flat[: len(out)])
        self.frame_count += k
        self.num_kf = int(h.num_kf)
        self.num_edges = int(h.num_edges)
        self.edge_overflow = int(h.edge_overflow)
        self.lc_edges_total += int(h.lc_edges)
        self._kf_pose = h.kf_pose.astype(np.float32)
        for i in range(k):
            self._anchors.append(int(h.anchor[i]))
            self._Trels.append(h.T_rel[i].astype(np.float32))
            self._ok.append(bool(h.ok[i]))
            self._iskf.append(bool(h.is_kf[i]))
        info = {
            "frames": self.frame_count, "keyframes": self.num_kf, "edges": self.num_edges,
            "lc_pairs": self.lc_pairs, "lc_edges": int(h.lc_edges),
            "relocs": int(np.sum(h.reloc)), "retro": int(np.sum(h.retro)),
        }
        self._absorb(flat[len(out):], info)
        return info

    def trajectory(self) -> np.ndarray:
        """Per-frame world poses, re-anchored to the latest keyframe poses."""
        if not self._anchors:
            return np.zeros((0, 4, 4), np.float32)
        return np.einsum("nij,njk->nik", self._kf_pose[np.asarray(self._anchors)], np.stack(self._Trels))
