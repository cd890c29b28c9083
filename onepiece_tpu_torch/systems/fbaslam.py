"""FBASlam: sparse keyframe odometry, loop closure and pose-graph optimisation,
with the frame loop on the host.

Port of `onepiece_tpu/systems/fbaslam.py` (ref: example/FBAFusion/FBASlam.
{h,cpp}, main program FBAFusion.cpp:10-105):

  per frame:
    - track against the last keyframe (ref FBASlam.cpp:23);
    - a keyframe when the average inlier disparity >= 30 px (ref :32-41);
    - on a keyframe: loop-closure candidates from the descriptor database
      (ref :73), each re-tracked into a graph edge (ref :81-123), the
      keyframe inserted, the pose graph over the keyframes (ref :140-147),
      every frame re-anchored (`UpdateAllPoses`);
    - relocalisation against loop-closure candidates when tracking fails
      (ref :103-108).

The device work (features, matching, RANSAC, MILD scores, the pose-graph
Gauss-Newton) runs on `device`: on the card, the Hamming kernel under every
match and every MILD query. The control flow is the host's and reads the
device where it decides: one read of a track's scalar summary, one of an
edge's correspondences, one of a query's similarity vector.
`process_chunk` tracks a chunk of frames with `sparse_chunk_scan` (no host
read inside it), fetches its results once, and batches the chunk's
loop-closure queries and candidate tracks. The production sparse system is
`systems/fused_sparse.FusedFBASlam`; this one is the reference-shaped
system that the fused path is held against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..lcdetection.mild import LoopClosureDetector
from ..odometry import sparse
from ..optimization import posegraph
from .fused_sparse import fetch
from .keyframe_slam import KEYFRAME_DISPARITY, KeyframeSlamState

MAX_EDGE_CORRS = 256
MAX_REPROJECTION_ERROR_3D = 0.05  # ref: KeyframeBasedSlam.h:58 (normalised err / z)


def stack_frames(frames: list[sparse.SparseFrame]) -> sparse.SparseFrame:
    """SparseFrames stacked along a new leading axis."""
    return sparse.zip_frames(lambda *a: torch.stack(a), *frames)


@dataclasses.dataclass
class HostLoopSlam:
    """What the host-loop systems share: the keyframe bookkeeping, the MILD
    database, the seeded draws, the one-read track and the frame loop
    (`update_frame`, `process_chunk`). A system says what a keyframe's
    correspondences become through the hooks (`_link`, `_accept_loop`,
    `_keyframe_added`, `_after_keyframes`) and the fields they read
    (CORR_FIELDS, KEEPS_UV). `device` "cuda" (the default) runs the kernels,
    "cpu" their plain versions."""

    camera: PinholeCamera
    max_keypoints: int = 1000
    fast_threshold: float = 0.01
    keyframe_disparity: float = KEYFRAME_DISPARITY
    device: str | torch.device = "cuda"

    CORR_FIELDS = ()  # the track fields a keyframe's link reads
    KEEPS_UV = False  # whether a new keyframe's keypoint pixels come back with them

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.state = KeyframeSlamState(self.camera)
        self.lcd = LoopClosureDetector(device=self.device)
        self.keyframe_frames: list[sparse.SparseFrame] = []
        self.keyframe_poses: list[np.ndarray] = []  # world-from-keyframe
        self.frame_count = 0
        self.lc_edges = 0  # loop-closure edges (or linked pairs) added
        self._rng = np.random.default_rng(0)

    def _generator(self) -> torch.Generator:
        """A generator on the device, seeded from the system's numpy stream."""
        return torch.Generator(device=self.device).manual_seed(int(self._rng.integers(0, 2**31)))

    def _as_frames(self, grays, depths) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(grays, dtype=torch.float32).to(self.device),
                torch.as_tensor(depths, dtype=torch.float32).to(self.device))

    def _extract(self, gray, depth) -> sparse.SparseFrame:
        gray, depth = self._as_frames(gray, depth)
        return sparse.extract_sparse_frame(gray, depth, self.camera, max_keypoints=self.max_keypoints,
                                           threshold=self.fast_threshold)

    def _track(self, src: sparse.SparseFrame, tgt: sparse.SparseFrame):
        """Track, then read the scalar summary back in ONE copy: (the result
        on the device, the summary on the host)."""
        res, summ = sparse.sparse_tracking_with_summary(src, tgt, self.camera, self._generator())
        h = fetch(*summ)
        return res, sparse.TrackingSummary(h[0].astype(np.float32), bool(h[1]), float(h[2]), int(h[3]),
                                           float(h[4]))

    def _bootstrap(self, frame: sparse.SparseFrame) -> None:
        """Frame 0 is keyframe 0, at the identity."""
        self.keyframe_frames.append(frame)
        self.keyframe_poses.append(np.eye(4, dtype=np.float32))
        self.state.promote_keyframe(0)
        self.lcd.insert(frame.kp.desc, frame.valid)
        self.state.add_frame(np.eye(4), 0, np.eye(4), True)

    def _relocalise(self, frame, kf_idx, res, summ):
        """After a failed track, the first loop-closure candidate that tracks
        (ref :103-108): (keyframe index, result, summary, success)."""
        for cand in self.lcd.select_candidates(frame.kp.desc, frame.valid, exclude_recent=0):
            res_c, summ_c = self._track(self.keyframe_frames[cand], frame)
            if summ_c.success:
                return cand, res_c, summ_c, True
        return kf_idx, res, summ, False

    def _scan_chunk(self, grays, depths, extra: tuple = (), with_uv: bool = False):
        """Extract a chunk, bootstrap on frame 0, run the keyframe scan and
        fetch its results in ONE copy: (frames, k, fetched dict) or None when
        the chunk was only the bootstrap frame. `extra` names more ChunkScanOut
        fields to fetch besides the scalars; `with_uv` adds the frames'
        keypoint pixels ("uv")."""
        grays, depths = self._as_frames(grays, depths)
        k = int(grays.shape[0])
        frames = sparse.extract_sparse_frames_batch(grays, depths, self.camera, max_keypoints=self.max_keypoints,
                                                    threshold=self.fast_threshold)
        if self.frame_count == 0:
            self._bootstrap(sparse.map_frame(lambda a: a[0], frames))
            self.frame_count = 1
            frames = sparse.map_frame(lambda a: a[1:], frames)
            k -= 1
            if k == 0:
                return None
        _, outs = sparse.sparse_chunk_scan(
            self.keyframe_frames[-1], torch.from_numpy(self.keyframe_poses[-1]).to(self.device), frames,
            self.camera, self._generator(), self.keyframe_disparity)
        names = ("T_world", "is_kf", "success", "promote_prev") + extra
        tensors = [getattr(outs, n) for n in names] + ([frames.kp.uv] if with_uv else [])
        h = dict(zip(names + ("uv",), fetch(*tensors)))
        h["T_world"] = h["T_world"].astype(np.float32)
        is_kf, ok, pp = (h[n].astype(bool) for n in ("is_kf", "success", "promote_prev"))
        # failure recovery: frame i-1 promoted when frame i lost tracking (see sparse_chunk_scan)
        for i in np.nonzero(pp)[0]:
            if i >= 1 and not is_kf[i - 1] and ok[i - 1]:
                is_kf[i - 1] = True
        h["is_kf"], h["success"] = is_kf, ok
        return frames, k, h

    def _lc_pairs(self, new_kf_global: list[int]) -> list[tuple[int, int]]:
        """The chunk's loop-closure candidate pairs (candidate, new keyframe):
        one batched MILD query for the new keyframes."""
        descs = torch.stack([self.keyframe_frames[g].kp.desc for g in new_kf_global])
        valids = torch.stack([self.keyframe_frames[g].valid for g in new_kf_global])
        sims = self.lcd.similarity_batch(descs, valids)
        return [(cand, g) for q, g in enumerate(new_kf_global)
                for cand in self.lcd.candidates_from_sims(sims[q], limit=g - 1)]

    def _track_pairs(self, pairs: list[tuple[int, int]]):
        """Track the pairs, generator p seeded `seed + p`: (results, summaries)
        on the device. The JAX package pads the batch to a power of two so
        that its `lax.map` compiles few shapes; a loop of eager calls needs
        no padding, and the real pairs' draws are the same without it."""
        seed = int(self._rng.integers(0, 2**31))
        gens = [torch.Generator(device=self.device).manual_seed(seed + p) for p in range(len(pairs))]
        return sparse.track_pairs_batch(stack_frames([self.keyframe_frames[c] for c, _ in pairs]),
                                        stack_frames([self.keyframe_frames[g] for _, g in pairs]),
                                        self.camera, generators=gens)

    # -- what each system does with a keyframe (the hooks) ------------------

    def _link(self, src_kf: int, dst_kf: int, corr: dict) -> int | None:
        """Join keyframe `dst_kf` to `src_kf` by a track's correspondences
        (`corr`: the CORR_FIELDS as host arrays)."""
        raise NotImplementedError

    def _accept_loop(self, success, rmse):
        """Whether a loop-closure track (scalars or arrays) is linked."""
        return success

    def _keyframe_added(self, uv: np.ndarray | None) -> None:
        """A keyframe was appended; `uv` its keypoint pixels when KEEPS_UV."""

    def _after_keyframes(self, new_kfs: list[int]) -> None:
        """The optimisation after a frame's or a chunk's new keyframes."""
        raise NotImplementedError

    # -- the frame loop -----------------------------------------------------

    def _fetch_corr(self, res, uv: torch.Tensor | None = None) -> tuple[dict, np.ndarray | None]:
        """A track's CORR_FIELDS and, with `uv`, the keypoint pixels of its
        frame, read back in ONE copy."""
        h = fetch(*[getattr(res, n) for n in self.CORR_FIELDS], *(() if uv is None else (uv,)))
        return dict(zip(self.CORR_FIELDS, h)), (None if uv is None else h[-1].astype(np.float32))

    def _promote(self, fidx: int, frame: sparse.SparseFrame, T_world: np.ndarray, uv) -> int:
        """Frame `fidx` becomes a keyframe: its index."""
        new_kf = len(self.keyframe_frames)
        self.keyframe_frames.append(frame)
        self.keyframe_poses.append(T_world.astype(np.float32))
        self._keyframe_added(uv)
        self.state.promote_keyframe(fidx)
        return new_kf

    def update_frame(self, gray, depth) -> dict:
        """Process one frame; returns a metrics dict (frame, keyframe?, success, ...)."""
        fidx = self.frame_count
        self.frame_count += 1
        frame = self._extract(gray, depth)
        if fidx == 0:
            self._bootstrap(frame)
            return {"frame": 0, "keyframe": True, "success": True}

        kf_idx = len(self.keyframe_frames) - 1
        res, summ = self._track(self.keyframe_frames[kf_idx], frame)
        success = summ.success
        if not success:
            kf_idx, res, summ, success = self._relocalise(frame, kf_idx, res, summ)
        if not success:
            # keep the last pose (constant-position fallback); mark the failure
            last = self.state.poses[-1]
            self.state.add_frame(last, kf_idx, np.linalg.inv(self.keyframe_poses[kf_idx]) @ last, False)
            return {"frame": fidx, "keyframe": False, "success": False}

        T_rel = np.linalg.inv(summ.T_ts)  # the frame in keyframe coordinates
        T_world = self.keyframe_poses[kf_idx] @ T_rel
        self.state.add_frame(T_world, kf_idx, T_rel, True)
        disp = summ.disparity
        if disp < self.keyframe_disparity:  # the keyframe decision (ref :32-41)
            return {"frame": fidx, "keyframe": False, "success": True, "disparity": disp}

        corr, uv = self._fetch_corr(res, frame.kp.uv if self.KEEPS_UV else None)
        new_kf = self._promote(fidx, frame, T_world, uv)
        linked = self._link(kf_idx, new_kf, corr)
        # loop-closure links (ref :73-123)
        for cand in self.lcd.select_candidates(frame.kp.desc, frame.valid):
            if cand == kf_idx:
                continue
            res_c, summ_c = self._track(self.keyframe_frames[cand], frame)
            if self._accept_loop(summ_c.success, summ_c.rmse):
                self._link(cand, new_kf, self._fetch_corr(res_c)[0])
                self.lc_edges += 1
        self.lcd.insert(frame.kp.desc, frame.valid)
        self._after_keyframes([new_kf])
        return {"frame": fidx, "keyframe": True, "success": True, "disparity": disp, "linked": linked}

    def process_chunk(self, grays, depths) -> dict:
        """Process K frames (K, H, W): the keyframe scan of the whole chunk on
        the device and one fetch of its results, the promotion walk on the
        host, the chunk's loop-closure queries and candidate tracks batched,
        then the optimisation (loop closure deferred by at most one chunk
        against the reference's per-keyframe schedule). A frame that loses
        tracking keeps the previous pose (no relocalisation in a chunk)."""
        scanned = self._scan_chunk(grays, depths, self.CORR_FIELDS, with_uv=self.KEEPS_UV)
        if scanned is None:
            return {"frames": 1, "keyframes": 1}
        frames, k, h = scanned
        T_world, is_kf, ok = h["T_world"], h["is_kf"], h["success"]
        new_kf_global = []
        for i in range(k):
            fidx = self.frame_count
            self.frame_count += 1
            src_kf = len(self.keyframe_frames) - 1
            self.state.add_frame(T_world[i], src_kf, np.linalg.inv(self.keyframe_poses[src_kf]) @ T_world[i],
                                 bool(ok[i]))
            if not is_kf[i]:
                continue
            frame_i = sparse.map_frame(lambda a: a[i], frames)
            new_kf = self._promote(fidx, frame_i, T_world[i], h["uv"][i] if self.KEEPS_UV else None)
            self._link(src_kf, new_kf, {n: h[n][i] for n in self.CORR_FIELDS})
            self.lcd.insert(frame_i.kp.desc, frame_i.valid)
            new_kf_global.append(new_kf)

        if new_kf_global:
            pairs = self._lc_pairs(new_kf_global)
            if pairs:
                res_b, summ_b = self._track_pairs(pairs)
                succ, rmse = fetch(summ_b.success, summ_b.rmse)
                good = np.nonzero(self._accept_loop(succ.astype(bool), rmse))[0]
                if len(good):
                    gi = torch.as_tensor(good, device=self.device)
                    got = fetch(*[getattr(res_b, n)[gi] for n in self.CORR_FIELDS])
                    for n, b in enumerate(good):
                        self._link(*pairs[int(b)], {f: v[n] for f, v in zip(self.CORR_FIELDS, got)})
                    self.lc_edges += len(good)
        self._after_keyframes(new_kf_global)
        return {"frames": self.frame_count, "keyframes": len(self.keyframe_frames)}

    def trajectory(self) -> np.ndarray:
        return self.state.trajectory()


@dataclasses.dataclass
class FBASlam(HostLoopSlam):
    CORR_FIELDS = ("corr_src", "corr_dst", "corr_valid")

    def __post_init__(self):
        super().__post_init__()
        self.edges: list[dict] = []

    def _link(self, src_kf: int, dst_kf: int, corr: dict) -> None:
        """An edge of the first MAX_EDGE_CORRS valid correspondences."""
        v = corr["corr_valid"].astype(bool)
        self.edges.append({"src": src_kf, "dst": dst_kf,
                           "p_src": corr["corr_src"][v][:MAX_EDGE_CORRS].astype(np.float32),
                           "p_dst": corr["corr_dst"][v][:MAX_EDGE_CORRS].astype(np.float32)})

    def _accept_loop(self, success, rmse):
        # loop edges carry far more leverage than odometry edges: gated on
        # the reference's reprojection rmse too (ref FBASlam.cpp:99)
        return success & (rmse < MAX_REPROJECTION_ERROR_3D)

    def _after_keyframes(self, new_kfs: list[int]) -> None:
        if new_kfs:
            self.optimize()

    def optimize(self, iters: int = posegraph.DEFAULT_ITERS) -> None:
        """Pose-graph Gauss-Newton over the keyframes, then every frame
        re-anchored (ref FBASlam.cpp:140-147 `Optimize`)."""
        n = len(self.keyframe_poses)
        if n < 2 or not self.edges:
            return
        edges = posegraph.build_edges(self.edges, corr_capacity=MAX_EDGE_CORRS, device=self.device)
        poses = torch.from_numpy(np.stack(self.keyframe_poses)).to(self.device)
        opt = posegraph.optimize_pose_graph(poses, edges, iters=iters)[0].cpu().numpy()
        self.keyframe_poses = [opt[i] for i in range(n)]
        self.state.update_all_poses(opt)
