"""Every sharded module of `parallel/` on one set of inputs, run on a rank.

The rank bodies that `tools/torch_launch_distributed.py`,
`tools/torch_scaling_test.py` and `chip_smoke.py` hand to `launch.spawn`,
and their inputs. Inputs are host arrays (they travel to each rank by
pickle), made once by the caller; each rank moves them to its device. Each
module returns, beside its results, the seconds it took, the bytes and time
of each collective it called (`comm.ShardGroup.stats`) and the launches of
each kernel (`_build` counts, per process: a rank counts its own).

Results that are large on the card (the pool, the mesh) come back as
SHA-256 digests with `keep_arrays=False`, so that worlds compare bit for
bit without the arrays crossing the process boundary.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from .. import _build
from ..geometry import se3
from ..geometry.camera import PinholeCamera
from ..integration import device_hash as dh
from ..odometry import dense
from ..optimization.posegraph import PoseGraphEdges
from ..ops import tsdf as tsdf_ops
from ..utils import synthetic
from . import ba as pba
from . import dense as pdense
from . import fused as pfused
from . import mc as pmc
from . import posegraph as ppg
from . import submap as psubmap
from . import tsdf as ptsdf
from .comm import ShardGroup

MODULES = ("psum", "dense", "tsdf", "fused", "mc", "ba", "posegraph")
PAIR_TWIST = (0.01, -0.01, 0.015, 0.01, -0.015, 0.008)  # the JAX tools' synthetic pair


def digest(a) -> str:
    a = np.ascontiguousarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def sorted_rows(a: np.ndarray) -> np.ndarray:
    f = a.reshape(len(a), -1)
    return f[np.lexsort(f.T[::-1])]


def _launches() -> dict:
    return {k.name: k.launches for k in _build.KERNELS}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _t(x, dev):
    return torch.as_tensor(np.asarray(x)).to(dev)


# ---------------------------------------------------------------------------
# inputs (host arrays, made once by the caller)
# ---------------------------------------------------------------------------


def render_pair(camera: PinholeCamera, device="cpu") -> dict:
    """The JAX tools' synthetic pair: identity, then the PAIR_TWIST pose."""
    scene = synthetic.default_scene(device)
    T1 = se3.se3_exp(torch.tensor(PAIR_TWIST, dtype=torch.float32, device=device))
    out = {}
    for name, T in (("src", torch.eye(4, device=device)), ("tgt", T1)):
        d, g = synthetic.render(scene, T, camera.fx, camera.fy, camera.cx, camera.cy, camera.height,
                                camera.width, num_steps=48)
        out[name + "_gray"], out[name + "_depth"] = g.cpu().numpy(), d.cpu().numpy()
    return out


def tsdf_inputs(camera: PinholeCamera, depth: np.ndarray, num_blocks: int) -> dict:
    """Blocks in front of the camera (seeded), the frame and a pose near the
    identity (a general pose: voxel centres then fall on no pixel boundary,
    where an identity pose puts many exactly on one)."""
    rng = np.random.default_rng(0)
    coords = np.stack([rng.integers(-4, 4, num_blocks), rng.integers(-3, 3, num_blocks),
                       rng.integers(1, 8, num_blocks)], -1).astype(np.int32)
    rgb = rng.uniform(0, 1, depth.shape + (3,)).astype(np.float32)
    T_cw = se3.se3_exp(torch.tensor(PAIR_TWIST, dtype=torch.float32) * 0.5).numpy()
    return dict(coords=coords, depth=depth.astype(np.float32), rgb=rgb, T_cw=T_cw,
                voxel_size=0.05, truncation=0.25)


def ring_posegraph(n: int = 24) -> dict:
    """The ring of `tests/test_parallel.py` (n poses, a closure at n / 2 and
    one at n - 4), 32 exact correspondences an edge, noisy initial poses;
    host arrays."""
    rng = np.random.default_rng(7)
    c = 32
    pts = rng.uniform(-1, 1, (c, 3)).astype(np.float32)
    pairs = [(i, (i + 1) % n) for i in range(n)] + [(0, n // 2), (3, n - 4)]
    gt = se3.se3_exp(torch.from_numpy(rng.normal(0, 0.1, (n, 6)).astype(np.float32))).numpy()
    gt[0] = np.eye(4)
    hom = np.c_[pts, np.ones(c)].T
    src = np.array([i for i, _ in pairs])
    dst = np.array([j for _, j in pairs])
    p_src = np.stack([(np.linalg.inv(gt[i]) @ hom).T[:, :3] for i in src]).astype(np.float32)
    p_dst = np.stack([(np.linalg.inv(gt[j]) @ hom).T[:, :3] for j in dst]).astype(np.float32)
    noise = rng.normal(0, 0.03, (n, 6)).astype(np.float32)
    noise[0] = 0
    init = np.einsum("nij,njk->nik", se3.se3_exp(torch.from_numpy(noise)).numpy(), gt).astype(np.float32)
    return dict(poses=init, gt=gt, src=src, dst=dst, p_src=p_src, p_dst=p_dst,
                valid=np.ones(p_src.shape[:2], bool), edge_valid=np.ones(len(pairs), bool), iters=5)


# ---------------------------------------------------------------------------
# the modules, on one rank
# ---------------------------------------------------------------------------


def _psum(group: ShardGroup, inp: dict, keep_arrays: bool, state: dict) -> dict:
    return dict(value=group.psum(torch.tensor([group.rank + 1.0], device=group.device)))


def _dense(group: ShardGroup, inp: dict, keep_arrays: bool, state: dict) -> dict:
    cam, dev = inp["camera"], group.device
    d = inp["dense"]
    src = dense.preprocess_frame(_t(d["src_gray"], dev), _t(d["src_depth"], dev), cam)
    tgt = dense.preprocess_frame(_t(d["tgt_gray"], dev), _t(d["tgt_depth"], dev), cam)
    res = pdense.dense_tracking_sharded(group, src, tgt, cam)
    return dict(T=res.T_ts, cost=res.cost, inliers=res.num_inliers, rmse=res.rmse)


def _tsdf(group: ShardGroup, inp: dict, keep_arrays: bool, state: dict) -> dict:
    cam, dev = inp["camera"], group.device
    d = inp["tsdf"]
    b = len(d["coords"])
    rows = group.shard_rows
    sdf = rows(torch.full((b, 512), tsdf_ops.EMPTY_SDF, device=dev))
    out = ptsdf.integrate_blocks_sharded(
        group, sdf, torch.zeros_like(sdf), rows(torch.zeros((b, 512, 3), device=dev)),
        rows(_t(d["coords"], dev)), rows(torch.ones(b, dtype=torch.bool, device=dev)),
        _t(d["depth"], dev), _t(d["rgb"], dev), _t(d["T_cw"], dev),
        cam.fx, cam.fy, cam.cx, cam.cy, d["voxel_size"], d["truncation"])
    full = [group.all_gather(x).flatten(0, 1)[:b] for x in out]
    res = dict(digest=digest(torch.cat([full[0], full[1], full[2].flatten(1)], 1)),
               updated=int((full[1] > 0).sum()))
    if keep_arrays:
        res.update(sdf=full[0], weight=full[1], color=full[2])
    return res


def _fused(group: ShardGroup, inp: dict, keep_arrays: bool, state: dict) -> dict:
    cam, dev = inp["camera"], group.device
    f = inp["fused"]
    cap_local = f["capacity"] // group.world
    vox = pfused.make_sharded_pool(group, cap_local)
    table = dh.make_table(f["table_size"], cap_local * group.world, dev)
    kmax, saturated = f["kmax"], 0
    for i in range(len(f["depths"])):
        out = pfused.fused_tsdf_step_sharded(
            group, vox, table, _t(f["depths"][i], dev), _t(f["grays"][i], dev), _t(f["poses"][i], dev),
            cam.fx, cam.fy, cam.cx, cam.cy, f["voxel_size"], f["truncation"], kmax=kmax, stride=f["stride"],
            claim_rounds=f["claim_rounds"][min(i, 1)])
        table, kmax, saturated = out.table, out.kmax, saturated + out.saturated
    pool = pfused.gather_pool(group, vox)[:-1]  # the trash rows hold garbage by design
    state.update(vox=vox, table=table)
    res = dict(pool_digest=digest(pool), table_digest=digest(torch.cat([t.reshape(-1) for t in table])),
               num_active=int(table.num_active), overflow=int(table.overflow), kmax=kmax,
               key_saturated_frames=saturated)
    if keep_arrays:
        res.update(pool=pool, table=table)
    return res


def _mesh(group: ShardGroup, vox, table, voxel_size: float):
    v, c = pmc.extract_mesh_sharded(group, vox, table, voxel_size)
    return pmc.gather_triangles(group, v, c)


def _blocks_here(group: ShardGroup, table, cap_local: int) -> int:
    gslots = group.rank * cap_local + torch.arange(cap_local, dtype=torch.int32, device=group.device)
    return int(pmc._active_mask(table, gslots).sum())


def _mc(group: ShardGroup, inp: dict, keep_arrays: bool, state: dict) -> dict:
    """Meshing and migration of the `fused` module's pool, or of the pool and
    table given as `inp["mc"]` (pool (cap_total, 5, 512), table fields)."""
    if "mc" in inp:
        m = inp["mc"]
        cap_l = len(m["pool"]) // group.world
        rows = torch.as_tensor(m["pool"][group.rank * cap_l : (group.rank + 1) * cap_l])
        vox = torch.cat([rows, torch.zeros((1,) + rows.shape[1:])]).to(group.device)
        table = dh.BlockHashTable(*(_t(a, group.device) for a in m["table"]))
        voxel = m["voxel_size"]
    else:
        vox, table, voxel = state["vox"], state["table"], inp["fused"]["voxel_size"]
    verts, colors = _mesh(group, vox, table, voxel)
    tri = torch.stack([verts, colors], 1).cpu().numpy()
    vox2, table2 = pmc.reshard_blocks(group, vox, table)
    verts2, colors2 = _mesh(group, vox2, table2, voxel)
    tri2 = torch.stack([verts2, colors2], 1).cpu().numpy()
    res = dict(triangles=len(tri), digest=digest(tri), sorted_digest=digest(sorted_rows(tri)),
               triangles_after=len(tri2), sorted_digest_after=digest(sorted_rows(tri2)),
               num_active_after=int(table2.num_active), overflow_after=int(table2.overflow),
               blocks_here=_blocks_here(group, table, vox2.shape[0] - 1),
               blocks_here_after=_blocks_here(group, table2, vox2.shape[0] - 1))
    if keep_arrays:
        res.update(tri=tri, tri_after=tri2)
    return res


def _ba(group: ShardGroup, inp: dict, keep_arrays: bool, state: dict) -> dict:
    dev = group.device
    b = inp["ba"]
    p = len(b["points"])
    rows = group.shard_rows
    new_poses, new_pts, cost = pba.distributed_ba_step(
        group, _t(b["poses"], dev), rows(_t(b["points"], dev)), rows(_t(b["frame_pp"], dev)),
        rows(_t(b["uv_pp"], dev)), rows(_t(b["mask_pp"], dev)), b["lam"], *b["intr"])
    return dict(poses=new_poses, points=group.all_gather(new_pts).flatten(0, 1)[:p], cost=cost)


def _posegraph(group: ShardGroup, inp: dict, keep_arrays: bool, state: dict) -> dict:
    dev = group.device
    g = inp["posegraph"]
    edges = PoseGraphEdges(*(_t(g[k], dev) for k in ("src", "dst", "p_src", "p_dst", "valid", "edge_valid")))
    poses, cost = ppg.optimize_pose_graph_sharded(group, _t(g["poses"], dev), ppg.shard_edges(group, edges),
                                                  iters=g["iters"])
    return dict(poses=poses, cost=cost)


_MODULE_FNS = dict(psum=_psum, dense=_dense, tsdf=_tsdf, fused=_fused, mc=_mc, ba=_ba, posegraph=_posegraph)


def run_modules(group: ShardGroup, inp: dict, modules=MODULES, keep_arrays: bool = True) -> dict:
    """Each module in `modules` on this rank (`mc` needs `fused` before it).
    Returns {module: {results..., seconds, comm, launches}}."""
    out, state = {}, {}
    for name in modules:
        group.reset_stats()
        _build.reset_launch_counts()
        _sync(group.device)
        t = time.perf_counter()
        if name not in _MODULE_FNS:
            raise ValueError(f"unknown module {name!r}: expected one of {MODULES}")
        res = _MODULE_FNS[name](group, inp, keep_arrays, state)
        _sync(group.device)
        res.update(seconds=time.perf_counter() - t, comm=group.stats(), launches=_launches())
        out[name] = res
    return out


def run_submap(group: ShardGroup, inp: dict) -> dict:
    """The submap pipeline, one submap per rank, on `inp["grays"]` /
    `inp["depths"]` (S, F, H, W) (arrays, or paths of .npy files a rank
    maps and reads its part of)."""
    load = (lambda x: np.load(x, mmap_mode="r")) if isinstance(inp["grays"], str) else (lambda x: x)
    grays, depths = load(inp["grays"]), load(inp["depths"])
    group.reset_stats()
    _build.reset_launch_counts()
    _sync(group.device)
    t = time.perf_counter()
    res = psubmap.submap_pipeline_sharded(group, grays, depths, inp["camera"], **inp.get("kwargs", {}))
    _sync(group.device)
    return dict(out=res._asdict(), seconds=time.perf_counter() - t, comm=group.stats(), launches=_launches())


def run_worlds(group: ShardGroup, inp: dict, worlds: tuple[int, ...], submap_inp: dict | None = None,
               submap_world: int = 0) -> dict:
    """`run_modules` at each world in `worlds` (over the subgroup of the
    first ranks), then the submap pipeline over `submap_world` ranks, in one
    set of processes: {"modules": {world: its result}, "submap": its
    result}, for what this rank took part in."""
    out = {"modules": {}}
    for world in worlds:
        sub = group.subgroup(world)
        if sub is not None:
            out["modules"][world] = run_modules(sub, inp, keep_arrays=False)
    if submap_inp is not None:
        sub = group.subgroup(submap_world)
        if sub is not None:
            out["submap"] = run_submap(sub, submap_inp)
    return out


def launch_check(group: ShardGroup, camera: PinholeCamera, pair: dict, tol: float) -> dict:
    """`tools/torch_launch_distributed.py`'s worker: a psum of 1..world, then
    pixel-sharded tracking of the pair against this rank's own single-rank
    exact track (`odometry/dense.dense_tracking`)."""
    dev = group.device
    total = float(group.psum(torch.tensor([group.rank + 1.0], device=dev))[0])
    want = group.world * (group.world + 1) / 2
    if total != want:
        raise AssertionError(f"rank {group.rank}: psum {total} != {want}")
    src = dense.preprocess_frame(_t(pair["src_gray"], dev), _t(pair["src_depth"], dev), camera)
    tgt = dense.preprocess_frame(_t(pair["tgt_gray"], dev), _t(pair["tgt_depth"], dev), camera)
    sharded = pdense.dense_tracking_sharded(group, src, tgt, camera).T_ts
    err = float((sharded - dense.dense_tracking(src, tgt, camera).T_ts).abs().max())
    if not err < tol:
        raise AssertionError(f"rank {group.rank}: sharded-vs-exact pose mismatch {err} >= {tol}")
    return dict(rank=group.rank, psum=total, max_dT=err)
