"""DenseFusion on the port against the benchmark's plain reference, on the CPU.

`portbench/systems/dense_slam.py` drives `DenseSlam` frame by frame and
ends with the post-hoc reconstruction (`dense_slam.reconstruct`);
`portbench/reference/dense_slam.py` judges each stage from the program's
own state. Here at 80x60: 16 frames of the 12-frame closed loop from its
first frame, submaps of 4 and a 0.1 m submap voxel, so that submap 3
sees submap 0's views again and one loop edge (3 -> 0) is made. The
system reads 0 on every number; each planted fault and the bfloat16
control read `correct` false under the committed limits. Also: the spans
and counters of a scan against its submaps and registrations, the
traced run's registration metrics, the configuration against the
program's defaults, and the CLI's post-hoc mesh against the fusion it
replaced. Needs no JAX."""

from __future__ import annotations

import json
import os
import runpy
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from onepiece_tpu_torch.geometry.camera import PinholeCamera
from onepiece_tpu_torch.integration.blocks import TSDFVolume
from onepiece_tpu_torch.io.ply import read_ply, write_ply_mesh
from onepiece_tpu_torch.ops.image import bilateral_filter
from onepiece_tpu_torch.ops.mesh_dedup import dedup_triangle_soup
from onepiece_tpu_torch.optimization import posegraph
from onepiece_tpu_torch.registration import global_reg, icp
from onepiece_tpu_torch.systems import dense_slam as ds
from onepiece_tpu_torch.utils import tracing
from portbench import metrics, run, trace
from portbench.reference import dense_slam as judge
from portbench.systems import dense_slam as system
from portbench.traffic import closed_scans

REPO = Path(__file__).resolve().parents[1]
CAMERA = dict(fx=517.3 / 8, fy=516.5 / 8, cx=(318.6 + 0.5) / 8 - 0.5, cy=(255.3 + 0.5) / 8 - 0.5,
              width=80, height=60)
SMALL = dict(submap_size=4, voxel_size=0.1)
MIX = dict(loop_frames=12, scan_frames=16, chunk=4, render_steps=32, render_batch=6, judged_scans=1)
SEED = 2**31 + 7
LIMITS = json.loads((REPO / "portbench/reference/limits/tum_densefusion.json").read_text())["limits"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cell():
    _, cfg, mix = run.load_cell("densefusion.lap300")
    return {**cfg, **SMALL, "camera": {**cfg["camera"], **CAMERA}}, {**mix, **MIX}


@pytest.fixture(scope="module")
def frames():
    cfg, mix = _cell()
    torch.set_num_threads(1)
    return cfg, mix, closed_scans.make_frames(cfg, mix, SEED, torch.device("cpu")).scan(0, mix["scan_frames"])


def _scan(cfg, mix, g, d, c):
    scan = system.Scan(cfg, torch.device("cpu"))
    for i in range(0, mix["scan_frames"], mix["chunk"]):
        scan.feed(g[i : i + mix["chunk"]], d[i : i + mix["chunk"]], c[i : i + mix["chunk"]])
    return scan.finish()


def _verdict(out, cfg, mix, g, d, c):
    readings = judge.judge(out, g, d, c, {**cfg, **mix})
    return run.checks(readings, LIMITS)[0], readings


@pytest.fixture(scope="module")
def program(frames):
    cfg, mix, (g, d, c) = frames
    out = _scan(cfg, mix, g, d, c)
    return out, judge.judge(out, g, d, c, {**cfg, **mix})


def test_system_reads_zero_against_the_plain_reference(frames, program):
    out, readings = program
    assert readings == dict.fromkeys(judge.STAGES, 0.0), readings
    made = [(e["src"], e["dst"]) for e in out.edges]
    assert (1, 0) in made and (3, 0) in made, made  # an ICP edge and the loop edge
    assert len(out.solves) == 3 and all(n for _, n, _ in out.solves)
    assert out.coords.shape[0] > 300 and out.faces.shape[0] > 10_000


FAULTS = ["global registration skipped", "pose graph skipped", "an edge's T moved by 1 cm",
          "post-hoc fusion at the odometry poses", "half a chunk dropped", "normals flipped"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_is_incorrect(fault, frames, monkeypatch):
    cfg, mix, (g, d, c) = frames
    if fault == "global registration skipped":
        monkeypatch.setattr(global_reg, "register", lambda src, tgt, params: SimpleNamespace(
            T=torch.eye(4), num_inliers=torch.tensor(0), success=torch.tensor(False)))
    elif fault == "pose graph skipped":
        monkeypatch.setattr(posegraph, "optimize_pose_graph", lambda poses, edges, iters: (poses, None))
    elif fault == "an edge's T moved by 1 cm":
        add = ds.DenseSlam._add_edge

        def moved(self, src, dst, T, cloud):
            if not self.edges:
                T = T.copy()
                T[0, 3] += 0.01
            return add(self, src, dst, T, cloud)

        monkeypatch.setattr(ds.DenseSlam, "_add_edge", moved)
    elif fault == "post-hoc fusion at the odometry poses":
        finish = system.Scan.finish

        def at_odometry(self):
            out = finish(self)
            odo = np.stack([np.eye(4, dtype=np.float32)])
            for T_ts in out.motions[1:].numpy():
                odo = np.concatenate([odo, (odo[-1] @ np.linalg.inv(T_ts))[None]])
            vol, mesh = ds.reconstruct(odo, self.kept, self.cam, self.cfg["posthoc_voxel"], "cpu")
            coords = torch.from_numpy(vol.block_coords[: vol.num_active]).to(torch.int32)
            return out._replace(vox=vol.vox, coords=coords, verts=mesh[0], faces=mesh[1], colors=mesh[2])

        monkeypatch.setattr(system.Scan, "finish", at_odometry)
    elif fault == "half a chunk dropped":
        feed = system.Scan.feed
        fed = []

        def half(self, grays, depths, rgbs):
            keep = grays.shape[0] // 2 if len(fed) == 1 else grays.shape[0]
            fed.append(keep)
            return feed(self, grays[:keep], depths[:keep], rgbs[:keep])

        monkeypatch.setattr(system.Scan, "feed", half)
    elif fault == "normals flipped":
        extract = global_reg.extract_features

        def flipped(cloud, params):
            f = extract(cloud, params)
            return f._replace(normals=-f.normals)

        monkeypatch.setattr(global_reg, "extract_features", flipped)
    out = _scan(cfg, mix, g, d, c)
    correct, readings = _verdict(out, cfg, mix, g, d, c)
    assert not correct, readings


def test_bfloat16_control_is_incorrect(frames):
    cfg, mix, (g, d, c) = frames
    out = judge.control_scan(g, d, c, {**cfg, **mix})
    correct, readings = _verdict(out, cfg, mix, g, d, c)
    assert not correct, readings
    assert readings["normal_gap"] > LIMITS["normal_gap"] and readings["fpfh_gap"] > LIMITS["fpfh_gap"], readings
    assert readings["submap_pose_gap_m"] > 0.0 and readings["edge_gap_m"] > 0.0, readings


def test_stages_open_as_often_as_the_scan_registers(frames):
    cfg, mix, (g, d, c) = frames
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = _scan(cfg, mix, g, d, c)
    spans, counts = tracing.spans(), tracing.counters()
    tracing.clear()
    by = {}
    for s in spans:
        by[s.name] = by.get(s.name, 0) + 1
    n, size = mix["scan_frames"], cfg["submap_size"]
    submaps = n // size
    registrations = sum(k - 1 for k in range(1, submaps))
    loops = sum(e["src"] - e["dst"] > 1 for e in out.edges)
    refined = by.get("registration.refine", 0)
    assert refined >= loops == 1
    want = {"loop.frame": n, "registration.cloud": submaps * len(range(0, size, cfg["cloud_stride"])),
            "registration.merge": submaps, "registration.downsample": submaps, "registration.features": submaps,
            "registration.normals": submaps, "registration.fpfh": submaps, "registration.icp": submaps - 1,
            "registration.global": registrations, "registration.match": registrations,
            "registration.ransapc": registrations, "registration.pose_graph": submaps - 1,
            "registration.reanchor": submaps - 1, "reconstruct.posthoc": 1,
            "reconstruct.integrate": len(range(0, n, cfg["posthoc_stride"]))}
    assert {k: by.get(k, 0) for k in want} == want
    assert counts["registration.global"] == registrations and counts["registration.loop_edge"] == loops
    assert counts["icp.iter"] == cfg["icp_iters"] * (submaps - 1 + refined)
    # every sync site counted as often as its span was passed, n each
    synced = {}
    for s in spans:
        if s.name.startswith("sync."):
            synced[s.name] = synced.get(s.name, 0) + s.attrs["n"]
    assert synced == {k: v for k, v in counts.items() if k.startswith("sync.")}
    assert synced["sync.frame_pose"] == n - 1 and synced["sync.global_success"] == registrations
    # each registration stage inside its submap's last frame
    for s in spans:
        if s.name.startswith("registration.") and s.name != "registration.cloud":
            p = s
            while p.name != "loop.frame":
                p = spans[p.parent]
            assert (p.attrs["frame"] + 1) % size == 0


class _AsDevice:
    """A host event read as a device operation (a CPU profile has none)."""

    def __init__(self, e):
        self.e = e

    def __getattr__(self, name):
        return getattr(self.e, name)

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False


def test_traced_run_reads_the_registration_metrics(frames, monkeypatch):
    cfg, mix, _ = frames
    real = trace.summarize

    def summarize(prof, traced):
        events = [_AsDevice(e) if e.name() == "aten::copy_" else e for e in prof.profiler.kineto_results.events()]
        return real(SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events))),
                    traced)

    monkeypatch.setattr(trace, "summarize", summarize)
    tracing.clear()
    rec = closed_scans.run(cfg, {**mix, "trace_scan": 1}, SEED, 0.1, True, device="cpu")
    ctx = metrics.Context(rec, cfg, mix)
    readers = metrics.load_all()
    got = {k: readers[k].read(ctx) for k in ("registration_self_ms", "registration_syncs_per_frame",
                                              "reconstruction_ms")}
    tracing.clear()
    assert all(v is not None and v > 0 for v in got.values()), got
    assert rec["readings"] == dict.fromkeys(judge.STAGES, 0.0)
    # the work of the traced scan's ICP calls and registrations, counted
    assert set(rec["work"]) == {"nn1", "ransac_rigid"}
    assert rec["work"]["nn1"]["ops"] > 0 and rec["work"]["ransac_rigid"]["ops"] > 0


def test_configuration_is_the_programs_default():
    cfg, _ = run.load_cell("densefusion.lap300")[1:]
    slam = ds.DenseSlam(PinholeCamera(**{k: v for k, v in cfg["camera"].items()}), "cpu")
    params = global_reg.RansacParams(voxel_size=slam.voxel_size)
    assert (cfg["submap_size"], cfg["voxel_size"], cfg["icp_threshold"]) == (
        slam.submap_size, slam.voxel_size, slam.icp_threshold)
    assert (cfg["cloud_stride"], cfg["icp_iters"], cfg["posthoc_stride"], cfg["posthoc_voxel"],
            cfg["posthoc_truncation_voxels"]) == (ds.CLOUD_STRIDE, icp.DEFAULT_ITERS, ds.POSTHOC_STRIDE,
                                                  ds.POSTHOC_VOXEL, ds.TRUNCATION_VOXELS)
    assert (cfg["normal_k"], cfg["fpfh_radius"], cfg["fpfh_k"], cfg["ransac_threshold"], cfg["num_hypotheses"],
            cfg["sample_size"], cfg["ransapc_rounds"]) == (
        params.normal_k, params.fpfh_radius, params.fpfh_k, params.threshold, params.num_hypotheses,
        params.sample_size, params.ransapc_rounds)
    assert cfg["max_weight"] == TSDFVolume(device="cpu", capacity=1).max_weight
    assert cfg["iters"] == [16, 8, 4] and cfg["scan_frames"] == 300


def _old_fuse(poses, kept, cam, voxel, device):
    """The CLI's post-hoc fusion as it was before `dense_slam.reconstruct`."""
    vol = TSDFVolume(voxel_size=voxel, truncation=voxel * 5, device=device)
    for f, gray, depth in kept:
        gray = torch.as_tensor(gray, dtype=torch.float32).to(device)
        depth = torch.as_tensor(depth, dtype=torch.float32).to(device)
        vol.integrate(bilateral_filter(depth), gray[..., None].expand(-1, -1, 3), poses[f], cam)
    return vol


def test_cli_mesh_is_the_fusion_it_replaced(tmp_path, monkeypatch):
    """`tools/torch_dense_fusion.py --synthetic 4 --scale 8 --device cpu`:
    its trajectory and PLY bit-equal to DenseSlam's poses and the old fuse
    then mesh, written by the same writers."""
    tools = str(REPO / "tools")
    monkeypatch.syspath_prepend(tools)
    monkeypatch.chdir(tmp_path)
    argv = ["torch_dense_fusion.py", "--synthetic", "4", "--scale", "8", "--device", "cpu",
            "--out-mesh", "new.ply", "--out-traj", "new.txt"]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_path(os.path.join(tools, "torch_dense_fusion.py"), run_name="__main__")

    from _torch_common import keeping, load_frames

    from onepiece_tpu_torch.io import trajectory as traj

    args = SimpleNamespace(synthetic=4, max_frames=None, scale=8, camera="tum", device="cpu", dataset=None)
    frames, cam, _ = load_frames(args)
    slam, kept = ds.DenseSlam(cam, "cpu", submap_size=50), []
    for _, gray, depth in keeping(frames, 0, 8, kept):
        slam.update_frame(gray, depth)
    poses = slam.trajectory()
    traj.write_matrix_trajectory("old.txt", poses)
    v, f, c = (x.numpy() for x in dedup_triangle_soup(*_old_fuse(poses, kept, cam, 0.02, "cpu").extract_mesh_tensors()))
    write_ply_mesh("old.ply", v, f, colors=c)
    assert (tmp_path / "new.txt").read_bytes() == (tmp_path / "old.txt").read_bytes()
    assert (tmp_path / "new.ply").read_bytes() == (tmp_path / "old.ply").read_bytes()
    assert len(read_ply("new.ply")["faces"]) > 1000
